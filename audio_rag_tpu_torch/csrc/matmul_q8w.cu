// y = bf16(x) . W8 * s: int8 per-out-channel weights, f32 sums.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::matmul_q8w (:368-407, body
// _matmul_q8w_kernel :352-365), which the JAX package reaches through
// models/layers.py::linear_q8 from whisper.decoder_step and _cross_with_kv.
// Same function: x rounded to bf16, each int8 weight converted exactly,
// products summed in f32, the per-column scale applied to the sum. int8
// values are exact in bf16, so a bf16 tensor-core product with f32 sums
// computes it; only the order of the sums differs.
//
// Bound on this card: bytes. Decode runs it at B = 1..80 rows, 2*B flops per
// weight byte, far below the ~295 flops/byte where the tensor cores would
// become the limit: the time is the int8 weight read, and for the small
// blocks of a decode step (1.6 MB at 1280 x 1280) the launch and the first
// bytes' latency.
// Design (wq_matmul.cuh): mma.sync m16n8k16 with the weight as the M side
// and the x rows as N; one block holds every x row, so the weight is read
// once per call; a cp.async ring of weight tiles and x slices; din split
// across the blocks of a cluster when the columns cannot fill the card,
// reduced through distributed shared memory in the same launch, in a fixed
// order. The scale is applied to the finished sum.
#include "wq_matmul.cuh"

// x (B, din) f32/bf16 row-major; w (din, dout) int8 row-major; s (dout,)
// f32; out (B, dout) f32. The plan (nt, wn, wk, splits, k_per_split,
// stages) is ops/kernels.py::wq_plan's.
extern "C" int matmul_q8w_launch(const void* x, const void* w, const void* s,
                                 void* out, int B, int din, int dout, int nt,
                                 int wn, int wk, int splits, int k_per_split,
                                 int stages, int x_dtype, void* stream) {
  using namespace arp::wq;
  if (x_dtype != arp::kF32 && x_dtype != arp::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.din = din;
  a.dout = dout;
  a.group = 1;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.stages = stages;
  a.wn = wn;
  a.wk = wk;
  a.x_bf16 = x_dtype == arp::kBF16;
  if (!prepare(a, kInt8, nt))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<kInt8>(a, nt, static_cast<cudaStream_t>(stream)));
}
