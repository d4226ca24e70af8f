// y = bf16(x) . dequant(W4): int4 weights with group-wise scales, f32 sums.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::matmul_q4w (:481-542, body
// _matmul_q4w_kernel :448-477, format helpers q4_tiles/q4_group :410-445),
// which the JAX package reaches through models/layers.py::linear_q8 for
// {"w4", "s"} weights (decoder_int4: every decode-loop matmul; lm_head_int4:
// the vocab projection). Same function as the JAX package's off-TPU path:
// x rounded to bf16; weight = int4 value * (group scale rounded to bf16),
// the product exact in f32; x * weight summed in f32. Format: byte row r of
// w4 (din/2, dout) holds din row 2r in its low nibble and 2r+1 in its high
// nibble; s (din/group, dout) holds one f32 scale per group of din rows and
// column. The TPU kernel's tile rules (q4_tiles) do not bind this kernel: any
// group that divides din, any B, ragged dout.
//
// Bound on this card: bytes. Decode runs it at B = 16..80 rows, 4*B flops
// per packed weight byte, far below the ~295 flops/byte where the tensor
// cores would become the limit.
// Design (wq_matmul.cuh): mma.sync m16n8k16 with the weight as the M side
// and the x rows as N, each packed byte one bf16x2 A register without a
// transpose; every x row in one block, so the weight is read once per call;
// a cp.async ring; split-K reduced in a cluster, in the same launch, in a
// fixed order.
// q * bf16(s) has up to 11 significant bits and does not fit a bf16 operand
// (the TPU's own body rounds it; this kernel does not), so the products stay
// exact one of two ways:
// * group a multiple of 16 (every large-v3 shape: 80 at din 1280, 128 at
//   5120): no 16-row chunk spans two groups, so the mma runs on the int4
//   values themselves, exact in bf16, and each chunk's f32 sums are added
//   times the bf16-rounded group scale, loaded once per group and lane
//   (kInt4Group). Scaling every chunk, not every group, keeps one sum set
//   in registers, so 80 x rows still fit two blocks on an SM;
// * any other group: each weight is dequantized to q * bf16(s) in f32 and
//   split into bf16 hi + lo, both exact, and each feeds its own mma
//   (kInt4Split). This keeps one fragment layout and one x operand for
//   both paths, where a TF32 product would need its own.
#include "wq_matmul.cuh"

// x (B, din) f32/bf16 row-major; w (din/2, dout) int8 row-pair packed;
// s (din/group, dout) f32; out (B, dout) f32. group_mode 1 picks kInt4Group
// (group % 16 == 0). The plan is ops/kernels.py::wq_plan's.
extern "C" int matmul_q4w_launch(const void* x, const void* w, const void* s,
                                 void* out, int B, int din, int dout, int group,
                                 int group_mode, int nt, int wn, int wk,
                                 int splits, int k_per_split, int stages,
                                 int x_dtype, void* stream) {
  using namespace arp::wq;
  if ((x_dtype != arp::kF32 && x_dtype != arp::kBF16) || din % 2 != 0 ||
      group < 1 || din % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(s);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.din = din;
  a.dout = dout;
  a.group = group;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.stages = stages;
  a.wn = wn;
  a.wk = wk;
  a.x_bf16 = x_dtype == arp::kBF16;
  const Mode mode = group_mode ? kInt4Group : kInt4Split;
  if (!prepare(a, mode, nt))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(group_mode ? dispatch<kInt4Group>(a, nt, st)
                                     : dispatch<kInt4Split>(a, nt, st));
}
