// y = bf16(x) . W8 * s: int8 per-out-channel weights, f32 accumulate.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::matmul_q8w (:368-407, body
// _matmul_q8w_kernel :352-365), which the JAX package reaches through
// models/layers.py::linear_q8 from whisper.decoder_step and _cross_with_kv.
// Same function: x rounded to bf16, each int8 weight converted exactly,
// products summed in f32, the per-column scale applied to the sum.
//
// Bound on this card: bytes. Decode runs it at B = 1..16 rows, so it does
// 2*B flops per weight byte read, far below the ~295 flops/byte where the
// tensor cores would become the limit: the time is the int8 weight read.
// Design: keep many independent weight loads in flight. A block owns a
// strip of 256 output columns and a slice of din; each of its 256 threads
// owns 4 adjacent columns (one 4-byte load per weight row; a warp reads 128
// contiguous bytes of a row) and every 4th row of the slice, and issues 8
// row loads before it uses any of them. The block's x rows (up to 16,
// rounded to bf16 as the function requires) sit in shared memory and are
// read as broadcasts; each thread keeps 16 x 4 f32 sums in registers, so
// every weight byte feeds 16 FMAs. The four row groups are summed through
// shared memory in a fixed order. When the strips alone cannot fill the
// card, din is split across blocks too; the partial sums go to a scratch
// buffer and a second small kernel adds them in a fixed order and applies
// the scale (deterministic, no atomics). No B-padding and no 128-multiple
// constraint: ragged rows, columns and din are masked.
#include "common.cuh"

namespace {

constexpr int kCols = 256;      // output columns per block
constexpr int kThreads = 256;   // 64 column quads x 4 row groups
constexpr int kGroups = 4;      // row groups (interleaved rows of the slice)
constexpr int kRows = 16;       // x rows per block
constexpr int kUnroll = 8;      // weight rows in flight per thread
constexpr int kKMax = 1280;     // din rows per block (x slice in shared memory)

template <typename TX, bool VEC>
__global__ void __launch_bounds__(kThreads)
q8w_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ out,
           float* __restrict__ partial, int B, int din, int dout,
           int k_per_split) {
  // x slice as bf16 during the main loop; reused for the row-group sums
  __shared__ __align__(16) unsigned char smem[kRows * kKMax * 2];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float4* red = reinterpret_cast<float4*>(smem);  // [kRows][kCols / 4]

  const int n0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int k_begin = split * k_per_split;
  const int klen = min(din, k_begin + k_per_split) - k_begin;
  const int tid = threadIdx.x, quad = tid & 63, grp = tid >> 6;
  const int col = n0 + quad * 4;

  for (int i = tid; i < kRows * klen; i += kThreads) {
    const int r = i / klen, kk = i - r * klen;
    const int row = row0 + r;
    const float xv = row < B ? arp::to_f32(x[(size_t)row * din + k_begin + kk])
                             : 0.f;
    x_s[r * kKMax + kk] = __float2bfloat16(xv);
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  const int8_t* wp = w + (size_t)k_begin * dout + col;
  for (int kl = grp; kl < klen; kl += kGroups * kUnroll) {
    uint32_t wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = kl + u * kGroups;
      wv[u] = 0u;
      if (r < klen) {
        const int8_t* p = wp + (size_t)r * dout;
        if (VEC) {
          if (col < dout) wv[u] = __ldg(reinterpret_cast<const unsigned*>(p));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < dout)
              wv[u] |= (uint32_t)(uint8_t)__ldg(p + j) << (8 * j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = kl + u * kGroups;
      if (r >= klen) break;
      const float w0 = arp::s8(wv[u], 0), w1 = arp::s8(wv[u], 1);
      const float w2 = arp::s8(wv[u], 2), w3 = arp::s8(wv[u], 3);
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const float xv = __bfloat162float(x_s[b * kKMax + r]);
        acc[b][0] = fmaf(xv, w0, acc[b][0]);
        acc[b][1] = fmaf(xv, w1, acc[b][1]);
        acc[b][2] = fmaf(xv, w2, acc[b][2]);
        acc[b][3] = fmaf(xv, w3, acc[b][3]);
      }
    }
  }

  // sum the row groups in order 0, 1, 2, 3; group 3 holds the total
  __syncthreads();  // x_s is dead; its bytes become red
#pragma unroll
  for (int g = 0; g < kGroups - 1; ++g) {
    if (grp == g) {
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        float4 t = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
        if (g > 0) {
          const float4 p = red[b * (kCols / 4) + quad];
          t = make_float4(p.x + t.x, p.y + t.y, p.z + t.z, p.w + t.w);
        }
        red[b * (kCols / 4) + quad] = t;
      }
    }
    __syncthreads();
  }
  if (grp != kGroups - 1) return;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const int row = row0 + b;
    if (row >= B) break;
    const float4 p = red[b * (kCols / 4) + quad];
    const float tot[4] = {p.x + acc[b][0], p.y + acc[b][1], p.z + acc[b][2],
                          p.w + acc[b][3]};
    if (VEC) {
      if (col >= dout) continue;
      if (partial != nullptr) {
        *reinterpret_cast<float4*>(partial + ((size_t)split * B + row) * dout
                                   + col) =
            make_float4(tot[0], tot[1], tot[2], tot[3]);
      } else {
        const float4 sc = *reinterpret_cast<const float4*>(s + col);
        *reinterpret_cast<float4*>(out + (size_t)row * dout + col) =
            make_float4(tot[0] * sc.x, tot[1] * sc.y, tot[2] * sc.z,
                        tot[3] * sc.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j >= dout) break;
        if (partial != nullptr)
          partial[((size_t)split * B + row) * dout + col + j] = tot[j];
        else
          out[(size_t)row * dout + col + j] = tot[j] * s[col + j];
      }
    }
  }
}

__global__ void q8w_reduce(const float* __restrict__ partial,
                           const float* __restrict__ s,
                           float* __restrict__ out, int splits, int B,
                           int dout) {
  const size_t n = (size_t)B * dout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * n + i];
  out[i] = acc * s[i % dout];
}

template <typename TX>
cudaError_t launch(const void* x, const int8_t* w, const float* s,
                   float* out, float* scratch, int B, int din, int dout,
                   int splits, int k_per_split, bool vec,
                   cudaStream_t stream) {
  dim3 grid((dout + kCols - 1) / kCols, splits, (B + kRows - 1) / kRows);
  float* partial = splits > 1 ? scratch : nullptr;
  const TX* xp = static_cast<const TX*>(x);
  if (vec)
    q8w_kernel<TX, true><<<grid, kThreads, 0, stream>>>(
        xp, w, s, out, partial, B, din, dout, k_per_split);
  else
    q8w_kernel<TX, false><<<grid, kThreads, 0, stream>>>(
        xp, w, s, out, partial, B, din, dout, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)B * dout;
  q8w_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      scratch, s, out, splits, B, dout);
  return cudaGetLastError();
}

}  // namespace

// x (B, din) f32/bf16 row-major; w (din, dout) int8 row-major; s (dout,) f32;
// out (B, dout) f32; scratch (splits, B, dout) f32 when splits > 1.
// Split sp covers din rows [sp*k_per_split, (sp+1)*k_per_split), at most
// 1280 rows. vec: dout % 4 == 0 and w, s, out, scratch 16-byte aligned.
extern "C" int matmul_q8w_launch(const void* x, const void* w, const void* s,
                                 void* out, void* scratch, int B, int din,
                                 int dout, int splits, int k_per_split,
                                 int vec, int x_dtype, void* stream) {
  if (B < 1 || din < 1 || dout < 1 || splits < 1 || k_per_split < 1 ||
      k_per_split > kKMax || (long long)splits * k_per_split < din ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (x_dtype == arp::kF32)
    err = launch<float>(x, wp, sp, op, scr, B, din, dout, splits,
                        k_per_split, vec != 0, st);
  else if (x_dtype == arp::kBF16)
    err = launch<__nv_bfloat16>(x, wp, sp, op, scr, B, din, dout, splits,
                                k_per_split, vec != 0, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
