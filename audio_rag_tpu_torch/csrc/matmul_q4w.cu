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
// Bound on this card: bytes. Decode runs it at B = 16..32 rows, so it does
// 4*B flops per nibble byte read (x2 weights per byte), far below the ~295
// flops/byte where the tensor cores would become the limit. Design: the
// int8 kernel's (matmul_q8w.cu). A block owns a strip of 256 output columns
// and a slice of din; each of its 256 threads owns 4 adjacent columns (one
// 4-byte load per packed row holds 8 weights) and every 4th packed row of
// the slice, and issues 8 row loads before it uses any of them. The block's
// x rows (up to 16, rounded to bf16) sit in shared memory; a packed row's two
// x values are one 32-bit broadcast load. Each weight is unpacked by two
// shifts, converted and multiplied by its bf16-rounded scale once, then
// feeds 16 FMAs. The four row groups are summed through shared memory in a
// fixed order; when the strips cannot fill the card, din is split across
// blocks and a second small kernel adds the partial sums in a fixed order
// (deterministic, no atomics).
#include "common.cuh"

namespace {

constexpr int kCols = 256;      // output columns per block
constexpr int kThreads = 256;   // 64 column quads x 4 row groups
constexpr int kGroups = 4;      // row groups (interleaved packed rows)
constexpr int kRows = 16;       // x rows per block
constexpr int kUnroll = 8;      // packed weight rows in flight per thread
constexpr int kKMax = 1280;     // din rows per block (x slice in shared memory)

// the scales of 4 adjacent columns of group g, rounded to bf16
template <bool VEC>
__device__ __forceinline__ void load_scales(const float* __restrict__ s,
                                            int g, int col, int dout,
                                            float out[4]) {
  const float* p = s + (size_t)g * dout + col;
  if (VEC) {
    const float4 v = col < dout
        ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0, 0, 0, 0);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = col + j < dout ? __ldg(p + j) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = arp::round_bf16(out[j]);
}

template <typename TX, bool VEC>
__global__ void __launch_bounds__(kThreads)
q4w_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ out,
           float* __restrict__ partial, int B, int din, int dout, int group,
           int k_per_split) {
  // x slice as bf16 during the main loop; reused for the row-group sums
  __shared__ __align__(16) unsigned char smem[kRows * kKMax * 2];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat162* x2_s = reinterpret_cast<const __nv_bfloat162*>(smem);
  float4* red = reinterpret_cast<float4*>(smem);  // [kRows][kCols / 4]

  const int n0 = blockIdx.x * kCols;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int k_begin = split * k_per_split;          // even
  const int klen = min(din, k_begin + k_per_split) - k_begin;
  const int plen = klen / 2;                        // packed rows
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

  const int8_t* wp = w + (size_t)(k_begin / 2) * dout + col;
  for (int pl = grp; pl < plen; pl += kGroups * kUnroll) {
    uint32_t wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = pl + u * kGroups;
      wv[u] = 0u;
      if (r < plen) {
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
      const int r = pl + u * kGroups;
      if (r >= plen) break;
      const int k0 = k_begin + 2 * r;  // din row of the low nibbles
      const int g0 = k0 / group, g1 = (k0 + 1) / group;
      float s0[4], s1[4];
      load_scales<VEC>(s, g0, col, dout, s0);
      if (g1 == g0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s1[j] = s0[j];
      } else {
        load_scales<VEC>(s, g1, col, dout, s1);
      }
      float wlo[4], whi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wlo[j] = arp::s4lo(wv[u], j) * s0[j];
        whi[j] = arp::s4hi(wv[u], j) * s1[j];
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const __nv_bfloat162 xx = x2_s[b * (kKMax / 2) + r];
        const float xlo = __low2float(xx), xhi = __high2float(xx);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[b][j] = fmaf(xhi, whi[j], fmaf(xlo, wlo[j], acc[b][j]));
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
  float* dst = partial != nullptr ? partial + (size_t)split * B * dout : out;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const int row = row0 + b;
    if (row >= B) break;
    const float4 p = red[b * (kCols / 4) + quad];
    const float4 tot = make_float4(p.x + acc[b][0], p.y + acc[b][1],
                                   p.z + acc[b][2], p.w + acc[b][3]);
    float* o = dst + (size_t)row * dout + col;
    if (VEC) {
      if (col < dout) *reinterpret_cast<float4*>(o) = tot;
    } else {
      const float t[4] = {tot.x, tot.y, tot.z, tot.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < dout) o[j] = t[j];
    }
  }
}

__global__ void q4w_reduce(const float* __restrict__ partial,
                           float* __restrict__ out, int splits, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int sp = 0; sp < splits; ++sp) acc += partial[sp * n + i];
  out[i] = acc;
}

template <typename TX>
cudaError_t launch(const void* x, const int8_t* w, const float* s,
                   float* out, float* scratch, int B, int din, int dout,
                   int group, int splits, int k_per_split, bool vec,
                   cudaStream_t stream) {
  dim3 grid((dout + kCols - 1) / kCols, splits, (B + kRows - 1) / kRows);
  float* partial = splits > 1 ? scratch : nullptr;
  const TX* xp = static_cast<const TX*>(x);
  if (vec)
    q4w_kernel<TX, true><<<grid, kThreads, 0, stream>>>(
        xp, w, s, out, partial, B, din, dout, group, k_per_split);
  else
    q4w_kernel<TX, false><<<grid, kThreads, 0, stream>>>(
        xp, w, s, out, partial, B, din, dout, group, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)B * dout;
  q4w_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      scratch, out, splits, n);
  return cudaGetLastError();
}

}  // namespace

// x (B, din) f32/bf16 row-major; w (din/2, dout) int8 row-pair packed;
// s (din/group, dout) f32; out (B, dout) f32; scratch (splits, B, dout) f32
// when splits > 1. Split sp covers din rows [sp*k_per_split,
// (sp+1)*k_per_split), k_per_split even and at most 1280. vec: dout % 4 == 0,
// w 4-byte and s, out, scratch 16-byte aligned.
extern "C" int matmul_q4w_launch(const void* x, const void* w, const void* s,
                                 void* out, void* scratch, int B, int din,
                                 int dout, int group, int splits,
                                 int k_per_split, int vec, int x_dtype,
                                 void* stream) {
  if (B < 1 || din < 2 || din % 2 != 0 || dout < 1 || group < 1 ||
      din % group != 0 || splits < 1 || k_per_split < 2 ||
      k_per_split % 2 != 0 || k_per_split > kKMax ||
      (long long)splits * k_per_split < din ||
      (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  float* op = static_cast<float*>(out);
  float* scr = static_cast<float*>(scratch);
  cudaError_t err;
  if (x_dtype == arp::kF32)
    err = launch<float>(x, wp, sp, op, scr, B, din, dout, group, splits,
                        k_per_split, vec != 0, st);
  else if (x_dtype == arp::kBF16)
    err = launch<__nv_bfloat16>(x, wp, sp, op, scr, B, din, dout, group,
                                splits, k_per_split, vec != 0, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
