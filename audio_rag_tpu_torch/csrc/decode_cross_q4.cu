// M-query cross-attention over int4 K/V, nibble-packed along head_dim.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::decode_cross_attention_q4
// (:178-219, body _decode_cross_q4_kernel :135-174), called from
// models/whisper.py::_cross_with_kv in the decode loop when the cross K/V is
// int4 (cross_kv_int4) and there are at most 8 queries per row.
// Same function: softmax(q.K / sqrt(hd)) . V with K[d][t] = k[d][t] * ks[d]
// and V[d][t] = v[d][t] * vs[d], per-channel scales of each (batch, head).
// K/V are stored (hd/2, Ta) per (b, h) in half-split order: byte row r holds
// head dim r in its low nibble and head dim r + hd/2 in its high nibble.
// The K channel scales and 1/sqrt(hd) fold into q; the V channel scales
// multiply the output, so the int4 values are used as read.
//
// Bound on this card: bytes. Each decode step reads the whole int4 cross
// K/V once per layer (hd*Ta bytes per (b, h), a quarter of bf16) and does
// ~8*M flops per byte. Design: the int8 kernel's (decode_cross_q8.cu), one
// block per (b, h), 256 threads, each packed byte read exactly once. For
// the scores a thread reads a 4-byte word of byte row r (four consecutive
// keys) and unpacks both nibbles: the low ones meet q[r], the high ones
// q[r + hd/2]. For P.V a warp takes byte row r and sums both output dims
// r and r + hd/2 from the same word. Unpacking is two shifts per nibble
// (arp::s4lo / s4hi); nothing dequantized reaches device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool VEC4>
__device__ __forceinline__ uint32_t load4(const int8_t* row, int t0, int Ta) {
  if (VEC4) return *reinterpret_cast<const uint32_t*>(row + t0);
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (t0 + j < Ta) w |= (uint32_t)(uint8_t)row[t0 + j] << (8 * j);
  return w;
}

template <int M, typename TQ, bool VEC4>
__global__ void __launch_bounds__(kThreads)
cross_q4_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k4,
                const int8_t* __restrict__ v4, const float* __restrict__ ks,
                const float* __restrict__ vs, float* __restrict__ out,
                int hd, int Ta, float scale) {
  extern __shared__ float smem[];
  float* p_s = smem;          // M x Ta scores, then probabilities
  float* q_s = smem + M * Ta; // M x hd, K channel scales and 1/sqrt(hd) in
  __shared__ float red[kWarps][M];
  __shared__ float row_max[M], row_sum[M];

  const int bh = blockIdx.x;
  const int half = hd / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* K = k4 + (size_t)bh * half * Ta;
  const int8_t* V = v4 + (size_t)bh * half * Ta;
  const float* ksc = ks + (size_t)bh * hd;
  const float* vsc = vs + (size_t)bh * hd;

  for (int i = tid; i < M * hd; i += kThreads)
    q_s[i] = arp::to_f32(q[(size_t)bh * M * hd + i]) * (scale * ksc[i % hd]);
  __syncthreads();

  // scores: four consecutive keys per thread, all M queries; byte row r
  // holds dims r (low nibbles) and r + hd/2 (high nibbles)
  for (int t0 = tid * 4; t0 < Ta; t0 += kThreads * 4) {
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    for (int r = 0; r < half; ++r) {
      const uint32_t w = load4<VEC4>(K + (size_t)r * Ta, t0, Ta);
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = arp::s4lo(w, j);
        hi[j] = arp::s4hi(w, j);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float qlo = q_s[m * hd + r], qhi = q_s[m * hd + r + half];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = fmaf(qhi, hi[j], fmaf(qlo, lo[j], acc[m][j]));
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t0 + j < Ta) p_s[m * Ta + t0 + j] = acc[m][j];
  }
  __syncthreads();

  // block max per query row
  float lm[M];
#pragma unroll
  for (int m = 0; m < M; ++m) lm[m] = -INFINITY;
  for (int t = tid; t < Ta; t += kThreads)
#pragma unroll
    for (int m = 0; m < M; ++m) lm[m] = fmaxf(lm[m], p_s[m * Ta + t]);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float wm = arp::warp_max(lm[m]);
    if (lane == 0) red[warp][m] = wm;
  }
  __syncthreads();
  if (tid < M) {
    float v = red[0][tid];
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w][tid]);
    row_max[tid] = v;
  }
  __syncthreads();

  // exponentiate in place, block sum per query row
  float ls[M];
#pragma unroll
  for (int m = 0; m < M; ++m) ls[m] = 0.f;
  for (int t = tid; t < Ta; t += kThreads)
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float p = expf(p_s[m * Ta + t] - row_max[m]);
      p_s[m * Ta + t] = p;
      ls[m] += p;
    }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float ws = arp::warp_sum(ls[m]);
    if (lane == 0) red[warp][m] = ws;
  }
  __syncthreads();
  if (tid < M) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w][tid];
    row_sum[tid] = v;
  }
  __syncthreads();

  // out[m][r] and out[m][r + hd/2] from byte row r of V; one warp per row
  for (int r = warp; r < half; r += kWarps) {
    float alo[M], ahi[M];
#pragma unroll
    for (int m = 0; m < M; ++m) alo[m] = ahi[m] = 0.f;
    for (int t0 = lane * 4; t0 < Ta; t0 += 32 * 4) {
      const uint32_t w = load4<VEC4>(V + (size_t)r * Ta, t0, Ta);
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = arp::s4lo(w, j);
        hi[j] = arp::s4hi(w, j);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float p[4];
        if (VEC4) {  // Ta % 4 == 0: a 16-byte aligned float4 of p_s
          const float4 p4 = *reinterpret_cast<const float4*>(p_s + m * Ta + t0);
          p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) p[j] = t0 + j < Ta ? p_s[m * Ta + t0 + j] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          alo[m] = fmaf(p[j], lo[j], alo[m]);
          ahi[m] = fmaf(p[j], hi[j], ahi[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float tlo = arp::warp_sum(alo[m]);
      const float thi = arp::warp_sum(ahi[m]);
      if (lane == 0) {
        float* o = out + ((size_t)bh * M + m) * hd;
        o[r] = tlo / row_sum[m] * vsc[r];
        o[r + half] = thi / row_sum[m] * vsc[r + half];
      }
    }
  }
}

template <int M, typename TQ>
cudaError_t launch(const void* q, const int8_t* k4, const int8_t* v4,
                   const float* ks, const float* vs, float* out, int BH,
                   int hd, int Ta, float scale, bool vec4,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)M * (Ta + hd);
  const TQ* qp = static_cast<const TQ*>(q);
  if (vec4) {
    auto kern = cross_q4_kernel<M, TQ, true>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k4, v4, ks, vs, out, hd, Ta,
                                         scale);
  } else {
    auto kern = cross_q4_kernel<M, TQ, false>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k4, v4, ks, vs, out, hd, Ta,
                                         scale);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_m(int M, const void* q, const int8_t* k4,
                       const int8_t* v4, const float* ks, const float* vs,
                       float* out, int BH, int hd, int Ta, float scale,
                       bool vec4, cudaStream_t st) {
  switch (M) {
    case 1: return launch<1, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 2: return launch<2, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 3: return launch<3, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 4: return launch<4, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 5: return launch<5, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 6: return launch<6, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 7: return launch<7, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 8: return launch<8, TQ>(q, k4, v4, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, M, hd) f32/bf16; k4, v4 (BH, hd/2, Ta) int8 half-split packed;
// ks, vs (BH, hd) f32 channel scales; out (BH, M, hd) f32.
// vec4: Ta % 4 == 0 and 4-byte aligned K/V.
extern "C" int decode_cross_q4_launch(const void* q, const void* k4,
                                      const void* v4, const void* ks,
                                      const void* vs, void* out, int BH,
                                      int M, int hd, int Ta, float scale,
                                      int vec4, int q_dtype, void* stream) {
  if (BH < 1 || hd < 2 || hd % 2 != 0 || Ta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k4);
  const int8_t* vp = static_cast<const int8_t*>(v4);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (q_dtype == arp::kF32)
    err = dispatch_m<float>(M, q, kp, vp, ksp, vsp, op, BH, hd, Ta, scale,
                            vec4 != 0, st);
  else if (q_dtype == arp::kBF16)
    err = dispatch_m<__nv_bfloat16>(M, q, kp, vp, ksp, vsp, op, BH, hd, Ta,
                                    scale, vec4 != 0, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
