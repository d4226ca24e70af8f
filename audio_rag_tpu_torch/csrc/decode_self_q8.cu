// Decode self-attention over an int8 self cache with per-position scales.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::decode_self_attention_q8
// (:282-322, body _decode_self_kernel :222-273), called from
// models/whisper.py::decoder_step in the greedy loop with self_kv_int8.
// Same function, per (batch b, head h):
//   s[t] = (q/sqrt(hd) . k8[:, t]) * ks[t] + mask[t]
//   p    = softmax(s) * vs[t]
//   o[d] = sum_t p[t] v8[d][t]
// with the cache (hd, Cp) int8 per (b, h) and one packed (Cp, 128) f32
// operand per b, shared with the JAX package's cache format: K scales of
// position t in lanes [0, H), V scales in [H, 2H), the additive mask
// (0 valid, -1e30 past the write head) in lane 2H. A row that is all
// -1e30 stays finite: its softmax is uniform.
//
// Bound on this card: bytes. A step reads the whole int8 self cache of a
// layer once (2*hd*Cp bytes per (b, h)) plus the packed scales. Design: the
// cross kernel's (decode_cross_q8.cu), one block per (b, h), 256 threads:
// 4-byte loads of four consecutive positions for the scores, which then take
// their K scale and mask from the packed row; the V scale multiplies each
// exponentiated score (the normaliser sums the unscaled ones); each warp
// reduces whole rows d of V. The int8 bytes are read once and nothing
// dequantized reaches device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // floats per packed scale row

template <int M, typename TQ, bool VEC4>
__global__ void __launch_bounds__(kThreads)
self_q8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k8,
               const int8_t* __restrict__ v8, const float* __restrict__ sc,
               float* __restrict__ out, int H, int hd, int Cp, float scale) {
  extern __shared__ float smem[];
  float* p_s = smem;          // M x Cp scores, then p * vs
  float* q_s = smem + M * Cp; // M x hd, 1/sqrt(hd) folded in
  __shared__ float red[kWarps][M];
  __shared__ float row_max[M], row_sum[M];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* K = k8 + (size_t)bh * hd * Cp;
  const int8_t* V = v8 + (size_t)bh * hd * Cp;
  const float* S = sc + (size_t)b * Cp * kLanes;

  for (int i = tid; i < M * hd; i += kThreads)
    q_s[i] = arp::to_f32(q[(size_t)bh * M * hd + i]) * scale;
  __syncthreads();

  // scores: four consecutive positions per thread, all M queries
  for (int t0 = tid * 4; t0 < Cp; t0 += kThreads * 4) {
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[4];
      if (VEC4) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(K + (size_t)d * Cp + t0);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = arp::s8(w4, j);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = t0 + j < Cp ? static_cast<float>(K[(size_t)d * Cp + t0 + j])
                              : 0.f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float qd = q_s[m * hd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(qd, kv[j], acc[m][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      if (t >= Cp) break;
      const float kscale = S[(size_t)t * kLanes + h];
      const float mask = S[(size_t)t * kLanes + 2 * H];
#pragma unroll
      for (int m = 0; m < M; ++m) p_s[m * Cp + t] = acc[m][j] * kscale + mask;
    }
  }
  __syncthreads();

  // block max per query row
  float lm[M];
#pragma unroll
  for (int m = 0; m < M; ++m) lm[m] = -INFINITY;
  for (int t = tid; t < Cp; t += kThreads)
#pragma unroll
    for (int m = 0; m < M; ++m) lm[m] = fmaxf(lm[m], p_s[m * Cp + t]);
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

  // exponentiate, sum the plain exponentials, keep them times the V scale
  float ls[M];
#pragma unroll
  for (int m = 0; m < M; ++m) ls[m] = 0.f;
  for (int t = tid; t < Cp; t += kThreads) {
    const float vscale = S[(size_t)t * kLanes + H + h];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float e = expf(p_s[m * Cp + t] - row_max[m]);
      p_s[m * Cp + t] = e * vscale;
      ls[m] += e;
    }
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

  // out[m][d] = sum_t (p vs)[m][t] V[d][t] / sum[m]; one warp per row d
  for (int d = warp; d < hd; d += kWarps) {
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.f;
    for (int t0 = lane * 4; t0 < Cp; t0 += 32 * 4) {
      if (VEC4) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(V + (size_t)d * Cp + t0);
        float vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = arp::s8(w4, j);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + m * Cp + t0);
          acc[m] = fmaf(p.x, vv[0], acc[m]);
          acc[m] = fmaf(p.y, vv[1], acc[m]);
          acc[m] = fmaf(p.z, vv[2], acc[m]);
          acc[m] = fmaf(p.w, vv[3], acc[m]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (t0 + j >= Cp) break;
          const float vj = static_cast<float>(V[(size_t)d * Cp + t0 + j]);
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m] = fmaf(p_s[m * Cp + t0 + j], vj, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float tot = arp::warp_sum(acc[m]);
      if (lane == 0) out[((size_t)bh * M + m) * hd + d] = tot / row_sum[m];
    }
  }
}

template <int M, typename TQ>
cudaError_t launch(const void* q, const int8_t* k8, const int8_t* v8,
                   const float* sc, float* out, int BH, int H, int hd,
                   int Cp, float scale, bool vec4, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)M * (Cp + hd);
  const TQ* qp = static_cast<const TQ*>(q);
  if (vec4) {
    auto kern = self_q8_kernel<M, TQ, true>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k8, v8, sc, out, H, hd, Cp,
                                         scale);
  } else {
    auto kern = self_q8_kernel<M, TQ, false>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k8, v8, sc, out, H, hd, Cp,
                                         scale);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_m(int M, const void* q, const int8_t* k8,
                       const int8_t* v8, const float* sc, float* out, int BH,
                       int H, int hd, int Cp, float scale, bool vec4,
                       cudaStream_t st) {
  switch (M) {
    case 1: return launch<1, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 2: return launch<2, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 3: return launch<3, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 4: return launch<4, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 5: return launch<5, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 6: return launch<6, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 7: return launch<7, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    case 8: return launch<8, TQ>(q, k8, v8, sc, out, BH, H, hd, Cp, scale, vec4, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B*H, M, hd) f32/bf16; k8, v8 (B*H, hd, Cp) int8; sc (B, Cp, 128) f32
// packed scales and mask; out (B*H, M, hd) f32. 2*H < 128.
// vec4: Cp % 4 == 0 and 4-byte aligned K/V.
extern "C" int decode_self_q8_launch(const void* q, const void* k8,
                                     const void* v8, const void* sc,
                                     void* out, int B, int H, int M, int hd,
                                     int Cp, float scale, int vec4,
                                     int q_dtype, void* stream) {
  if (B < 1 || H < 1 || 2 * H >= kLanes || hd < 1 || Cp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k8);
  const int8_t* vp = static_cast<const int8_t*>(v8);
  const float* scp = static_cast<const float*>(sc);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (q_dtype == arp::kF32)
    err = dispatch_m<float>(M, q, kp, vp, scp, op, B * H, H, hd, Cp, scale,
                            vec4 != 0, st);
  else if (q_dtype == arp::kBF16)
    err = dispatch_m<__nv_bfloat16>(M, q, kp, vp, scp, op, B * H, H, hd, Cp,
                                    scale, vec4 != 0, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
