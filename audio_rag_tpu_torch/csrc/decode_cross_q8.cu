// M-query cross-attention over int8 K/V stored transposed as (hd, Ta).
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::decode_cross_attention_q8
// (:92-132, body _decode_cross_kernel :38-88), called from
// models/whisper.py::_cross_with_kv in the decode loop when the cross K/V is
// int8 and there are at most 8 queries per row (greedy M = 1; beams ride M).
// Same function: softmax(q.K / sqrt(hd)) . V with K = k8 * ks and
// V = v8 * vs per (batch, head); the K scale and 1/sqrt(hd) fold into q and
// the V scale multiplies the output, so the int8 values are used as read.
//
// Bound on this card: bytes. Each decode step reads the whole int8 cross
// K/V once per layer (2*hd*Ta bytes per (b, h)) and does ~4*M flops per
// byte. Design: one block per (b, h), 256 threads. Threads read K rows
// with 4-byte loads (four consecutive keys; neighbouring threads read
// neighbouring words) and keep M x 4 scores in registers; the scores go to
// shared memory, a block-wide max and sum (warp shuffles + one shared
// round) turn them into probabilities; then each warp takes whole rows d
// of V, reads them with 4-byte loads, and reduces sum_t p[m][t] V[d][t]
// with a warp sum. The int8 K and V bytes of a (b, h) are each read exactly
// once, and nothing dequantized is written to device memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int M, typename TQ, bool VEC4>
__global__ void __launch_bounds__(kThreads)
cross_q8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ k8,
                const int8_t* __restrict__ v8, const float* __restrict__ ks,
                const float* __restrict__ vs, float* __restrict__ out,
                int hd, int Ta, float scale) {
  extern __shared__ float smem[];
  float* p_s = smem;          // M x Ta scores, then probabilities
  float* q_s = smem + M * Ta; // M x hd, K scale and 1/sqrt(hd) folded in
  __shared__ float red[kWarps][M];
  __shared__ float row_max[M], row_sum[M];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* K = k8 + (size_t)bh * hd * Ta;
  const int8_t* V = v8 + (size_t)bh * hd * Ta;
  const float qscale = ks[bh] * scale;

  for (int i = tid; i < M * hd; i += kThreads)
    q_s[i] = arp::to_f32(q[(size_t)bh * M * hd + i]) * qscale;
  __syncthreads();

  // scores: four consecutive keys per thread, all M queries
  for (int t0 = tid * 4; t0 < Ta; t0 += kThreads * 4) {
    float acc[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float kv[4];
      if (VEC4) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(K + (size_t)d * Ta + t0);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = arp::s8(w4, j);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = t0 + j < Ta ? static_cast<float>(K[(size_t)d * Ta + t0 + j])
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

  // out[m][d] = vs * sum_t p[m][t] V[d][t] / sum[m]; one warp per row d
  const float vscale = vs[bh];
  for (int d = warp; d < hd; d += kWarps) {
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.f;
    for (int t0 = lane * 4; t0 < Ta; t0 += 32 * 4) {
      float vv[4];
      if (VEC4) {
        const uint32_t w4 =
            *reinterpret_cast<const uint32_t*>(V + (size_t)d * Ta + t0);
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = arp::s8(w4, j);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + m * Ta + t0);
          acc[m] = fmaf(p.x, vv[0], acc[m]);
          acc[m] = fmaf(p.y, vv[1], acc[m]);
          acc[m] = fmaf(p.z, vv[2], acc[m]);
          acc[m] = fmaf(p.w, vv[3], acc[m]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (t0 + j >= Ta) break;
          const float vj = static_cast<float>(V[(size_t)d * Ta + t0 + j]);
#pragma unroll
          for (int m = 0; m < M; ++m)
            acc[m] = fmaf(p_s[m * Ta + t0 + j], vj, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float tot = arp::warp_sum(acc[m]);
      if (lane == 0)
        out[((size_t)bh * M + m) * hd + d] = tot / row_sum[m] * vscale;
    }
  }
}

template <int M, typename TQ>
cudaError_t launch(const void* q, const int8_t* k8, const int8_t* v8,
                   const float* ks, const float* vs, float* out, int BH,
                   int hd, int Ta, float scale, bool vec4,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)M * (Ta + hd);
  const TQ* qp = static_cast<const TQ*>(q);
  if (vec4) {
    auto kern = cross_q8_kernel<M, TQ, true>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k8, v8, ks, vs, out, hd, Ta,
                                         scale);
  } else {
    auto kern = cross_q8_kernel<M, TQ, false>;
    cudaError_t err = arp::allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<BH, kThreads, smem, stream>>>(qp, k8, v8, ks, vs, out, hd, Ta,
                                         scale);
  }
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_m(int M, const void* q, const int8_t* k8,
                       const int8_t* v8, const float* ks, const float* vs,
                       float* out, int BH, int hd, int Ta, float scale,
                       bool vec4, cudaStream_t st) {
  switch (M) {
    case 1: return launch<1, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 2: return launch<2, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 3: return launch<3, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 4: return launch<4, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 5: return launch<5, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 6: return launch<6, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 7: return launch<7, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    case 8: return launch<8, TQ>(q, k8, v8, ks, vs, out, BH, hd, Ta, scale, vec4, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, M, hd) f32/bf16; k8, v8 (BH, hd, Ta) int8; ks, vs (BH,) f32;
// out (BH, M, hd) f32. vec4: Ta % 4 == 0 and 4-byte aligned K/V.
extern "C" int decode_cross_q8_launch(const void* q, const void* k8,
                                      const void* v8, const void* ks,
                                      const void* vs, void* out, int BH,
                                      int M, int hd, int Ta, float scale,
                                      int vec4, int q_dtype, void* stream) {
  if (BH < 1 || hd < 1 || Ta < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k8);
  const int8_t* vp = static_cast<const int8_t*>(v8);
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
