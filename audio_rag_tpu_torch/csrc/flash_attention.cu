// Unmasked softmax(Q K^T / sqrt(D)) V with a blocked online softmax, f32 inside.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::flash_attention (:688-716,
// body _flash_kernel :655-682), which the JAX package reaches through
// attend_auto (:723-775) from models/layers.py::_attend for the Whisper
// encoder's self-attention.
//
// Bound on this card: operations. The work is 4*B*H*Tq*Tk*D flops against
// ~4*B*H*T*D*bytes of q/k/v/o traffic (at large-v3, T=1500, D=64, about 390
// flops per byte), so a tiled kernel is limited by arithmetic, not by HBM.
// Design: two kernels behind one entry point. Keys at or past kv_len are
// masked inside both, so any Tk works without the TPU router's
// pad-and-extra-feature trick, and any D <= 128 works.
// * bf16 (the production encoder) with D a multiple of 16: tensor cores
//   through mma.sync (flash_mma_kernel below); wgmma/TMA pipelining is later
//   work.
// * f32, or bf16 with other D: f32 on the CUDA cores, like the TPU kernel's
//   f32 body, so the f32 profile stays f32. One block owns 32 query rows of
//   one (batch, head); eight warps own four rows each. The block walks the
//   keys in tiles of 64 staged in shared memory (K rows padded by one float
//   against bank conflicts); each lane scores two keys per row, a warp
//   max/sum carries the running softmax, and the P.V update broadcasts each
//   probability with a shuffle while every lane accumulates its own D/32
//   output features in registers.
#include "common.cuh"

namespace {

constexpr int kBQ = 32;    // query rows per block
constexpr int kBK = 64;    // keys per shared-memory tile
constexpr int kWarps = 8;  // 256 threads
constexpr int kRows = kBQ / kWarps;

struct Strides {
  long long b, h, t;  // element strides; the feature stride is 1
};

template <typename T, int DL>  // DL = ceil(D / 32): features per lane
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides qs,
             Strides ks, Strides vs, Strides os, int H, int Tq, int D,
             int kv_len, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* q_s = smem;            // kBQ x D, pre-scaled by 1/sqrt(D)
  float* k_s = q_s + kBQ * D;   // kBK x DP
  float* v_s = k_s + kBK * DP;  // kBK x D

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = blockIdx.x * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = warp * kRows;

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < Tq ? arp::to_f32(qb[row * qs.t + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += kBK) {
    __syncthreads();  // q staged / previous tile consumed
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < kv_len) {
        kv = arp::to_f32(kb[key * ks.t + d]);
        vv = arp::to_f32(vb[key * vs.t + d]);
      }
      k_s[j * DP + d] = kv;
      v_s[j * D + d] = vv;
    }
    __syncthreads();

    // scores of this warp's rows against keys (lane, lane + 32)
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k_lo = k_s + lane * DP;
    const float* k_hi = k_s + (lane + 32) * DP;
    for (int d = 0; d < D; ++d) {
      const float a = k_lo[d], c = k_hi[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qd = q_s[(r0 + r) * D + d];
        s[r][0] = fmaf(qd, a, s[r][0]);
        s[r][1] = fmaf(qd, c, s[r][1]);
      }
    }
    const bool ok0 = k0 + lane < kv_len, ok1 = k0 + lane + 32 < kv_len;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = ok0 ? s[r][0] : -INFINITY;
      const float c = ok1 ? s[r][1] : -INFINITY;
      // key k0 is always valid, so the tile max is finite
      const float m_new = fmaxf(m[r], arp::warp_max(fmaxf(a, c)));
      const float p0 = ok0 ? expf(a - m_new) : 0.f;
      const float p1 = ok1 ? expf(c - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * alpha + arp::warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
      s[r][0] = p0;
      s[r][1] = p1;
    }

    // acc += P . V: probabilities broadcast by shuffle, features per lane
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* vrow = v_s + (j + 32 * half) * D;
        float vv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < D ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r][half], j);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) arp::store_f32(ob + row * os.t + d, acc[r][i] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulate).
//
// One block per (b*h, 64 query rows); four warps own 16 rows each and keep
// their Q fragments in registers. Per tile of 64 keys, K is staged in shared
// memory as it is ([key][d], rows padded by 8 bf16 so the fragment reads
// hit 32 distinct banks) and V transposed ([d][key], same padding), so that
// every B fragment is one 32-bit shared load. S = Q K^T stays in registers;
// the online softmax runs on the accumulator layout (a row lives in the 4
// threads of a quad); P is rounded to bf16 and fed straight back as the A
// operand of P.V (the C layout of two n8 tiles is the A layout of one k16
// chunk). The TPU kernel's f32 dots of p and v run at the MXU's default
// precision, which also rounds the operands to bf16.
constexpr int kMmaRows = 64;   // query rows per block
constexpr int kMmaKeys = 64;   // keys per tile
constexpr int kMmaWarps = 4;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

template <int DK>  // DK = D / 16
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int H, int Tq, int kv_len,
                 float scale_log2) {
  constexpr int D = DK * 16;
  constexpr int DN = D / 8;           // n8 tiles of the output
  constexpr int KS = D + 8;           // K row stride in shared memory
  constexpr int VS = kMmaKeys + 8;    // transposed-V row stride
  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaKeys * KS];
  __shared__ __align__(16) __nv_bfloat16 v_s[D * VS];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // quad row, thread in quad
  const int row0 = blockIdx.x * kMmaRows + warp * 16 + g;  // and row0 + 8

  // Q fragments: a[0] (row g, d 2t..), a[1] (row g+8), a[2]/a[3] at d+8
  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int d = kk * 16 + (r >> 1) * 8 + 2 * t;
      qf[kk][r] = row < Tq ? *reinterpret_cast<const uint32_t*>(
                                 qb + row * qs.t + d)
                           : 0u;
    }
  }

  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kMmaKeys) {
    __syncthreads();  // previous tile consumed
    for (int i = tid; i < kMmaKeys * (D / 8); i += kMmaWarps * 32) {
      const int j = i / (D / 8), c = (i - j * (D / 8)) * 8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < kv_len) {
        kv = *reinterpret_cast<const uint4*>(kb + key * ks.t + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * vs.t + c);
      }
      *reinterpret_cast<uint4*>(k_s + j * KS + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v_s[(c + e) * VS + j] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (n * 8 + g) * KS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        mma_bf16(s[n], qf[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }

    // online softmax in base 2; keys at or past kv_len are masked
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = key < kv_len ? s[n][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key k0 is valid for every row, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += P V: key chunk j of 16 is the A operand from S tiles 2j, 2j+1
#pragma unroll
    for (int j = 0; j < kMmaKeys / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < DN; ++n) {
        const __nv_bfloat16* vr = v_s + (n * 8 + g) * VS + j * 16 + 2 * t;
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  // row sums live spread over the quad
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    const int d = n * 8 + 2 * t;
    if (row0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + row0 * os.t + d) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row0 + 8 < Tq)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * os.t + d) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int DK>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, int B, int H, int Tq, int kv_len,
                       float scale, cudaStream_t stream) {
  dim3 grid((Tq + kMmaRows - 1) / kMmaRows, B * H);
  flash_mma_kernel<DK><<<grid, kMmaWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st[0], st[1], st[2], st[3], H, Tq, kv_len,
      scale * 1.4426950408889634f);  // exp(x) = exp2(x log2 e)
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o,
                         const Strides* st, int B, int H, int Tq, int D,
                         int kv_len, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_mma<1>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 32: return launch_mma<2>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 48: return launch_mma<3>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 64: return launch_mma<4>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 80: return launch_mma<5>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 96: return launch_mma<6>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 112: return launch_mma<7>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    case 128: return launch_mma<8>(q, k, v, o, st, B, H, Tq, kv_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int DL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const Strides* st, int B, int H, int Tq, int D,
                   int kv_len, float scale, cudaStream_t stream) {
  auto kern = flash_kernel<T, DL>;
  const size_t smem =
      sizeof(float) * (size_t)(kBQ * D + kBK * (D + 1) + kBK * D);
  cudaError_t err = arp::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], H, Tq, D, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       const Strides* st, int B, int H, int Tq, int D,
                       int kv_len, float scale, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, stream);
    case 2: return launch<T, 2>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, stream);
    case 3: return launch<T, 3>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, stream);
    case 4: return launch<T, 4>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, time) of q, k, v, o in order.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int Tq, int D, int kv_len, float scale,
                                      int dtype, void* stream) {
  if (D < 1 || D > 128 || kv_len < 1 || Tq < 1) return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tensor-core path loads 16 bytes of K/V rows and 4 bytes of Q/O at
  // a time: D a multiple of 16, every stride a multiple of 8 elements
  bool aligned = D % 16 == 0;
  for (int i = 0; i < 12; ++i) aligned = aligned && strides[i] % 8 == 0;
  const uintptr_t ptr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  aligned = aligned && ptr_bits % 16 == 0;
  cudaError_t err;
  if (dtype == arp::kF32)
    err = dispatch_d<float>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, s);
  else if (dtype == arp::kBF16 && aligned)
    err = dispatch_mma(q, k, v, o, st, B, H, Tq, D, kv_len, scale, s);
  else if (dtype == arp::kBF16)
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, st, B, H, Tq, D, kv_len, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
