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
// At D = 64 the exponentials come close to that bound too: B*H*Tq*Tk of
// them at 16 a clock per SM take about as long as the tensor cores' work,
// so a kernel that does not overlap the two cannot reach either.
// Design: three kernels behind one entry point, chosen by dtype, D and
// layout (the entry reports which one ran). Keys at or past kv_len are
// masked inside each, so any Tk works without the TPU router's
// pad-and-extra-feature trick, and any D <= 128 works.
// * bf16 with D = 64 (the Whisper encoder at every size) whose q/k/v a TMA
//   tensor map can describe: flash_wgmma_kernel below, warpgroup MMAs
//   (wgmma) on K/V tiles that TMA streams into a shared-memory ring, with
//   three consumer warpgroups taking turns on the tensor cores so that
//   one's softmax runs under the others' products.
// * other bf16 with D a multiple of 16: tensor cores through mma.sync
//   (flash_mma_kernel below).
// * f32, or bf16 with other D: f32 on the CUDA cores, like the TPU kernel's
//   f32 body, so the f32 profile stays f32. One block owns 32 query rows of
//   one (batch, head); eight warps own four rows each. The block walks the
//   keys in tiles of 64 staged in shared memory (K rows padded by one float
//   against bank conflicts); each lane scores two keys per row, a warp
//   max/sum carries the running softmax, and the P.V update broadcasts each
//   probability with a shuffle while every lane accumulates its own D/32
//   output features in registers.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached
                   // through the runtime, so nothing links -lcuda

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

// ---------------------------------------------------------------------------
// bf16, D = 64, on the warpgroup tensor cores (wgmma), fed by TMA.
//
// A work item is 192 query rows of one (batch, head). The grid is
// persistent: one block per SM, each walking the items i, i + gridDim.x,
// ...; consecutive items are the query tiles of one (batch, head), so the
// blocks at work at once share their K/V in L2. A block has four
// warpgroups. Warpgroup 0 is the producer: one thread loads each item's Q
// tile into one of two Q slots and every 128-key tile of K and of V into a
// ring of kWgStages slots with TMA (cp.async.bulk.tensor over 4-D maps of
// (D, T, H, B) built on the host from the caller's strides, so the
// encoder's head-strided view is read as it is). Each slot has a "full"
// mbarrier (the TMA's bytes landed) and an "empty" one (every consumer is
// done with it); the ring runs on across items, so the next item's Q and
// first K/V tiles load while this one finishes. TMA writes the tiles with
// the 128-byte swizzle that wgmma's shared-memory descriptors read, and
// fills rows past T with zeros, so only the last key tile needs a mask,
// where the scores are formed. The producer gives its registers to the
// consumers (setmaxnreg), which need ~154 each.
//
// Warpgroups 1-3 are consumers of 64 query rows each. Per key tile j:
//   S_j = Q K_j^T   wgmma m64n128k16 x 4, Q and K from shared memory (K is
//                   [key][d], d the reduction axis, so no transpose);
//   O  += P_{j-1} V_{j-1}  wgmma m64n64k16 x 8, P from registers (the f32
//                   accumulator layout of S, rounded to bf16, is wgmma's A
//                   register layout), V read [key][d] through the
//                   transpose bit (no transposed copy of V);
// both issued together; the warpgroup waits for S_j only, runs the online
// softmax of S_j while P_{j-1} V_{j-1} is still on the tensor cores, then
// waits for that. The consumers also take turns issuing (named barriers
// 1-3, as FlashAttention-3 does), so that one's exponentials run under the
// others' products: at D = 64 the exponentials (16 a clock per SM) take as
// long as the products. The function is flash_mma_kernel's: f32 scores of
// exact bf16 products, base-2 online softmax with scale*log2(e) folded into
// one multiply, f32 row sums, P rounded to bf16 before P.V, f32
// accumulation, acc / max(l, 1e-30) rounded to bf16. Two roundings differ:
// the exponent s*c - m is one fused multiply-add (flash_mma_kernel rounds
// s*c first), and exponentials below 2^-126 flush to zero (ex2_ftz).
//
// Three design choices are compile-time switches, so that
// scripts/bench_flash_variants.py can time the alternatives; the defaults
// are the shipped kernel: FLASH_WG_CONSUMERS consumer warpgroups (2 or 3),
// FLASH_WG_STAGES K/V ring slots, FLASH_WG_TURNS 1 for the consumers'
// turn-taking barriers.
#ifndef FLASH_WG_CONSUMERS
#define FLASH_WG_CONSUMERS 3
#endif
#ifndef FLASH_WG_STAGES
#define FLASH_WG_STAGES 2
#endif
#ifndef FLASH_WG_TURNS
#define FLASH_WG_TURNS 1
#endif
constexpr int kWgD = 64;
constexpr int kWgConsumers = FLASH_WG_CONSUMERS;  // 64 query rows each
static_assert(kWgConsumers == 2 || kWgConsumers == 3, "2 or 3 consumers");
constexpr int kWgRows = 64 * kWgConsumers;  // query rows per work item
constexpr int kWgKeys = 128;   // keys per K/V tile
constexpr int kWgStages = FLASH_WG_STAGES;  // K/V ring slots
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgConsumerThreads = 128 * kWgConsumers;
constexpr int kWgTile = kWgKeys * kWgD * 2;  // bytes of one K or V tile
constexpr int kWgQ = kWgRows * kWgD * 2;
constexpr int kWgSmem = 2 * kWgQ + 2 * kWgStages * kWgTile + 1024;  // + align
static_assert(128 * 24 + kWgConsumerThreads * 160 <= 65536,
              "the producer's and consumers' registers fit the SM");

using arp::mbar_init;
using arp::mbar_wait;
using arp::smem_u32;

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(t), "r"(h), "r"(b)
      : "memory");
}

// shared-memory descriptor of a tile of 128-byte rows written by TMA with
// the 128-byte swizzle: 8-row atoms of 1024 bytes (the stride byte offset),
// the leading byte offset unused by this layout. The low 14 bits hold the
// address / 16, so +2 steps 16 bf16 along a row and +128 steps 16 rows.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads and writes across the
// asynchronous wgmma that owns these registers
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 f32) (+)= A (64x16, K-major, shared) . B (16x128, K-major, shared)
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (32 f32) += A (64x16, registers) . B (16x64, N-major in shared: V rows)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the MUFU alone: results below 2^-126 flush to zero, where exp2f
// spends three more instructions on keeping them subnormal. A row's sum is
// at least 1 (its maximum contributes 2^0), so nothing that reaches the
// output changes by more than 2^-126 of it.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one S tile in place (rows g and g + 8 of the warp:
// registers with bit 1 clear and set); masks keys at or past kv_len on the
// ragged last tile and returns the factors that rescale O
__device__ __forceinline__ void wg_softmax(float (&s)[64], float& m0, float& m1,
                                           float& l0, float& l1, float& al0,
                                           float& al1, int key0, int kv_len,
                                           float scale_log2, int t) {
  if (key0 + kWgKeys > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (key0 + 8 * (i >> 2) + 2 * t + (i & 1) >= kv_len) s[i] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // the tile's first key is valid for every row, so the maxima are finite;
  // scale_log2 > 0, so max(s) * c is the max of s * c
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  al0 = ex2_ftz(m0 - mn0);  // 0 on the first tile
  al1 = ex2_ftz(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; i += 4) {
    s[i] = ex2_ftz(fmaf(s[i], scale_log2, -mn0));
    s[i + 1] = ex2_ftz(fmaf(s[i + 1], scale_log2, -mn0));
    s[i + 2] = ex2_ftz(fmaf(s[i + 2], scale_log2, -mn1));
    s[i + 3] = ex2_ftz(fmaf(s[i + 3], scale_log2, -mn1));
    r0 += s[i] + s[i + 1];
    r1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * al0 + r0;
  l1 = l1 * al1 + r1;
}

// P (the S accumulator of 16 n8 tiles) → 8 bf16 A fragments of k16: chunk
// kk is n8 tiles 2kk and 2kk + 1, the C layout of mma.sync and of wgmma
__device__ __forceinline__ void wg_to_a(const float (&s)[64],
                                        uint32_t (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O *= the factor of each row's new maximum (rows g: registers with bit 1
// clear; g + 8: set)
__device__ __forceinline__ void wg_rescale(float (&o)[32], float al0,
                                           float al1) {
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? al1 : al0;
}

// S = Q K^T over D = 64: four k16 steps along the rows of both tiles
__device__ __forceinline__ void wg_scores(float (&s)[64], uint64_t dq,
                                          const uint8_t* k_tile) {
  const uint64_t dk = desc_sw128(k_tile);
#pragma unroll
  for (int kk = 0; kk < kWgD / 16; ++kk)
    wgmma_ss_m64n128k16(s, dq + 2 * kk, dk + 2 * kk, kk);
}

// O += P V over 128 keys: eight k16 steps of 16 V rows each
__device__ __forceinline__ void wg_pv(float (&o)[32], const uint32_t (&p)[8][4],
                                      const uint8_t* v_tile) {
  const uint64_t dv = desc_sw128(v_tile);
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk)
    wgmma_rs_m64n64k16(o, p[kk], dv + 128 * kk);
}

__device__ __forceinline__ void wg_turn_wait(int c) {  // my turn to issue
#if FLASH_WG_TURNS
  asm volatile("bar.sync %0, 256;" ::"r"(1 + c) : "memory");
#endif
}
__device__ __forceinline__ void wg_turn_pass(int c) {  // the next one's turn
#if FLASH_WG_TURNS
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + (c + 1) % kWgConsumers)
               : "memory");
#endif
}

__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, Strides os, int H, int Tq,
                   int kv_len, int n_work, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  // per Q slot: q_full, q_empty; per K/V slot: k_full, k_empty, v_full,
  // v_empty
  __shared__ __align__(8) uint64_t bars[4 + 4 * kWgStages];
  uint8_t* q_s = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint8_t* k_s = q_s + 2 * kWgQ;
  uint8_t* v_s = k_s + kWgStages * kWgTile;
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* k_empty = k_full + kWgStages;
  uint64_t* v_full = k_empty + kWgStages;
  uint64_t* v_empty = v_full + kWgStages;

  // the warpgroup index read from lane 0, so that the compiler can see it
  // is uniform over each warp: it serializes wgmma on a path it must treat
  // as divergent
  const int tid = threadIdx.x;
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int n_q = (Tq + kWgRows - 1) / kWgRows;  // query tiles per (b, h)
  const int n_tiles = (kv_len + kWgKeys - 1) / kWgKeys;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + s, 1);
      mbar_init(q_empty + s, kWgConsumerThreads);  // every consumer thread
    }
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kWgConsumerThreads);
      mbar_init(v_empty + s, kWgConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {  // producer: one thread issues every TMA load
#if FLASH_WG_CONSUMERS == 3
    // the launch bound allows 128 registers a thread; the producer keeps 24
    // and the consumers take 160 (two consumers fit 168 as launched)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
#endif
    if (tid == 0) {
      int kv = 0;  // K/V tiles loaded so far: the ring position
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        const int bh = w / n_q, q0 = (w - bh * n_q) * kWgRows;
        const int b = bh / H, h = bh - b * H;
        const int qs = it & 1;
        mbar_wait(q_empty + qs, ((it >> 1) & 1) ^ 1);  // first round passes
        mbar_expect_tx(q_full + qs, kWgQ);
        tma_load(q_s + qs * kWgQ, &qmap, q_full + qs, q0, h, b);
        for (int j = 0; j < n_tiles; ++j, ++kv) {
          const int s = kv % kWgStages;
          const uint32_t free_parity = ((kv / kWgStages) & 1) ^ 1;
          mbar_wait(k_empty + s, free_parity);
          mbar_expect_tx(k_full + s, kWgTile);
          tma_load(k_s + s * kWgTile, &kmap, k_full + s, j * kWgKeys, h, b);
          mbar_wait(v_empty + s, free_parity);
          mbar_expect_tx(v_full + s, kWgTile);
          tma_load(v_s + s * kWgTile, &vmap, v_full + s, j * kWgKeys, h, b);
        }
      }
    }
    return;
  }

#if FLASH_WG_CONSUMERS == 3
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;");
#endif
  const int c = wgi - 1;  // consumer c: query rows 64c .. 64c + 63
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float s_acc[64], o_acc[32];
  uint32_t p[8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) s_acc[i] = 0.f;

  if (c == kWgConsumers - 1) wg_turn_pass(c);  // consumer 0 issues first
  int kv = 0;
  for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
    const int bh = w / n_q, q0 = (w - bh * n_q) * kWgRows;
    const int b = bh / H, h = bh - b * H;
    const int qs = it & 1;
    const uint64_t dq =
        desc_sw128(q_s + qs * kWgQ + c * 64 * kWgD * 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float al0 = 0.f, al1 = 0.f;
    mbar_wait(q_full + qs, (it >> 1) & 1);

    // tile 0: scores only
    int s = kv % kWgStages;
    mbar_wait(k_full + s, (kv / kWgStages) & 1);
    wg_turn_wait(c);
    wgmma_fence();
    wg_scores(s_acc, dq, k_s + s * kWgTile);
    wgmma_commit();
    fence_regs(s_acc);
    wg_turn_pass(c);
    wgmma_wait<0>();
    fence_regs(s_acc);
    mbar_arrive(k_empty + s);
    wg_softmax(s_acc, m0, m1, l0, l1, al0, al1, 0, kv_len, scale_log2, t);
    wg_to_a(s_acc, p);

    // tile j's scores together with tile j - 1's P.V
    for (int j = 1; j < n_tiles; ++j) {
      const int sp = s;
      const uint32_t pp = ((kv + j - 1) / kWgStages) & 1;
      s = (kv + j) % kWgStages;
      wg_rescale(o_acc, al0, al1);
      mbar_wait(k_full + s, ((kv + j) / kWgStages) & 1);
      mbar_wait(v_full + sp, pp);
      wg_turn_wait(c);
      fence_regs(o_acc);
      wgmma_fence();
      wg_scores(s_acc, dq, k_s + s * kWgTile);
      wgmma_commit();
      wg_pv(o_acc, p, v_s + sp * kWgTile);
      wgmma_commit();
      fence_regs(s_acc);
      fence_regs(o_acc);
      wg_turn_pass(c);
      wgmma_wait<1>();  // S_j done; P_{j-1} V_{j-1} runs on under the softmax
      fence_regs(s_acc);
      mbar_arrive(k_empty + s);
      wg_softmax(s_acc, m0, m1, l0, l1, al0, al1, j * kWgKeys, kv_len,
                 scale_log2, t);
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(p);
      mbar_arrive(v_empty + sp);
      wg_to_a(s_acc, p);
    }
    mbar_arrive(q_empty + qs);  // every S of this item is done

    // the last tile's P.V
    wg_rescale(o_acc, al0, al1);
    mbar_wait(v_full + s, ((kv + n_tiles - 1) / kWgStages) & 1);
    wg_turn_wait(c);
    fence_regs(o_acc);
    wgmma_fence();
    wg_pv(o_acc, p, v_s + s * kWgTile);
    wgmma_commit();
    fence_regs(o_acc);
    wg_turn_pass(c);
    wgmma_wait<0>();
    fence_regs(o_acc);
    mbar_arrive(v_empty + s);
    kv += n_tiles;

    // row sums live spread over the quad
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    const int row0 = q0 + c * 64 + warp * 16 + g;
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int n = 0; n < kWgD / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (row0 < Tq)
        *reinterpret_cast<uint32_t*>(ob + row0 * os.t + d) =
            pack_bf16(o_acc[4 * n] * inv0, o_acc[4 * n + 1] * inv0);
      if (row0 + 8 < Tq)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * os.t + d) =
            pack_bf16(o_acc[4 * n + 2] * inv1, o_acc[4 * n + 3] * inv1);
    }
  }
  if (c == 0) wg_turn_wait(c);  // the last consumer's last pass: balanced
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (null if absent)
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// Whether a 4-D (D, T, H, B) TMA map can describe one bf16 tensor with
// element strides (b, h, t) and unit feature stride: a pointer on 16
// bytes, every stride a positive multiple of 16 bytes below 2^40 bytes (a
// size-1 axis's stride is never used and does not count).
bool map_fits(const void* ptr, const Strides& st, int T, int H, int B) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const long long extent[3] = {T, H, B}, elems[3] = {st.t, st.h, st.b};
  for (int i = 0; i < 3; ++i) {
    const long long e = extent[i] == 1 ? 8 : elems[i];
    if (e <= 0 || e % 8 != 0 || e >= (1ll << 39)) return false;
  }
  return true;
}

// The map of a tensor that map_fits, in boxes of `rows` rows of 64. A
// failure here is the driver's (no cuTensorMapEncodeTiled, or the encode
// refused): it is returned as an error, never taken as a layout.
cudaError_t make_map(CUtensorMap* map, const void* ptr, const Strides& st,
                     int T, int H, int B, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long extent[3] = {T, H, B}, elems[3] = {st.t, st.h, st.b};
  cuuint64_t dims[4] = {kWgD, 0, 0, 0}, strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(extent[i]);
    strides[i] = static_cast<cuuint64_t>(extent[i] == 1 ? 8 : elems[i]) * 2;
  }
  const cuuint32_t box[4] = {kWgD, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  // the driver's code, which names the same errors as the runtime's
  return res == CUDA_SUCCESS ? cudaSuccess : static_cast<cudaError_t>(res);
}

// Returns false (nothing launched) where TMA cannot describe q, k or v;
// else launches flash_wgmma_kernel, or fails in *err, and returns true.
bool launch_wgmma(const void* q, const void* k, const void* v, void* o,
                  const Strides* st, int B, int H, int Tq, int kv_len,
                  float scale, cudaStream_t stream, cudaError_t* err) {
  const long long work =
      static_cast<long long>((Tq + kWgRows - 1) / kWgRows) * B * H;
  if (!map_fits(q, st[0], Tq, H, B) || !map_fits(k, st[1], kv_len, H, B) ||
      !map_fits(v, st[2], kv_len, H, B) || work > INT32_MAX)
    return false;
  CUtensorMap qm, km, vm;
  *err = make_map(&qm, q, st[0], Tq, H, B, kWgRows);
  if (*err == cudaSuccess) *err = make_map(&km, k, st[1], kv_len, H, B, kWgKeys);
  if (*err == cudaSuccess) *err = make_map(&vm, v, st[2], kv_len, H, B, kWgKeys);
  int dev = 0, sms = 0;
  if (*err == cudaSuccess) *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess) *err = arp::allow_smem(flash_wgmma_kernel, kWgSmem);
  if (*err != cudaSuccess) return true;
  flash_wgmma_kernel<<<static_cast<int>(work < sms ? work : sms), kWgThreads,
                       kWgSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), st[3], H, Tq, kv_len,
      static_cast<int>(work), scale * 1.4426950408889634f);
  *err = cudaGetLastError();
  return true;
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
// *variant: the kernel that ran (0 f32 CUDA cores, 1 mma.sync, 2 wgmma).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int H,
                                      int Tq, int D, int kv_len, float scale,
                                      int dtype, void* stream, int* variant) {
  if (D < 1 || D > 128 || kv_len < 1 || Tq < 1) return cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == arp::kBF16 && D == kWgD &&
      launch_wgmma(q, k, v, o, st, B, H, Tq, kv_len, scale, s, &err)) {
    *variant = 2;
    return static_cast<int>(err);
  }
  // the mma.sync path loads 16 bytes of K/V rows and 4 bytes of Q/O at a
  // time: D a multiple of 16, every stride a multiple of 8 elements
  bool aligned = D % 16 == 0;
  for (int i = 0; i < 12; ++i) aligned = aligned && strides[i] % 8 == 0;
  const uintptr_t ptr_bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  aligned = aligned && ptr_bits % 16 == 0;
  *variant = dtype == arp::kBF16 && aligned ? 1 : 0;
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
