// The M-query decode cross-attention shared by decode_cross_q8.cu and
// decode_cross_q4.cu: out (BH, M, hd) f32 = softmax(q.K / sqrt(hd)) . V, with
// K and V quantized and stored transposed, `rows` byte rows of Ta keys per
// (b, h): int8 (rows = hd, per-(b, h) scales) or int4 in half-split order
// (rows = hd / 2, byte row r holding dims r and r + hd/2 in its low and high
// nibble, per-channel scales). The K scales and 1/sqrt(hd) fold into q, the V
// scales multiply the output, and the int values enter the products as read.
//
// Bound on this card: bytes. A decode step reads every cross K/V byte once
// per layer and does 4*M flops per byte (int8), far below what the tensor
// cores could take; the time is the K/V read and its latency.
//
// One block of 8 warps per (b, h). K, then V, stream through a two-slot ring
// in shared memory in stages of 16 byte rows, every key (the launch plan is
// ops/kernels.py::cross_plan).
// - Loads. A (b, h)'s byte row r starts at byte r*Ta, 16-byte aligned only
//   on every fourth row at Ta = 1500 (1500 = 12 mod 16), so no split along
//   Ta can feed 16-byte or bulk copies row by row. Any 16 rows, though, are
//   16*Ta contiguous bytes, a multiple of 16 for every Ta: each stage is
//   one bulk async copy (cp.async.bulk, 1-D TMA) against an mbarrier, and
//   the next stage is in flight while the warps work on this one. Its rows
//   are read as 4-byte words, so that path also needs Ta % 4 == 0; bases
//   off 16 bytes or other Ta take the same kernel with each stage copied by
//   the threads (4-byte words where aligned, bytes otherwise) into rows of
//   a word-multiple stride: the plan decides from the layout alone. (Other
//   layouts were measured on the H100 and dropped, PERF.md §6: a cluster
//   per (b, h) splitting the rows lost its time to distributed shared
//   memory, and so did a cluster of two adding its partial scores once;
//   one bulk copy per 16-byte-widened row range of a key split ran at ~90
//   cycles a copy per SM; 16-byte cp.async pieces of it spent as long
//   issuing as computing.)
// - Products, on the tensor cores in integers, so no K or V value is ever
//   converted to float: mma.sync m16n8k16 / m16n8k32 with s8/u8 operands and
//   s32 sums, the <= 8 queries on N = 8. q (with its K scale and 1/sqrt(hd))
//   becomes a 24-bit fixed-point integer per query, its shift taken from
//   the query's largest |value| (the max within [2^22, 2^23)), cut into
//   three 8-bit pieces (a signed top byte and two unsigned ones); each piece
//   is one mma, and the sums are exact. An int4 nibble n enters as the u8
//   n ^ 8 = v + 8 (one LOP3 per four values); the offset, 8 * sum_d q piece,
//   is taken off exactly by starting the sums at its negative.
// - Pass 1, K: keys on the mma's M side, warp w taking the 32-key chunks
//   w, w + 8, ... of a stage. The A fragment wants four head dims of one
//   key per register; a K row holds four keys of one dim per word, so a 4x4
//   byte transpose (8 PRMT per 16 bytes) turns one into the other. Each
//   stage's exact partial sums become f32 by exact magic-number conversions
//   and are added into the block's scores, kept in shared memory.
// - Softmax: p = exp2((s - max) * log2(e) / 2^shift) in [0, 1], for the M
//   real queries only, as the 23-bit fixed point round(p * 2^23) (the
//   mantissa of p + 1, exactly) in three u8 pieces written over the scores,
//   and their exact integer sums.
// - Pass 2, V: stage u's 16 V rows are m tile u, the A operand of m16n8k32
//   exactly as they lie (4 keys per word), the p pieces the B operand; every
//   warp keeps exact int32 sums over its chunks, and the warps' int64 totals
//   are added in shared memory in warp order: out = sum p*v / sum p * vs,
//   rounded once to f32 each.
// One launch per call, no scratch in device memory, no atomics on values:
// two calls give the same bits.
#pragma once

#include "common.cuh"

namespace arp {
namespace xq {

constexpr int kKeys = 32;        // keys per chunk: a warp's unit of work
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxM = 8;         // queries per row: the mma's N
constexpr int kMaxHd = 128;
constexpr int kPieces = 3;       // 8-bit pieces of q and of p
constexpr int kStages = 2;       // the ring's slots
constexpr int kBulkMax = 1 << 20;  // an mbarrier's transaction count
constexpr size_t kSmemMax = 227 * 1024;  // static + dynamic, per block

struct Args {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  float* out;
  int BH, M, hd, Ta;
  float scale;
  int q_bf16;
  int bulk;     // stages by one bulk copy, else copied by the threads
  int ldk;      // a stage's row stride: Ta (bulk), else Ta to a word
  int slot;     // bytes of a ring slot: 16 rows and 32 bytes of slack
  int chunks;   // 32-key chunks over Ta
  int groups;   // 4-key groups a query row of scores holds: 8 chunks, to 32
  int smem;     // dynamic shared memory
};

// the 16-row m tiles of a (b, h)'s byte rows
__host__ __device__ constexpr int tiles(int bits, int hd) {
  return (bits == 8 ? hd : hd / 2) / 16;
}
// a ring slot: 16 rows of ldk bytes and slack for the last chunk's reads
__host__ __device__ constexpr int slot_bytes(int ldk) {
  return (16 * ldk + 32 + 15) / 16 * 16;
}
// the warps' int64 P.V sums: every m tile half, 4 registers, 32 lanes
__host__ __device__ constexpr int reduce_bytes(int bits, int hd) {
  return kWarps * tiles(bits, hd) * (bits == 4 ? 2 : 1) * 4 * 32 * 8;
}
// the ring, which also takes the warps' P.V sums at the end
__host__ __device__ constexpr int ring_bytes(int bits, int hd, int ldk) {
  return kStages * slot_bytes(ldk) > reduce_bytes(bits, hd)
             ? kStages * slot_bytes(ldk)
             : reduce_bytes(bits, hd);
}
// the block's shared memory: the ring, then M rows of scores (p pieces)
__host__ __device__ constexpr int smem_bytes(int bits, int hd, int ldk, int M,
                                             int groups) {
  return ring_bytes(bits, hd, ldk) + 16 * M * groups;
}

// Integer mma.sync with s32 sums; A s8 or u8 (AU), B s8 or u8 (BU).
#define ARP_XQ_MMA16(NAME, AT, BT)                                        \
  __device__ __forceinline__ void NAME(int (&c)[4], uint32_t a0,          \
                                       uint32_t a1, uint32_t b) {         \
    asm("mma.sync.aligned.m16n8k16.row.col.s32." AT "." BT ".s32 "       \
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"                  \
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                  \
        : "r"(a0), "r"(a1), "r"(b));                                      \
  }
ARP_XQ_MMA16(mma16_ss, "s8", "s8")
ARP_XQ_MMA16(mma16_su, "s8", "u8")
ARP_XQ_MMA16(mma16_us, "u8", "s8")
ARP_XQ_MMA16(mma16_uu, "u8", "u8")
#undef ARP_XQ_MMA16

#define ARP_XQ_MMA32(NAME, AT)                                            \
  __device__ __forceinline__ void NAME(int (&c)[4], const uint32_t (&a)[4], \
                                       uint32_t b0, uint32_t b1) {        \
    asm("mma.sync.aligned.m16n8k32.row.col.s32." AT ".u8.s32 "           \
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"         \
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));  \
  }
ARP_XQ_MMA32(mma32_su, "s8")
ARP_XQ_MMA32(mma32_uu, "u8")
#undef ARP_XQ_MMA32

template <bool AU, bool BU>
__device__ __forceinline__ void mma16(int (&c)[4], uint32_t a0, uint32_t a1,
                                      uint32_t b) {
  if constexpr (!AU && !BU) mma16_ss(c, a0, a1, b);
  else if constexpr (!AU) mma16_su(c, a0, a1, b);
  else if constexpr (!BU) mma16_us(c, a0, a1, b);
  else mma16_uu(c, a0, a1, b);
}

// a float's bits made monotone as a signed int (atomicMax on floats)
__device__ __forceinline__ int ordered(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float unordered(int b) {
  return __int_as_float(b >= 0 ? b : b ^ 0x7FFFFFFF);
}

// the low / high nibbles of four packed int4 bytes as u8 values v + 8
__device__ __forceinline__ uint32_t lo_u8(uint32_t w) {
  return (w & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t hi_u8(uint32_t w) {
  return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Compile-time phase profile (scripts/probe_cross_phases.py builds with
// -DXQ_PROFILE=1): thread 0 of each block writes its SM, its start and end
// on the global timer, clock64 at each phase boundary and, kept in
// registers until the end, its cycles issuing, waiting and computing in the
// ring loops.
#ifndef XQ_PROFILE
#define XQ_PROFILE 0
#endif
constexpr int kProfBlocks = 4096, kProfSlots = 16;
#if XQ_PROFILE
__device__ long long xq_prof[kProfBlocks][kProfSlots];
#define XQ_MARK(i)                                              \
  if (threadIdx.x == 0 && blockIdx.x < kProfBlocks)             \
    xq_prof[blockIdx.x][i] = clock64();
#define XQ_NOW(t) const long long t = clock64();
#define XQ_ADD(acc, t0) acc += clock64() - (t0);
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define XQ_MARK(i)
#define XQ_NOW(t)
#define XQ_ADD(acc, t0)
#endif

template <int BITS, int T>
__global__ void __launch_bounds__(kThreads, 3) cross_kernel(const Args a) {
  constexpr bool kQ4 = BITS == 4;
  constexpr int kHalves = kQ4 ? 2 : 1;  // P.V: low and high dims of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) unsigned char qpc[kPieces][kMaxM][kMaxHd];
  __shared__ int corr[kPieces][kMaxM];  // int4: 8 * sum_d piece
  __shared__ float inv_s[kMaxM];        // log2(e) / 2^shift of each query
  __shared__ int maxi[kMaxM];           // the scores' max (ordered bits)
  __shared__ int lsum[kPieces][kMaxM];  // sums of the p pieces
  __shared__ long long lnum[kMaxM];     // sum of round(p * 2^23) over keys
  __shared__ __align__(8) uint64_t bars[kStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int M = a.M, hd = a.hd, Ta = a.Ta, G = a.groups, ldk = a.ldk;
#if XQ_PROFILE
  long long p_issue = 0, p_wait = 0, p_work = 0;
  if (tid == 0 && blockIdx.x < kProfBlocks) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    xq_prof[blockIdx.x][13] = smid;
    xq_prof[blockIdx.x][14] = global_ns();
  }
#endif
  XQ_MARK(0)
  // scores [m][4G keys] as f32, then in place the p pieces: per query and
  // 4-key group 16 bytes, its three piece words in the first 12
  float* sS = reinterpret_cast<float*>(smem + ring_bytes(BITS, hd, ldk));
  const int8_t* gK = a.k + (size_t)bh * 16 * T * Ta;
  const int8_t* gV = a.v + (size_t)bh * 16 * T * Ta;

  // q first: its loads queue behind none of this block's copies
  float qv[kMaxHd / 32];
  if (warp < M) {
#pragma unroll
    for (int i = 0; i < kMaxHd / 32; ++i) {
      const int d = lane + 32 * i;
      float x = 0.f;
      if (d < hd) {
        const size_t off = ((size_t)bh * M + warp) * hd + d;
        const float qf =
            a.q_bf16
                ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                : static_cast<const float*>(a.q)[off];
        x = kQ4 ? qf * (a.scale * a.ks[(size_t)bh * hd + d])
                : qf * (a.ks[bh] * a.scale);
      }
      qv[i] = x;
    }
  }

  // stage j: byte rows [16 j, 16 j + 16) of K (j < T) or of V (then rows
  // 16 (j - T) ...), every key, into slot j % kStages. 16 rows are 16 Ta
  // contiguous bytes, a multiple of 16: one bulk copy. Other layouts are
  // copied by the threads into rows of stride ldk when the stage is needed.
  auto issue = [&](int j) {  // the bulk path, thread 0
    if (j < 2 * T) {
      const int8_t* src = (j < T ? gK : gV) + (size_t)16 * (j % T) * Ta;
      bulk_load(smem + (j % kStages) * a.slot, src, 16 * Ta,
                &bars[j % kStages]);
    }
  };
  auto acquire = [&](int j) {
    XQ_NOW(t_wait)
    if (a.bulk) {
      mbar_wait(&bars[j % kStages], (j / kStages) & 1);
    } else {
      const int8_t* src = (j < T ? gK : gV) + (size_t)16 * (j % T) * Ta;
      unsigned char* dst = smem + (j % kStages) * a.slot;
      const bool words = Ta % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(src) % 4 == 0;
      if (words) {
        for (int i = tid; i < 4 * Ta; i += kThreads)  // 16 rows of Ta / 4
          reinterpret_cast<uint32_t*>(dst)[i] =
              __ldg(reinterpret_cast<const uint32_t*>(src) + i);
      } else {
        for (int i = tid; i < 16 * Ta; i += kThreads) {
          const int r = i / Ta;
          dst[r * ldk + i - r * Ta] = static_cast<unsigned char>(__ldg(src + i));
        }
      }
      __syncthreads();
    }
    XQ_ADD(p_wait, t_wait)
  };
  auto release = [&](int j) {  // slot j % kStages is read: its next stage
    __syncthreads();
    XQ_NOW(t_issue)
    if (a.bulk && tid == 0) issue(j + kStages);
    XQ_ADD(p_issue, t_issue)
  };
  if (a.bulk) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
      for (int j = 0; j < kStages; ++j) issue(j);
    }
  }

  // q' = q * scale * ks as 24-bit fixed point per query, in three pieces
  // (rows of queries past M stay as they are: their columns are unused)
  if (tid < kMaxM) maxi[tid] = ordered(-INFINITY);
  if (tid < kPieces * kMaxM) lsum[tid / kMaxM][tid % kMaxM] = 0;
  for (int m = warp; m < M; m += kWarps) {
    if (m != warp) {
#pragma unroll
      for (int i = 0; i < kMaxHd / 32; ++i) {
        const int d = lane + 32 * i;
        float x = 0.f;
        if (d < hd) {
          const size_t off = ((size_t)bh * M + m) * hd + d;
          const float qf =
              a.q_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(a.q)[off])
                       : static_cast<const float*>(a.q)[off];
          x = kQ4 ? qf * (a.scale * a.ks[(size_t)bh * hd + d])
                  : qf * (a.ks[bh] * a.scale);
        }
        qv[i] = x;
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxHd / 32; ++i) amax = fmaxf(amax, fabsf(qv[i]));
    amax = warp_max(amax);
    const int sh = amax > 0.f ? 22 - ilogbf(amax) : 0;  // amax in [2^22, 2^23)
    int ps[kPieces] = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < kMaxHd / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        int qi = __float2int_rn(ldexpf(qv[i], sh));
        qi = max(-8388608, min(8388607, qi));
        qpc[0][m][d] = static_cast<unsigned char>(qi >> 16);  // signed
        qpc[1][m][d] = static_cast<unsigned char>(qi >> 8);
        qpc[2][m][d] = static_cast<unsigned char>(qi);
        ps[0] += qi >> 16;
        ps[1] += (qi >> 8) & 255;
        ps[2] += qi & 255;
      }
    }
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int v = __reduce_add_sync(0xffffffffu, ps[p]);
      if (lane == 0) corr[p][m] = 8 * v;
    }
    if (lane == 0) inv_s[m] = ldexpf(1.4426950408889634f, -sh);
  }
  __syncthreads();  // q pieces, corr and shifts in place (and the barriers)
  XQ_MARK(1)

  // ---- pass 1: stage r holds K byte rows 16r ..; warp w takes chunks w,
  // w + 8, ...: the rows' partial scores added into the block's scores ----
  const int qs[2] = {2 * t, 2 * t + 1};  // the lane's query columns
  const int ql[2] = {min(qs[0], M - 1), min(qs[1], M - 1)};  // any finite row
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int r = 0; r < T; ++r) {
    acquire(r);
    XQ_NOW(t_work)
    const unsigned char* sK = smem + (r % kStages) * a.slot;
    // B: query g's pieces at the dims of byte rows 16r + 4t .. 4t + 3
    const int dl = 16 * r + 4 * t, dh = dl + hd / 2;
    uint32_t bq[kHalves][kPieces];
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      bq[0][p] = *reinterpret_cast<const uint32_t*>(&qpc[p][g][dl]);
      if (kQ4) bq[kHalves - 1][p] = *reinterpret_cast<const uint32_t*>(
          &qpc[p][g][dh]);
    }
    for (int c = warp; c < a.chunks; c += kWarps) {
      // the scores' starting sums: minus the int4 offset, in stage 0
      int acc[2][kPieces][4];
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int init = kQ4 && r == 0 ? -corr[p][ql[e & 1]] : 0;
          acc[0][p][e] = init;
          acc[1][p][e] = init;
        }
      // lane (g, t) reads rows 4t + j at keys 32c + 4g .. 32c + 4g + 3
      uint32_t w[4], x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = ld32(sK + (4 * t + j) * ldk + kKeys * c + 4 * g);
      transpose4(w, x);
      if constexpr (!kQ4) {
        mma16<false, false>(acc[0][0], x[0], x[1], bq[0][0]);
        mma16<false, true>(acc[0][1], x[0], x[1], bq[0][1]);
        mma16<false, true>(acc[0][2], x[0], x[1], bq[0][2]);
        mma16<false, false>(acc[1][0], x[2], x[3], bq[0][0]);
        mma16<false, true>(acc[1][1], x[2], x[3], bq[0][1]);
        mma16<false, true>(acc[1][2], x[2], x[3], bq[0][2]);
      } else {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[k] = lo_u8(x[k]);
          hi[k] = hi_u8(x[k]);
        }
        mma16<true, false>(acc[0][0], lo[0], lo[1], bq[0][0]);
        mma16<true, false>(acc[0][0], hi[0], hi[1], bq[kHalves - 1][0]);
        mma16<true, false>(acc[1][0], lo[2], lo[3], bq[0][0]);
        mma16<true, false>(acc[1][0], hi[2], hi[3], bq[kHalves - 1][0]);
#pragma unroll
        for (int p = 1; p < kPieces; ++p) {
          mma16<true, true>(acc[0][p], lo[0], lo[1], bq[0][p]);
          mma16<true, true>(acc[0][p], hi[0], hi[1], bq[kHalves - 1][p]);
          mma16<true, true>(acc[1][p], lo[2], lo[3], bq[0][p]);
          mma16<true, true>(acc[1][p], hi[2], hi[3], bq[kHalves - 1][p]);
        }
      }
      // key 4g + k is tile k / 2, row g + 8 (k % 2); query 2t + e is
      // register 2 (k % 2) + e: its exact partial, added in f32
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (qs[e] >= M) continue;
        float4* cell = reinterpret_cast<float4*>(sS + (size_t)qs[e] * 4 * G +
                                                 kKeys * c + 4 * g);
        float sc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int tile = k >> 1, reg = 2 * (k & 1) + e;
          sc[k] = fmaf(i2f_exact(acc[tile][0][reg]), 65536.f,
                       fmaf(i2f_exact(acc[tile][1][reg]), 256.f,
                            i2f_exact(acc[tile][2][reg])));
        }
        if (r > 0) {
          const float4 old = *cell;
          sc[0] += old.x;
          sc[1] += old.y;
          sc[2] += old.z;
          sc[3] += old.w;
        }
        if (r == T - 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (kKeys * c + 4 * g + k >= Ta) sc[k] = -INFINITY;
            mx[e] = fmaxf(mx[e], sc[k]);
          }
        }
        *cell = make_float4(sc[0], sc[1], sc[2], sc[3]);
      }
    }
    XQ_ADD(p_work, t_work)
    release(r);
  }
  // ---- the scores' max; p pieces and their exact sums, in place ----------
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
    if (g == 0 && qs[e] < M) atomicMax(&maxi[qs[e]], ordered(mx[e]));
  }
  __syncthreads();
  XQ_MARK(2)
  for (int i = tid; i < M * G; i += kThreads) {  // G % 32 == 0: m per warp
    const int m = i / G, k4 = i - m * G;
    float4* cell = reinterpret_cast<float4*>(sS) + i;
    const float4 s4 = *cell;
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
    const float mmax = unordered(maxi[m]), iv = inv_s[m];
    uint32_t pw[kPieces] = {0u, 0u, 0u};
    int ls[kPieces] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pk = 4 * k4 + k < Ta ? exp2f((sc[k] - mmax) * iv) : 0.f;
      // round(p * 2^23) in [0, 2^23]: the mantissa of p + 1
      const uint32_t f = __float_as_uint(pk + 1.f) - 0x3F800000u;
      const uint32_t b0 = f >> 16, b1 = (f >> 8) & 255u, b2 = f & 255u;
      pw[0] |= b0 << (8 * k);
      pw[1] |= b1 << (8 * k);
      pw[2] |= b2 << (8 * k);
      ls[0] += b0;
      ls[1] += b1;
      ls[2] += b2;
    }
    uint32_t* out4 = reinterpret_cast<uint32_t*>(cell);
    out4[0] = pw[0];
    out4[1] = pw[1];
    out4[2] = pw[2];
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int v = __reduce_add_sync(0xffffffffu, ls[p]);
      if (lane == 0) atomicAdd(&lsum[p][m], v);
    }
  }
  __syncthreads();
  if (tid < M)
    lnum[tid] = (long long)lsum[0][tid] * 65536 + lsum[1][tid] * 256 +
                lsum[2][tid];
  XQ_MARK(3)

  // ---- pass 2: stage T + u holds V byte rows 16u .. (m tile u); warp w
  // adds chunks w, w + 8, ... to its exact int32 P.V sums --------------------
  int acc[T][kHalves][kPieces][4];
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][h][p][e] = 0;
  const uint32_t* pcell = reinterpret_cast<const uint32_t*>(sS) +
                          4 * ((size_t)min(g, M - 1) * G + t);
#pragma unroll
  for (int u = 0; u < T; ++u) {
    acquire(T + u);
    XQ_NOW(t_work)
    const unsigned char* sV = smem + ((T + u) % kStages) * a.slot;
    for (int c = warp; c < a.chunks; c += kWarps) {
      // B: query g's pieces of keys 32c + 4t .. (+16): groups 8c + t (+4)
      uint32_t bp[kPieces][2];
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        bp[p][0] = pcell[4 * (8 * c) + p];
        bp[p][1] = pcell[4 * (8 * c + 4) + p];
      }
      // A: rows g, g + 8 at keys 32c + 4t (+16), as they lie
      const unsigned char* v0 = sV + g * ldk + kKeys * c + 4 * t;
      const unsigned char* v1 = v0 + 8 * ldk;
      const uint32_t av[4] = {ld32(v0), ld32(v1), ld32(v0 + 16),
                              ld32(v1 + 16)};
      if constexpr (!kQ4) {
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          mma32_su(acc[u][0][p], av, bp[p][0], bp[p][1]);
      } else {
        const uint32_t lo[4] = {lo_u8(av[0]), lo_u8(av[1]), lo_u8(av[2]),
                                lo_u8(av[3])};
        const uint32_t hi[4] = {hi_u8(av[0]), hi_u8(av[1]), hi_u8(av[2]),
                                hi_u8(av[3])};
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          mma32_uu(acc[u][0][p], lo, bp[p][0], bp[p][1]);
          mma32_uu(acc[u][kHalves - 1][p], hi, bp[p][0], bp[p][1]);
        }
      }
    }
    XQ_ADD(p_work, t_work)
    release(T + u);
  }
  XQ_MARK(4)

  // ---- the warps' exact sums, added in the ring in warp order ------------
  long long* red = reinterpret_cast<long long*>(smem);  // [u h e][warp][lane]
  constexpr int kRegs = T * kHalves * 4;
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(((u * kHalves + h) * 4 + e) * kWarps + warp) * 32 + lane] =
            (long long)acc[u][h][0][e] * 65536 +
            (long long)acc[u][h][1][e] * 256 + acc[u][h][2][e];
  __syncthreads();
  for (int i = tid; i < kRegs * 32; i += kThreads) {
    // register e of tile half (u, h), lane ln: byte row g + 8 (e / 2),
    // query 2t + e % 2
    const int ln = i & 31, e = (i >> 5) & 3, uh = i >> 7;
    const int m = 2 * (ln & 3) + (e & 1);
    if (m >= M) continue;
    long long n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += red[((i >> 5) * kWarps + w) * 32 + ln];
    if (kQ4) n -= 8 * lnum[m];  // the u8 offset of every V nibble
    const int d = 16 * (uh / kHalves) + (ln >> 2) + 8 * (e >> 1) +
                  (uh % kHalves) * (hd / 2);
    const float vsc = kQ4 ? a.vs[(size_t)bh * hd + d] : a.vs[bh];
    a.out[((size_t)bh * M + m) * hd + d] =
        static_cast<float>(n) / static_cast<float>(lnum[m]) * vsc;
  }
  XQ_MARK(5)
#if XQ_PROFILE
  if (tid == 0 && blockIdx.x < kProfBlocks) {
    xq_prof[blockIdx.x][8] = p_issue;
    xq_prof[blockIdx.x][9] = p_wait;
    xq_prof[blockIdx.x][10] = p_work;
    xq_prof[blockIdx.x][15] = global_ns();
  }
#endif
}

// Checks the plan (ops/kernels.py::cross_plan) against the shapes and the
// pointers; false when the kernel cannot take it.
inline bool prepare(Args& a, int bits) {
  if (a.BH < 1 || a.M < 1 || a.M > kMaxM || a.Ta < 1 || a.hd < 1 ||
      a.hd > kMaxHd || (bits == 4 && a.hd % 2 != 0))
    return false;
  const int T = tiles(bits, a.hd);
  if (!(T == 1 || T == 2 || T == 4 || T == 8) ||
      16 * T != (bits == 8 ? a.hd : a.hd / 2))
    return false;
  a.chunks = (a.Ta + kKeys - 1) / kKeys;
  a.groups = (8 * a.chunks + 31) / 32 * 32;
  if (a.bulk) {
    if (a.Ta % 4 != 0 || a.ldk != a.Ta || 16 * a.Ta >= kBulkMax ||
        reinterpret_cast<uintptr_t>(a.k) % 16 ||
        reinterpret_cast<uintptr_t>(a.v) % 16)
      return false;
  } else if (a.ldk != (a.Ta + 3) / 4 * 4) {
    return false;
  }
  a.slot = slot_bytes(a.ldk);
  return a.smem == smem_bytes(bits, a.hd, a.ldk, a.M, a.groups);
}

// static: the cached limit below stays this library's own where two builds
// of the header share a process (a function-local static of a function
// with external linkage is one object process-wide)
template <int BITS, int T>
static cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kern = cross_kernel<BITS, T>;
  static int dyn_max = -1;  // per instantiation, once
  if (dyn_max < 0) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    const int most = static_cast<int>(kSmemMax - fa.sharedSizeBytes);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)  // room for three blocks an SM
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    dyn_max = most;
  }
  if (a.smem > dyn_max) return cudaErrorInvalidValue;
  kern<<<a.BH, kThreads, a.smem, stream>>>(a);
  return cudaGetLastError();
}

// the byte rows' m tiles, a compile-time count
template <int BITS>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  switch (tiles(BITS, a.hd)) {
    case 1: return launch<BITS, 1>(a, stream);
    case 2: return launch<BITS, 2>(a, stream);
    case 4: return launch<BITS, 4>(a, stream);
    case 8: return launch<BITS, 8>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The C entries' shared body: q (BH, M, hd) f32/bf16; k, v (BH, rows, Ta)
// int8; ks, vs per (b, h) (int8) or (BH, hd) (int4) f32; out (BH, M, hd)
// f32. The plan (bulk, ldk, smem) is ops/kernels.py::cross_plan's.
template <int BITS>
int entry(const void* q, const void* k, const void* v, const void* ks,
          const void* vs, void* out, int BH, int M, int hd, int Ta,
          float scale, int bulk, int ldk, int smem, int q_dtype,
          void* stream) {
  if (q_dtype != kF32 && q_dtype != kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = static_cast<float*>(out);
  a.BH = BH;
  a.M = M;
  a.hd = hd;
  a.Ta = Ta;
  a.scale = scale;
  a.q_bf16 = q_dtype == kBF16;
  a.bulk = bulk;
  a.ldk = ldk;
  a.smem = smem;
  if (!prepare(a, BITS)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch<BITS>(a, static_cast<cudaStream_t>(stream)));
}

}  // namespace xq
}  // namespace arp

#if XQ_PROFILE
// the phase profile of the last launch's first blocks, into host memory
extern "C" int decode_cross_profile(void* dst, int blocks) {
  const int n = blocks < arp::xq::kProfBlocks ? blocks : arp::xq::kProfBlocks;
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, arp::xq::xq_prof, sizeof(long long) * arp::xq::kProfSlots * n));
}
// blocks an SM holds at once of the kernel at hd = 64
extern "C" int decode_cross_occupancy(int bits, int smem, int* blocks_per_sm) {
  using arp::xq::cross_kernel;
  const void* kern = bits == 8
                         ? reinterpret_cast<const void*>(cross_kernel<8, 4>)
                         : reinterpret_cast<const void*>(cross_kernel<4, 2>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kern, arp::xq::kThreads, smem));
}
#endif
