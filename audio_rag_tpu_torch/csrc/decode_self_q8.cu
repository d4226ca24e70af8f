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
// layer once (2*hd*Cp bytes per (b, h)) plus the packed scales, and does
// 4*M flops per cache byte. At the capacity profile's call (B*H = 320,
// hd 64, Cp 256) a (b, h) is 16 KB of K and 16 KB of V: what a block
// costs beyond its bytes (the loads' latency, its arithmetic, barriers)
// decides the time.
//
// One block of 8 warps per (b, h) (the launch plan is
// ops/kernels.py::self_plan):
// - Loads. A (b, h)'s K is hd*Cp contiguous bytes, and so is its V; any 16
//   head-dim rows (a slice) are 16*Cp contiguous bytes. Where they fit
//   (every port shape) each slice of K and of V is one bulk async copy
//   (cp.async.bulk, 1-D TMA) on its own mbarrier, all issued by thread 0
//   at the block's start right after q's loads: the products of a K slice
//   run as soon as it lands while the rest are in flight. Longer caches
//   stream stages of whole slices through two slots. Bases off 16 bytes or
//   Cp % 16 != 0 take the same kernel with each stage copied by the
//   threads into rows of a word-multiple stride: the plan decides from the
//   layout alone. The block's column of K scales, V scales and mask comes
//   by 4-byte cp.async while the slices fly.
// - Products in integers on the CUDA cores (dp4a), so no K or V value is
//   ever converted to float: q/sqrt(hd) becomes a 23-bit signed
//   fixed-point integer per query (its shift from the query's largest
//   |value|), p * vs / max|vs| one per position, each in three 8-bit
//   pieces (a signed top byte and two unsigned ones). Every sum of products
//   is exact; only the fixed points and the f32 steps round.
// - Scores. Warps take (slice, 32 four-position groups) items: a lane
//   reads its group's word in 4 rows and turns them into 4 registers of
//   one position's 4 rows by a 4x4 byte transpose (8 PRMT), then 3 dp4a a
//   position and query. At Cp 256 all 256 threads work. A slice's exact
//   sums become f32 by exact magic-number conversions; the slices' partial
//   scores (kept, for M <= 4, in the slice's own K bytes that only that
//   lane read: a region of their own made the port's call 5 % slower,
//   PERF.md section 6) are added in slice order.
// - Softmax by 4-position groups: one block max (with max |vs|) and one
//   block sum, each a warp shuffle tree and one barrier; the normaliser
//   sums the unscaled exponentials; the pieces of p * vs overwrite the
//   scores, 16 bytes a group.
// - P.V. L = 256 / hd lanes share a V row, lane k reading the row's words
//   k, k + L, ... in an order rotated by its row, so a warp's 32 loads hit
//   32 banks; 3 dp4a a word and query; the row's exact int64 sum is added
//   over its lanes by shuffles, converted once and scaled once.
// One launch per call, no scratch in device memory, no atomics: two calls
// give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;     // floats per packed scale row
constexpr int kSliceRows = 16;  // head-dim rows of a slice
constexpr int kMaxHd = 128;
constexpr int kMaxStages = 2 * kMaxHd / kSliceRows;  // mbarriers
constexpr int kPieces = 3;
constexpr int kSlack = 64;  // bytes a ragged group's words read past a slot
constexpr int kBulkMax = 1 << 20;        // an mbarrier's transaction count
constexpr size_t kSmemMax = 227 * 1024;  // static + dynamic, per block

struct Args {
  const void* q;
  const int8_t* k;
  const int8_t* v;
  const float* sc;
  float* out;
  int H, M, hd, Cp;
  float scale;
  int q_bf16;
  int bulk;    // stages by one bulk copy, else copied by the threads
  int ldk;     // a cache row's stride in shared memory
  int ldp;     // a score row's floats: ldk to a multiple of 4 * 256 / hd
  int rows;    // head-dim rows a stage holds: a multiple of 16
  int stages;  // stages of K, and of V: hd / rows
  int slots;   // stages held at once: 2 * stages (all in flight) or 2
  int smem;    // dynamic shared memory
};

// every stage in its own slot: the slices' partial scores are kept apart
__host__ __device__ constexpr bool whole(const Args& a) {
  return a.slots == 2 * a.stages;
}
// the block's shared memory: the slots and their slack; for M > 4 with
// every stage in flight the slices' partial scores; M rows of scores; M
// rows of p * vs pieces (16 bytes a group); the K scale, V scale and mask
// columns; q's pieces
__host__ __device__ constexpr int slots_bytes(const Args& a) {
  return a.slots * a.rows * a.ldk + kSlack;
}
__host__ __device__ constexpr int parts_bytes(const Args& a) {
  return whole(a) && a.M > 4 ? 4 * (a.hd / kSliceRows) * a.M * a.ldp : 0;
}
__host__ __device__ constexpr int smem_bytes(const Args& a) {
  return slots_bytes(a) + parts_bytes(a) + 8 * a.M * a.ldp + 12 * a.ldp +
         kPieces * a.M * a.hd;
}

// exact integer dot products of 4 bytes: s8 . s8 and s8 . u8
__device__ __forceinline__ int dp4a_ss(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// round(x) of |x| <= 2^22 by one FADD under the exponent of 2^23 + 2^22
__device__ __forceinline__ int round_exact(float x) {
  return __float_as_int(x + 12582912.f) - 0x4B400000;
}

// 2^e for -126 <= e <= 127, from the bits
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

// a 4-byte asynchronous copy global -> shared (cp.async), waited for with
// cp_async_wait_all by the thread that issued it
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   arp::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Compile-time phase profile (scripts/probe_self_phases.py builds with
// -DSELF_PROFILE=1): thread 0 of each block writes its SM, its start and
// end on the global timer and clock64 at each phase boundary.
#ifndef SELF_PROFILE
#define SELF_PROFILE 0
#endif
#if SELF_PROFILE
constexpr int kProfBlocks = 4096, kProfSlots = 16;
__device__ long long self_prof[kProfBlocks][kProfSlots];
__device__ __forceinline__ int block_id() {
  return blockIdx.y * gridDim.x + blockIdx.x;
}
#define SELF_MARK(i)                                            \
  if (threadIdx.x == 0 && block_id() < kProfBlocks)             \
    self_prof[block_id()][i] = clock64();
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#else
#define SELF_MARK(i)
#endif

// the f32 partial scores of one slice (16 rows at sK, head dims d0 ..)
// for the 4 positions of group g: exact dp4a sums per query and piece,
// then exact conversions (|sums| < 16 * 128 * 255 < 2^22) and one FMA chain
template <int M>
__device__ __forceinline__ void slice_scores(const unsigned char* sK,
                                             int ldk, const uint32_t* sQp,
                                             int hd4, int d0, int g,
                                             float (&out)[M][4]) {
  int acc[M][kPieces][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][p][j] = 0;
#pragma unroll
  for (int rq = 0; rq < kSliceRows / 4; ++rq) {
    uint32_t w[4], x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(sK + (4 * rq + j) * ldk +
                                                4 * g);
    arp::transpose4(w, x);
    const int dq = (d0 >> 2) + rq;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint32_t q0 = sQp[(0 * M + m) * hd4 + dq];
      const uint32_t q1 = sQp[(1 * M + m) * hd4 + dq];
      const uint32_t q2 = sQp[(2 * M + m) * hd4 + dq];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[m][0][j] = dp4a_ss(x[j], q0, acc[m][0][j]);
        acc[m][1][j] = dp4a_su(x[j], q1, acc[m][1][j]);
        acc[m][2][j] = dp4a_su(x[j], q2, acc[m][2][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[m][j] = fmaf(arp::i2f_exact(acc[m][0][j]), 65536.f,
                       fmaf(arp::i2f_exact(acc[m][1][j]), 256.f,
                            arp::i2f_exact(acc[m][2][j])));
}

// grid (H, B): block (h, b)
template <int M>
__global__ void __launch_bounds__(kThreads) self_q8_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[3][kWarps][M];  // the warps' maxima, max |vs|, sums
  __shared__ float inv_s[M];           // 2^-shift of each query's pieces
  __shared__ __align__(8) uint64_t bars[kMaxStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, bh = b * a.H + h;
  const int hd = a.hd, Cp = a.Cp, ldk = a.ldk, ldp = a.ldp, R = a.rows,
            T = a.stages;
  const bool ring = !whole(a);  // stages reuse two slots
#if SELF_PROFILE
  if (tid == 0 && block_id() < kProfBlocks) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    self_prof[block_id()][13] = smid;
    self_prof[block_id()][14] = global_ns();
  }
#endif
  SELF_MARK(0)
  const int slot = R * ldk;  // a slot's bytes: consecutive slots' rows follow
  float* sParts = reinterpret_cast<float*>(smem + slots_bytes(a));
  float* sS = sParts + parts_bytes(a) / 4;  // [m][ldp]
  unsigned char* sPc = reinterpret_cast<unsigned char*>(sS + M * ldp);
  float* sKs = sS + 2 * M * ldp;
  float* sVs = sKs + ldp;
  float* sMask = sVs + ldp;
  uint32_t* sQp = reinterpret_cast<uint32_t*>(sMask + ldp);  // [p][m][hd/4]
  const int8_t* gK = a.k + (size_t)bh * hd * Cp;
  const int8_t* gV = a.v + (size_t)bh * hd * Cp;
  const int lg_hd = __ffs(hd) - 1;  // hd is a power of 2

  // stage j < 2T: head-dim rows [R i, R i + R) of K (j = i) or of V (j =
  // T + i), R * Cp contiguous bytes, in slot j (all in flight) or j & 1
  auto slot_of = [&](int j) { return ring ? (j & 1) : j; };
  auto issue = [&](int j, int i, const int8_t* g) {  // bulk path, thread 0
    const int s = slot_of(j);
    arp::bulk_load(smem + s * slot, g + (size_t)R * i * Cp, R * Cp,
                   &bars[s]);
  };

  // q first: warp m loads query m (lanes over head dims)
  float qv[kMaxHd / 32];
  if (warp < M) {
#pragma unroll
    for (int u = 0; u < kMaxHd / 32; ++u) {
      const int d = lane + 32 * u;
      float x = 0.f;
      if (d < hd) {
        const size_t off = ((size_t)bh * M + warp) * hd + d;
        x = a.q_bf16
                ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                : static_cast<const float*>(a.q)[off];
      }
      qv[u] = x * a.scale;
    }
  }
  // K's first stages now; V's, where all are in flight, once q has landed,
  // so that what the scores need first does not queue behind them
  if (a.bulk && tid == 0) {
    for (int s = 0; s < a.slots; ++s) arp::mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < (ring ? 2 : T); ++j) issue(j, j, gK);
  }
  // the block's columns by asynchronous copies; zeros past Cp
  const float* S = a.sc + (size_t)b * Cp * kLanes;
  for (int t = tid; t < ldp; t += kThreads) {
    if (t < Cp) {
      const float* row = S + (size_t)t * kLanes;
      cp_async4(sKs + t, row + h);
      cp_async4(sVs + t, row + a.H + h);
      cp_async4(sMask + t, row + 2 * a.H);
    } else {
      sKs[t] = sVs[t] = sMask[t] = 0.f;
    }
  }
  // q's pieces: qi = round(q * 2^sh), the largest |qi| in [2^21, 2^22)
  if (warp < M) {
    float amax = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxHd / 32; ++u) amax = fmaxf(amax, fabsf(qv[u]));
    amax = arp::warp_max(amax);
    const int ex = ((__float_as_int(amax) >> 23) & 255) - 127;
    const int sh = amax > 0.f ? min(126, 21 - ex) : 0;
    unsigned char* qp = reinterpret_cast<unsigned char*>(sQp);
#pragma unroll
    for (int u = 0; u < kMaxHd / 32; ++u) {
      const int d = lane + 32 * u;
      if (d < hd) {
        const int qi = round_exact(qv[u] * pow2(sh));
        qp[(0 * M + warp) * hd + d] = static_cast<unsigned char>(qi >> 16);
        qp[(1 * M + warp) * hd + d] = static_cast<unsigned char>(qi >> 8);
        qp[(2 * M + warp) * hd + d] = static_cast<unsigned char>(qi);
      }
    }
    if (lane == 0) inv_s[warp] = pow2(-sh);
  }
  __syncthreads();  // q's pieces and the barriers' init in place
  if (a.bulk && tid == 0 && !ring)
    for (int j = T; j < 2 * T; ++j) issue(j, j - T, gV);
  SELF_MARK(1)

  // the threads' copy of stage j (K or V stage i of g) into rows of
  // stride ldk, zero past Cp: every thread calls it
  auto copy_stage = [&](int j, int i, const int8_t* g) {
    const int8_t* src = g + (size_t)R * i * Cp;
    unsigned char* dst = smem + slot_of(j) * slot;
    for (int r = 0; r < R; ++r)
      for (int t = tid; t < ldk; t += kThreads)
        dst[r * ldk + t] = t < Cp ? __ldg(src + (size_t)r * Cp + t) : 0;
    __syncthreads();
  };
  // stage j in shared memory: its bulk copy waited for, or (a ring without
  // bulk copies) copied by every thread
  auto acquire = [&](int j, int i, const int8_t* g) {
    const int s = slot_of(j);
    if (a.bulk)
      arp::mbar_wait(&bars[s], ring ? (j >> 1) & 1 : 0);
    else if (ring)
      copy_stage(j, i, g);
    return static_cast<const unsigned char*>(smem + s * slot);
  };
  auto release = [&](int j, int next_i, const int8_t* next_g) {
    if (!ring) return;  // every stage has its own slot
    __syncthreads();    // slot j & 1 is read: its next stage
    if (a.bulk && tid == 0 && j + 2 < 2 * T) issue(j + 2, next_i, next_g);
  };
  if (!ring && !a.bulk)  // the threads' copies of every stage, at once
    for (int j = 0; j < 2 * T; ++j)
      copy_stage(j, j < T ? j : j - T, j < T ? gK : gV);

  // ---- scores: partial sums of every slice ------------------------------
  const int groups = ldp >> 2;  // four-position groups of a score row
  const int kgroups = ldk >> 2;  // the groups with cache bytes
  const int hd4 = hd >> 2;
  // slice s's partial score of query m at position 4 g + j
  auto part_at = [&](int s, int m, int g, int j) -> float* {
    if (M <= 4)  // in the slice's own K bytes that only group g's lane read
      return reinterpret_cast<float*>(smem + s * slot + (4 * m + j) * ldk +
                                      4 * g);
    return sParts + (s * M + m) * ldp + 4 * g + j;
  };
  if (!ring) {
    // (slice, 32 groups) items, slice s as soon as it lands
    const int blocks32 = (kgroups + 31) >> 5;
    int s = 0, blk = warp;
    while (blk >= blocks32) blk -= blocks32, ++s;
    for (; s < T; blk += kWarps) {
      while (blk >= blocks32) blk -= blocks32, ++s;
      if (s >= T) break;
      const unsigned char* sK = acquire(s, s, gK);
      const int g = blk * 32 + lane;
      if (g < kgroups) {
        float part[M][4];
        slice_scores<M>(sK, ldk, sQp, hd4, kSliceRows * s, g, part);
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) *part_at(s, m, g, j) = part[m][j];
      }
    }
  } else {
    // stage by stage, each thread owning groups tid, tid + 256, ...
    for (int i = 0; i < T; ++i) {
      const unsigned char* sK = acquire(i, i, gK);
      for (int g = tid; g < kgroups; g += kThreads) {
        float sum[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum[m][j] = i > 0 ? sS[m * ldp + 4 * g + j] : 0.f;
        for (int r = 0; r < R; r += kSliceRows) {
          float part[M][4];
          slice_scores<M>(sK + r * ldk, ldk, sQp, hd4, R * i + r, g, part);
#pragma unroll
          for (int m = 0; m < M; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[m][j] += part[m][j];
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
          *reinterpret_cast<float4*>(sS + m * ldp + 4 * g) =
              make_float4(sum[m][0], sum[m][1], sum[m][2], sum[m][3]);
      }
      release(i, i + 2 < T ? i + 2 : i + 2 - T, i + 2 < T ? gK : gV);
    }
  }
  cp_async_wait_all();  // this thread's column entries
  __syncthreads();      // every partial score and column entry in place
  SELF_MARK(2)

  // ---- the scores of position t of row m, their max and max |vs| -------
  float mx[M], vmax = 0.f;
  for (int t = tid; t < ldp; t += kThreads) vmax = fmaxf(vmax, fabsf(sVs[t]));
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mx[m] = -INFINITY;
    for (int t = tid; t < Cp; t += kThreads) {
      const int g = t >> 2, j = t & 3;
      float sc;
      if (ring) {
        sc = sS[m * ldp + t];
      } else {
        sc = *part_at(0, m, g, j);
        for (int u = 1; u < T; ++u) sc += *part_at(u, m, g, j);
      }
      sc = sc * inv_s[m] * sKs[t] + sMask[t];
      sS[m * ldp + t] = sc;
      mx[m] = fmaxf(mx[m], sc);
    }
    const float w = arp::warp_max(mx[m]);
    if (lane == 0) red[0][warp][m] = w;
  }
  vmax = arp::warp_max(vmax);
  if (lane == 0) red[1][warp][0] = vmax;
  __syncthreads();
  vmax = red[1][0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) vmax = fmaxf(vmax, red[1][w][0]);
  const float to_fixed = vmax > 0.f ? 4194304.f / vmax : 0.f;  // 2^22 / max

  // ---- exponentials, their sum, and round(p * vs * 2^22 / max|vs|) in
  // three pieces: byte j of piece word p of group g at 16 g + 4 p + j -----
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float v = red[0][0][m];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[0][w][m]);
    float ls = 0.f;
    unsigned char* pc = sPc + 4 * m * ldp;
    for (int t = tid; t < ldp; t += kThreads) {
      int pi = 0;
      if (t < Cp) {
        const float e = expf(sS[m * ldp + t] - v);
        ls += e;
        pi = round_exact(e * sVs[t] * to_fixed);
      }
      unsigned char* cell = pc + 16 * (t >> 2) + (t & 3);
      cell[0] = static_cast<unsigned char>(pi >> 16);
      cell[4] = static_cast<unsigned char>(pi >> 8);
      cell[8] = static_cast<unsigned char>(pi);
    }
    const float w = arp::warp_sum(ls);
    if (lane == 0) red[2][warp][m] = w;
  }
  __syncthreads();  // the pieces and the warps' sums in place
  SELF_MARK(3)
  // out = sum p pieces * v * max|vs| / (2^22 * sum of exponentials)
  double scale_out[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float sum = red[2][0][m];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += red[2][w][m];
    scale_out[m] = static_cast<double>(vmax) / (4194304.0 * sum);
  }

  // ---- P.V: L = 256 / hd lanes per row, a warp's 32 / L rows within one
  // stage; lane k of row r reads the words k + L ((u + r) mod n), u < n --
  const int lg_l = 8 - lg_hd, L = 1 << lg_l;
  const int r = lane >> lg_l, k = lane & (L - 1);
  const int d = (warp << (5 - lg_l)) + r;  // this lane's row of V
  const int n = groups >> lg_l;
  int vi = 0;  // the stage of row d
  while (d >= R * (vi + 1)) ++vi;
  auto pv = [&](const unsigned char* row) {
    int acc[M][kPieces];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int p = 0; p < kPieces; ++p) acc[m][p] = 0;
    int u = r;
    while (u >= n) u -= n;
    for (int it = 0; it < n; ++it) {
      const int c = k + (u << lg_l);
      const uint32_t vw = *reinterpret_cast<const uint32_t*>(row + 4 * c);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const uint4 pc =
            *reinterpret_cast<const uint4*>(sPc + 4 * (m * ldp + 4 * c));
        acc[m][0] = dp4a_ss(vw, pc.x, acc[m][0]);
        acc[m][1] = dp4a_su(vw, pc.y, acc[m][1]);
        acc[m][2] = dp4a_su(vw, pc.z, acc[m][2]);
      }
      u = u + 1 == n ? 0 : u + 1;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      long long tot = (long long)acc[m][0] * 65536 +
                      (long long)acc[m][1] * 256 + acc[m][2];
      for (int o = 1; o < L; o <<= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, o);
      if (k == 0)
        a.out[((size_t)bh * M + m) * hd + d] =
            static_cast<float>(static_cast<double>(tot) * scale_out[m]);
    }
  };
  if (ring) {
    for (int i = 0; i < T; ++i) {
      const unsigned char* sV = acquire(T + i, i, gV);
      if (i == vi) pv(sV + (d - R * i) * ldk);
      release(T + i, i + 2, gV);
    }
  } else {
    pv(acquire(T + vi, vi, gV) + (d - R * vi) * ldk);
  }
  SELF_MARK(4)
#if SELF_PROFILE
  if (tid == 0 && block_id() < kProfBlocks)
    self_prof[block_id()][15] = global_ns();
#endif
}

// Checks the plan (ops/kernels.py::self_plan) against the shapes and the
// pointers; false when the kernel cannot take it.
bool prepare(const Args& a) {
  if (a.H < 1 || 2 * a.H >= kLanes || a.M < 1 || a.M > 8 ||
      !(a.hd == 16 || a.hd == 32 || a.hd == 64 || a.hd == 128) ||
      a.Cp < 1 || a.rows < kSliceRows || a.rows % kSliceRows ||
      a.hd % a.rows || a.stages != a.hd / a.rows ||
      !(a.slots == 2 || a.slots == 2 * a.stages) ||
      (whole(a) && a.rows != kSliceRows) || a.ldp < a.ldk ||
      a.ldp % (4 * kThreads / a.hd) || a.ldp - a.ldk > kSlack)
    return false;
  if (a.bulk) {
    if (a.Cp % 16 != 0 || a.ldk != a.Cp || a.rows * a.Cp >= kBulkMax ||
        reinterpret_cast<uintptr_t>(a.k) % 16 ||
        reinterpret_cast<uintptr_t>(a.v) % 16)
      return false;
  } else if (a.ldk != (a.Cp + 3) / 4 * 4) {
    return false;
  }
  return a.smem == smem_bytes(a);
}

template <int M>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = self_q8_kernel<M>;
  static int dyn_max = -1;  // per instantiation, once
  if (dyn_max < 0) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err != cudaSuccess) return err;
    const int most = static_cast<int>(kSmemMax - fa.sharedSizeBytes);
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    dyn_max = most;
  }
  if (a.smem > dyn_max) return cudaErrorInvalidValue;
  kern<<<dim3(a.H, B), kThreads, a.smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B*H, M, hd) f32/bf16; k8, v8 (B*H, hd, Cp) int8; sc (B, Cp, 128) f32
// packed scales and mask; out (B*H, M, hd) f32. 2*H < 128. The plan (bulk,
// ldk, ldp, rows, slots, smem) is ops/kernels.py::self_plan's.
extern "C" int decode_self_q8_launch(const void* q, const void* k8,
                                     const void* v8, const void* sc,
                                     void* out, int B, int H, int M, int hd,
                                     int Cp, float scale, int bulk, int ldk,
                                     int ldp, int rows, int slots, int smem,
                                     int q_dtype, void* stream) {
  if (q_dtype != arp::kF32 && q_dtype != arp::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = static_cast<const int8_t*>(k8);
  a.v = static_cast<const int8_t*>(v8);
  a.sc = static_cast<const float*>(sc);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.M = M;
  a.hd = hd;
  a.Cp = Cp;
  a.scale = scale;
  a.q_bf16 = q_dtype == arp::kBF16;
  a.bulk = bulk;
  a.ldk = ldk;
  a.ldp = ldp;
  a.rows = rows;
  a.stages = rows > 0 ? hd / rows : 0;
  a.slots = slots;
  a.smem = smem;
  if (B < 1 || B > 65535 || !prepare(a))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return static_cast<int>(launch<1>(a, B, st));
    case 2: return static_cast<int>(launch<2>(a, B, st));
    case 3: return static_cast<int>(launch<3>(a, B, st));
    case 4: return static_cast<int>(launch<4>(a, B, st));
    case 5: return static_cast<int>(launch<5>(a, B, st));
    case 6: return static_cast<int>(launch<6>(a, B, st));
    case 7: return static_cast<int>(launch<7>(a, B, st));
    case 8: return static_cast<int>(launch<8>(a, B, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#if SELF_PROFILE
// the phase profile of the last launch's first blocks, into host memory
extern "C" int decode_self_profile(void* dst, int blocks) {
  const int n = blocks < kProfBlocks ? blocks : kProfBlocks;
  return static_cast<int>(cudaMemcpyFromSymbol(
      dst, self_prof, sizeof(long long) * kProfSlots * n));
}
// blocks an SM holds at once of the M = 1 kernel with `smem` bytes
extern "C" int decode_self_occupancy(int smem, int* blocks_per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, self_q8_kernel<1>, kThreads, smem));
}
#endif
