// The weight-quantized decode matmul shared by matmul_q8w.cu and
// matmul_q4w.cu: out (B, dout) f32 = bf16(x) (B, din) . W (din, dout), W int8
// per-column scaled or int4 group-scaled, on the tensor cores.
//
// Layout of the work ("swap A/B"): the mma computes out^T = W^T . x^T, so
// output columns are the M side of mma.sync.m16n8k16 (bf16 in, f32 sums) and
// the x rows its N side: B pads to a multiple of 8, not 16. A block owns
// 32 * wn output columns and every x row up to kMaxRows (a grid z row block
// only past that), so each weight byte leaves device memory once per call.
// Its warps form a wn x wk grid: warp (n, k) owns 32 columns (two m16 tiles)
// and every wk-th 16-row chunk of each stage, and keeps the sums of all its
// row tiles in registers; the wk warps of a column strip add their sums
// through shared memory at the end, in warp order.
//
// A fragment of the weight is built in registers from the bytes in shared
// memory, without a transpose: lane (g, t) of an m16n8k16 product holds, per
// register, two consecutive k of one m. With din rows on k, an int4 byte
// (din rows 2r, 2r+1 of one column) is exactly one such register, and two
// int8 bytes of adjacent rows pair up the same way. Lane g owns the four
// adjacent columns 4g..4g+3 of its warp (m16 tile 0 rows g, g+8 -> columns
// 4g, 4g+1; tile 1 -> 4g+2, 4g+3), so one 32-bit shared load of a weight row
// feeds both tiles. int8 and int4 values become bf16 exactly by placing the
// bits under a magic exponent and subtracting it: no int-to-float converts.
//
// din is walked in stages of kStageK rows through a ring of `stages` slots
// in shared memory, filled by 16-byte cp.async (zero-filled past din and
// dout) while the tensor cores work on an earlier slot; each slot holds the
// stage's weight tile and its x slice as bf16. Inputs that cp.async cannot
// take (ragged dout, unaligned pointers, f32 x, din not a multiple of 8)
// are loaded by the threads themselves into the same layout.
//
// Split-K in one launch: when the column tiles alone cannot fill the card,
// din is cut into `splits` (at most 8) slices along grid y, and the blocks
// of a tile's slices form one thread-block cluster. Each block leaves its
// sums in its own shared memory; after a cluster barrier, block r adds the
// r-th share of the tile's elements over the slices in order 0, 1, ...,
// reading the others' shared memory (DSMEM), and writes the output. No
// scratch in device memory, no atomics: two calls give the same bits.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace arp {
namespace wq {

constexpr int kStageK = 64;    // din rows per ring stage
constexpr int kChunkK = 16;    // din rows per mma
constexpr int kChunks = kStageK / kChunkK;
constexpr int kWarpCols = 32;  // output columns per warp (two m16 tiles)
constexpr int kMaxRows = 128;  // x rows per block
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int kXStride = kStageK * 2 + 16;  // bytes per bf16 x row in a slot
constexpr size_t kSmemMax = 227 * 1024;  // static + dynamic, per block
constexpr size_t kSmemRing = kSmemMax - 1024;  // most for the ring

enum Mode {
  kInt8 = 0,       // int8 weights, the column scale on the sum
  kInt4Group = 1,  // int4, each 16-row chunk's sums x bf16(group scale)
  kInt4Split = 2,  // int4, q * bf16(scale) split into bf16 hi + lo
};

struct Args {
  const void* x;
  const int8_t* w;
  const float* s;
  float* out;
  int B, din, dout, group, splits, k_per_split, stages;
  int wn, wk;  // warps along the columns (32 each) and along din
  int x_bf16;  // x dtype: 1 bf16, 0 f32
  int vec_x;   // cp.async for x: bf16, din % 8 == 0, 16-byte aligned
  int vec_w;   // cp.async for w: dout % 16 == 0, 16-byte aligned
  int vec_o;   // float4 stores: dout % 4 == 0, out 16-byte aligned
};

// weight byte rows per stage and their stride in shared memory: the pad
// makes a warp's fragment loads hit distinct banks (int8 reads rows 2t and
// 2t + 8 apart, int4 rows t and t + 4)
__host__ __device__ constexpr int w_rows(Mode m) {
  return m == kInt8 ? kStageK : kStageK / 2;
}
__host__ __device__ constexpr int w_stride(Mode m, int bn) {
  return bn + (m == kInt8 ? 16 : 32);
}
__host__ __device__ constexpr size_t slot_bytes(Mode m, int bn, int nt) {
  return (size_t)w_rows(m) * w_stride(m, bn) + (size_t)nt * 8 * kXStride;
}
// the wk - 1 sum sets of the non-first din warps, handed over at the end
__host__ __device__ constexpr size_t reduce_bytes(int wn, int wk, int nt) {
  return (size_t)(wk - 1) * wn * 32 * 8 * nt * sizeof(float);
}
// a block's finished sums, (8 nt) x (32 wn + 4) f32, read by its cluster
__host__ __device__ constexpr int part_stride(int wn) { return 32 * wn + 4; }
__host__ __device__ constexpr size_t part_bytes(int wn, int nt) {
  return (size_t)8 * nt * part_stride(wn) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n committed groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragments of two n8 tiles (x4) or one (x2) for one k16 chunk: lane l
// names row l % 8 of matrix l / 8 (tile j + l / 16, k half (l / 8) % 2)
__device__ __forceinline__ void ldsm_x4(uint32_t (&b)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&b)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// int8 byte j of wx (the weight word XOR 0x80808080, so the byte is v + 128)
// as an exact f32: 2^23 + (v + 128) under the exponent, minus 2^23 + 128
template <int J>
__device__ __forceinline__ float s8_exact(uint32_t wx) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 | J)) -
         8388736.f;
}

// two f32 holding bf16-exact values -> one bf16x2 register (lo in bits 0-15)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Byte J of a packed int4 word -> bf16x2 {low nibble, high nibble} exactly.
// lo = the word XOR 0x88888888 (each nibble q + 8), hi = lo >> 4 (each high
// nibble moved down): byte J of lo and of hi go to the two halves, the
// nibbles are masked under 0x4300 (bf16 128, unit 1) and 136 is subtracted.
template <int J>
__device__ __forceinline__ uint32_t q4_pair(uint32_t lo, uint32_t hi) {
  const uint32_t t = __byte_perm(lo, hi, (J + 4) << 8 | J);
  uint32_t bits;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"  // (t & mask) | magic
      : "=r"(bits)
      : "r"(t), "r"(0x000F000Fu), "r"(0x43004300u));
  __nv_bfloat162 v, off;
  *reinterpret_cast<uint32_t*>(&v) = bits;
  *reinterpret_cast<uint32_t*>(&off) = 0x43084308u;  // 136, 136
  v = __hsub2(v, off);
  return *reinterpret_cast<uint32_t*>(&v);
}

// signed nibble (HI: high) of byte J of a packed word
template <int J, int HI>
__device__ __forceinline__ float q4_value(uint32_t p) {
  return static_cast<float>(static_cast<int32_t>(p << (28 - 8 * J - 4 * HI)) >>
                            28);
}

// Fill one ring slot with stage k0's weight tile and x slice.
template <Mode M>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* slot,
                                           int k0, int n0, int row0,
                                           int rows, int nt) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int bn = kWarpCols * a.wn;
  constexpr int wr = w_rows(M);
  const int rs = w_stride(M, bn);
  const int r0 = M == kInt8 ? k0 : k0 / 2;  // first weight byte row
  const int nrows = M == kInt8 ? a.din : a.din / 2;
  if (a.vec_w) {
    const int lg = __ffs(2 * a.wn) - 1;  // 2 * wn 16-byte pieces a row
    for (int i = tid; i < wr << lg; i += nth) {
      const int r = i >> lg, c = (i & ((1 << lg) - 1)) * 16;
      const bool ok = r0 + r < nrows && n0 + c < a.dout;
      const int8_t* src =
          ok ? a.w + (size_t)(r0 + r) * a.dout + n0 + c : a.w;
      cp_async16(slot + r * rs + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < wr * bn; i += nth) {
      const int r = i / bn, c = i - r * bn;
      const bool ok = r0 + r < nrows && n0 + c < a.dout;
      slot[r * rs + c] =
          ok ? static_cast<unsigned char>(
                   __ldg(a.w + (size_t)(r0 + r) * a.dout + n0 + c))
             : 0;
    }
  }
  unsigned char* xs = slot + wr * rs;
  const int xrows = nt * 8;
  if (a.vec_x) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
    for (int i = tid; i < xrows * 8; i += nth) {
      const int r = i >> 3, c = (i & 7) * 8;  // 8 pieces of 8 a row
      const bool ok = r < rows && k0 + c < a.din;
      const __nv_bfloat16* src =
          ok ? x + (size_t)(row0 + r) * a.din + k0 + c : x;
      cp_async16(xs + r * kXStride + 2 * c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < xrows * kStageK; i += nth) {
      const int r = i / kStageK, c = i - r * kStageK;
      float v = 0.f;
      if (r < rows && k0 + c < a.din) {
        const size_t off = (size_t)(row0 + r) * a.din + k0 + c;
        v = a.x_bf16
                ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.x)[off])
                : static_cast<const float*>(a.x)[off];
      }
      reinterpret_cast<__nv_bfloat16*>(xs + r * kXStride)[c] =
          __float2bfloat16(v);  // round to nearest even, as torch's .bfloat16()
    }
  }
}

// the lane's four column scales of group gi, rounded to bf16 (0 past dout)
__device__ __forceinline__ void group_scales(const Args& a, int gi, int col,
                                             float (&sc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sc[j] = col + j < a.dout
                ? round_bf16(__ldg(a.s + (size_t)gi * a.dout + col + j))
                : 0.f;
}

template <Mode M, int NT>
__global__ void __launch_bounds__(kMaxWarps * 32)
wq_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bn = kWarpCols * a.wn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_n = warp % a.wn, warp_k = warp / a.wn;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * bn;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kMaxRows;
  const int rows = min(kMaxRows, a.B - row0);
  const int k_begin = split * a.k_per_split;
  const int k_end = min(a.din, k_begin + a.k_per_split);
  const int nstage = (k_end - k_begin + kStageK - 1) / kStageK;
  const int S = a.stages;
  const size_t slot = slot_bytes(M, bn, NT);
  const int rs = w_stride(M, bn);
  const int wcol = warp_n * kWarpCols + 4 * g;  // the lane's first column
  const int col = n0 + wcol;

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  int cur_group = -1;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // kInt4Group: the chunk's scales

  for (int i = 0; i < S - 1; ++i) {
    if (i < nstage)
      load_stage<M>(a, smem + i * slot, k_begin + i * kStageK, n0, row0, rows,
                    NT);
    cp_async_commit();
  }

  for (int i = 0; i < nstage; ++i) {
    cp_async_wait(S - 2);  // stage i's copies from this thread have landed
    __syncthreads();       // ... and everyone's; slot (i - 1) % S is free
    const int nxt = i + S - 1;
    if (nxt < nstage)
      load_stage<M>(a, smem + (nxt % S) * slot, k_begin + nxt * kStageK, n0,
                    row0, rows, NT);
    cp_async_commit();

    const unsigned char* ws = smem + (i % S) * slot;
    const unsigned char* xs = ws + w_rows(M) * rs;
    const int kst = k_begin + i * kStageK;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if ((c & (a.wk - 1)) != warp_k) continue;  // this warp's chunks
      if (kst + c * kChunkK >= k_end) break;
      // A fragments of both m16 tiles (hi, and lo for kInt4Split)
      uint32_t af[2][4], al[2][4];
      if (M == kInt8) {
        const unsigned char* p = ws + (c * 16 + 2 * t) * rs + wcol;
        const uint32_t w0 = lds32(p) ^ 0x80808080u;
        const uint32_t w1 = lds32(p + rs) ^ 0x80808080u;
        const uint32_t w2 = lds32(p + 8 * rs) ^ 0x80808080u;
        const uint32_t w3 = lds32(p + 9 * rs) ^ 0x80808080u;
        af[0][0] = pack_exact(s8_exact<0>(w0), s8_exact<0>(w1));
        af[0][1] = pack_exact(s8_exact<1>(w0), s8_exact<1>(w1));
        af[0][2] = pack_exact(s8_exact<0>(w2), s8_exact<0>(w3));
        af[0][3] = pack_exact(s8_exact<1>(w2), s8_exact<1>(w3));
        af[1][0] = pack_exact(s8_exact<2>(w0), s8_exact<2>(w1));
        af[1][1] = pack_exact(s8_exact<3>(w0), s8_exact<3>(w1));
        af[1][2] = pack_exact(s8_exact<2>(w2), s8_exact<2>(w3));
        af[1][3] = pack_exact(s8_exact<3>(w2), s8_exact<3>(w3));
      } else if (M == kInt4Group) {
        const unsigned char* p = ws + (c * 8 + t) * rs + wcol;
        const uint32_t l0 = lds32(p) ^ 0x88888888u, h0 = l0 >> 4;
        const uint32_t l1 = lds32(p + 4 * rs) ^ 0x88888888u, h1 = l1 >> 4;
        af[0][0] = q4_pair<0>(l0, h0);
        af[0][1] = q4_pair<1>(l0, h0);
        af[0][2] = q4_pair<0>(l1, h1);
        af[0][3] = q4_pair<1>(l1, h1);
        af[1][0] = q4_pair<2>(l0, h0);
        af[1][1] = q4_pair<3>(l0, h0);
        af[1][2] = q4_pair<2>(l1, h1);
        af[1][3] = q4_pair<3>(l1, h1);
        const int gi = (kst + c * kChunkK) / a.group;  // one group per chunk
        if (gi != cur_group) {
          cur_group = gi;
          group_scales(a, gi, col, sc);
        }
      } else {  // kInt4Split: w = q * bf16(s) per element, hi + lo
        const unsigned char* p = ws + (c * 8 + t) * rs + wcol;
        const uint32_t p0 = lds32(p), p1 = lds32(p + 4 * rs);
        const int k = kst + c * kChunkK + 2 * t;  // din rows k, k+1, k+8, k+9
        float s4[4][4];                           // [row][column]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kr = k + (r & 1) + 8 * (r >> 1);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s4[r][j] = kr < a.din && col + j < a.dout
                           ? round_bf16(__ldg(a.s + (size_t)(kr / a.group) *
                                                        a.dout + col + j))
                           : 0.f;
        }
        float wv[4][4];
#define ARP_Q4(J)                                    \
  wv[0][J] = q4_value<J, 0>(p0) * s4[0][J];          \
  wv[1][J] = q4_value<J, 1>(p0) * s4[1][J];          \
  wv[2][J] = q4_value<J, 0>(p1) * s4[2][J];          \
  wv[3][J] = q4_value<J, 1>(p1) * s4[3][J];
        ARP_Q4(0) ARP_Q4(1) ARP_Q4(2) ARP_Q4(3)
#undef ARP_Q4
        // q * bf16(s) has at most 11 significant bits: hi = bf16(w) and
        // lo = w - hi are both exact in bf16
        float hi[4][4], lo[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hi[r][j] = round_bf16(wv[r][j]);
            lo[r][j] = wv[r][j] - hi[r][j];
          }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // register e: column 2m + (e & 1), rows (0, 1) or (2, 3)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 2 * m + (e & 1), r = 2 * (e >> 1);
            af[m][e] = pack_exact(hi[r][j], hi[r + 1][j]);
            al[m][e] = pack_exact(lo[r][j], lo[r + 1][j]);
          }
        }
      }
      // B fragments two n8 tiles at a time (ldmatrix): x rows 8j + g, k 2t..
      // and 2t + 8..
      const unsigned xa =
          static_cast<unsigned>(__cvta_generic_to_shared(xs)) +
          (((lane >> 4) * 8 + (lane & 7)) * kXStride) +
          (c * 16 + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        if (j + 1 < NT)
          ldsm_x4(b, xa + j * 8 * kXStride);
        else
          ldsm_x2(b, xa + j * 8 * kXStride);
#pragma unroll
        for (int h = 0; h < 2 && j + h < NT; ++h) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            if (M == kInt4Group) {
              // the chunk's exact sums, then times the bf16 group scale
              float c4[4] = {0.f, 0.f, 0.f, 0.f};
              mma(c4, af[m], b[2 * h], b[2 * h + 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[m][j + h][e] =
                    fmaf(c4[e], sc[2 * m + (e >> 1)], acc[m][j + h][e]);
            } else {
              mma(acc[m][j + h], af[m], b[2 * h], b[2 * h + 1]);
              if (M == kInt4Split)
                mma(acc[m][j + h], al[m], b[2 * h], b[2 * h + 1]);
            }
          }
        }
      }
    }
  }

  // the din warps of a column strip add their sums in warp order
  if (a.wk > 1) {
    constexpr int per = 2 * NT * 4;  // floats per lane
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();  // the ring is free
    if (warp_k > 0) {
      float* p = red + ((warp_k - 1) * a.wn + warp_n) * per * 32 + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[((m * NT + j) * 4 + e) * 32] = acc[m][j][e];
    }
    __syncthreads();
    if (warp_k == 0) {
      for (int kw = 1; kw < a.wk; ++kw) {
        const float* p = red + ((kw - 1) * a.wn + warp_n) * per * 32 + lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][j][e] += p[((m * NT + j) * 4 + e) * 32];
      }
    }
  }

  // The lane holds rows 8j + 2t + h of its four columns: column byte 2m
  // (tile m, row g) is register 0 / 1 of acc[m][j], byte 2m + 1 (row g + 8)
  // register 2 / 3.
  if (a.splits == 1) {
    if (warp_k != 0 || col >= a.dout) return;
    float osc[4] = {1.f, 1.f, 1.f, 1.f};
    if (M == kInt8) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        osc[j] = col + j < a.dout ? __ldg(a.s + col + j) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 8 * j + 2 * t + h;
        if (r >= rows) continue;
        const float v[4] = {acc[0][j][h] * osc[0], acc[0][j][2 + h] * osc[1],
                            acc[1][j][h] * osc[2], acc[1][j][2 + h] * osc[3]};
        float* o = a.out + (size_t)(row0 + r) * a.dout + col;
        if (a.vec_o && col + 3 < a.dout) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < a.dout) o[e] = v[e];
        }
      }
    }
    return;
  }

  // split-K: leave the sums in shared memory, then add the cluster's slices
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int ps = part_stride(a.wn);
  float* part = reinterpret_cast<float*>(smem);
  __syncthreads();  // the wk hand-over is read
  if (warp_k == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = part + (8 * j + 2 * t + h) * ps + wcol;
        *reinterpret_cast<float4*>(p) = make_float4(
            acc[0][j][h], acc[0][j][2 + h], acc[1][j][h], acc[1][j][2 + h]);
      }
  }
  cluster.sync();  // every slice's sums are in place
  const int n_el = rows * bn;
  const int share = (n_el + a.splits - 1) / a.splits;
  const int e_end = min(n_el, (split + 1) * share);
  for (int e = split * share + tid; e < e_end; e += blockDim.x) {
    const int r = e / bn, cl = e - r * bn;
    if (n0 + cl >= a.dout) continue;
    float v[kMaxSplits];  // all slices' loads in flight, then the sum
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      v[sp] = sp < a.splits ? cluster.map_shared_rank(part, sp)[r * ps + cl]
                            : 0.f;
    float sum = v[0];
#pragma unroll
    for (int sp = 1; sp < kMaxSplits; ++sp)
      if (sp < a.splits) sum += v[sp];
    a.out[(size_t)(row0 + r) * a.dout + n0 + cl] =
        M == kInt8 ? sum * __ldg(a.s + n0 + cl) : sum;
  }
  cluster.sync();  // no block leaves while its sums may still be read
}

template <Mode M, int NT>
cudaError_t launch_nt(const Args& a, cudaStream_t stream) {
  auto kern = wq_kernel<M, NT>;
  const int bn = kWarpCols * a.wn;
  size_t smem = (size_t)a.stages * slot_bytes(M, bn, NT);
  const size_t red = reduce_bytes(a.wn, a.wk, NT);
  const size_t part = a.splits > 1 ? part_bytes(a.wn, NT) : 0;
  smem = smem > red ? smem : red;
  smem = smem > part ? smem : part;
  static bool opted_in = false;  // per instantiation, once
  if (!opted_in) {
    // the most dynamic shared memory beside the kernel's static bytes
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kern);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemMax - fa.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.dout + bn - 1) / bn, a.splits,
                     (a.B + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(32 * a.wn * a.wk);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = a.splits;  // a tile's slices: one cluster
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// nt n8 tiles of x rows per block
template <Mode M>
cudaError_t dispatch(const Args& a, int nt, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_nt<M, 1>(a, stream);
    case 2: return launch_nt<M, 2>(a, stream);
    case 4: return launch_nt<M, 4>(a, stream);
    case 8: return launch_nt<M, 8>(a, stream);
    case 10: return launch_nt<M, 10>(a, stream);
    case 16: return launch_nt<M, 16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the plan (ops/kernels.py::wq_plan) and fills the alignment flags;
// false when the kernel cannot take it.
inline bool prepare(Args& a, Mode m, int nt) {
  if (a.B < 1 || a.din < 1 || a.dout < 1) return false;
  if (!(nt == 1 || nt == 2 || nt == 4 || nt == 8 || nt == 10 || nt == 16))
    return false;
  if (m == kInt4Group && a.group % kChunkK != 0) return false;
  if (!(a.wn == 2 || a.wn == 4 || a.wn == 8) ||
      !(a.wk == 1 || a.wk == 2 || a.wk == 4) || a.wn * a.wk > kMaxWarps)
    return false;
  if (8 * nt < (a.B < kMaxRows ? a.B : kMaxRows)) return false;
  if (a.splits < 1 || a.splits > kMaxSplits || a.k_per_split < kStageK ||
      a.k_per_split % kStageK != 0 ||
      (long long)a.splits * a.k_per_split < a.din ||
      (long long)(a.splits - 1) * a.k_per_split >= a.din)
    return false;
  if (a.stages < 2 || a.stages > kMaxStages ||
      (size_t)a.stages * slot_bytes(m, kWarpCols * a.wn, nt) > kSmemRing ||
      reduce_bytes(a.wn, a.wk, nt) > kSmemRing ||
      part_bytes(a.wn, nt) > kSmemRing)
    return false;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(a.w);
  const uintptr_t op = reinterpret_cast<uintptr_t>(a.out);
  a.vec_x = a.x_bf16 && a.din % 8 == 0 && xp % 16 == 0;
  a.vec_w = a.dout % 16 == 0 && wp % 16 == 0;
  a.vec_o = a.dout % 4 == 0 && op % 16 == 0;
  return true;
}

}  // namespace wq
}  // namespace arp
