// Beam-search reorder of the two self-attention caches:
// out[:, n] = in[:, idx[n]] on (L, N, H, C, hd) K and V, N = B*K beam rows.
//
// Replaces: audio_rag_tpu/ops/pallas_kernels.py::beam_reorder_kv (:572-642,
// body _beam_reorder_kernel :545-568), called from
// models/whisper.py::beam_decode under BEAM_REORDER=kernel after every beam
// step. Same function: a pure permutation of rows with repeats (a source
// beam may fan out to several destinations); bits are copied, nothing is
// computed, so the result equals torch's index_select exactly.
//
// Bound on this card: bytes. Each call writes every destination slab of
// both caches once and needs to read each distinct source slab once:
// 2 * L*(N + U)*H*C*hd elements for U distinct entries of idx. At large-v3
// with window batch 16 x beam 5 and the full 228-position decode budget,
// (32, 80, 20, 228, 64) bf16, a permutation (U = N) moves 5.977 GB, 1.784
// ms at 3.35 TB/s; a beam step's index repeats sources (U is about 54 of
// 80 when each beam draws uniformly from its group), about 1.50 ms. This
// kernel reads a repeated source once per destination and relies on L2
// (rows of a group are neighbouring blocks) for the repeats.
//
// Design: the (l, n) slab of one cache, H*C*hd contiguous elements, is the
// unit the permutation moves. Grid x walks (cache, l, n), grid y cuts each
// slab into 64 KB chunks so that even a few long slabs (the beam-outermost
// (1, N, 1, M, 128) layout) fill the card. Each block reads its
// destination row's source index from device memory (no host round trip;
// the TPU kernel's scalar prefetch), then copies its chunk with 16-byte
// loads and stores, four in flight per thread before their stores. Where
// the source and destination slab starts are not both 16-byte aligned (a
// slab whose byte count is not a multiple of 16) the chunk is copied byte
// by byte; an aligned slab's last bytes past its final 16-byte word take
// the same byte loop. Offsets are 64-bit: one cache reaches 2.99 GB at
// window batch 32 x beam 5. An index outside [0, N) is not checked here
// (that would need a host sync); such a row is left unwritten rather than
// read out of bounds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 64 * 1024;  // bytes of a slab per block

__global__ void __launch_bounds__(kThreads)
beam_reorder_kernel(const uint8_t* __restrict__ k_in,
                    const uint8_t* __restrict__ v_in,
                    const long long* __restrict__ idx,
                    uint8_t* __restrict__ k_out, uint8_t* __restrict__ v_out,
                    int N, long long slab) {
  const long long row = blockIdx.x;  // (cache, l, n), n fastest
  const int cache = static_cast<int>(row & 1);
  const long long ln = row >> 1;
  const int n = static_cast<int>(ln % N);
  const long long l = ln / N;
  const long long src_n = idx[n];
  if (src_n < 0 || src_n >= N) return;

  const uint8_t* src = (cache ? v_in : k_in) + (l * N + src_n) * slab;
  uint8_t* dst = (cache ? v_out : k_out) + (l * N + n) * slab;
  const long long lo = blockIdx.y * kChunk;
  const long long hi = lo + kChunk < slab ? lo + kChunk : slab;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst))
       & 15u) == 0;
  // [lo, vhi) moves as 16-byte words, [max(lo, vhi), hi) byte by byte
  long long vhi = vec ? (slab & ~15LL) : lo;
  if (vhi > hi) vhi = hi;
  if (vhi < lo) vhi = lo;

  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const long long w_hi = vhi >> 4;
  for (long long w = (lo >> 4) + threadIdx.x; w < w_hi;
       w += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = w + static_cast<long long>(u) * kThreads;
      if (j < w_hi) r[u] = s4[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = w + static_cast<long long>(u) * kThreads;
      if (j < w_hi) d4[j] = r[u];
    }
  }
  for (long long b = vhi + threadIdx.x; b < hi; b += kThreads) dst[b] = src[b];
}

}  // namespace

// sk, sv, ko, vo: (L, N, slab_bytes) device buffers; idx (N,) int64 on the
// device. One launch moves both caches.
extern "C" int beam_reorder_launch(const void* sk, const void* sv,
                                   const void* idx, void* ko, void* vo,
                                   int L, int N, long long slab_bytes,
                                   void* stream) {
  if (L < 1 || N < 1 || slab_bytes < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = 2LL * L * N;
  const long long chunks = (slab_bytes + kChunk - 1) / kChunk;
  if (rows > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  beam_reorder_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sk), static_cast<const uint8_t*>(sv),
      static_cast<const long long*>(idx), static_cast<uint8_t*>(ko),
      static_cast<uint8_t*>(vo), N, slab_bytes);
  return static_cast<int>(cudaGetLastError());
}
