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
// Bound on this card: bytes (hd*Ta per (b, h), a quarter of bf16, ~8*M
// flops per byte). Design (decode_cross.cuh): the int8 kernel's, over hd/2
// byte rows that each hold two head dims; a nibble enters the integer tensor
// cores as the u8 n ^ 8 = v + 8, and the offset is taken off the exact sums.
#include "decode_cross.cuh"

// q (BH, M, hd) f32/bf16; k4, v4 (BH, hd/2, Ta) int8 half-split packed;
// ks, vs (BH, hd) f32 channel scales; out (BH, M, hd) f32. The plan
// (bulk, ldk, smem) is ops/kernels.py::cross_plan's.
extern "C" int decode_cross_q4_launch(const void* q, const void* k4,
                                      const void* v4, const void* ks,
                                      const void* vs, void* out, int BH,
                                      int M, int hd, int Ta, float scale,
                                      int bulk, int ldk, int smem,
                                      int q_dtype, void* stream) {
  return arp::xq::entry<4>(q, k4, v4, ks, vs, out, BH, M, hd, Ta, scale,
                           bulk, ldk, smem, q_dtype, stream);
}
