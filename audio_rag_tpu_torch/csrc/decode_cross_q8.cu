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
// Bound on this card: bytes (2*hd*Ta per (b, h), ~4*M flops per byte).
// Design (decode_cross.cuh): one block per (b, h) streaming K, then V, in
// stages of 16 rows, each one bulk async copy of 16*Ta contiguous bytes;
// integer tensor-core products (int8 K and V as read, q and the
// probabilities in three 8-bit pieces); the scores kept in shared memory
// between the two passes, the P.V sums exact.
#include "decode_cross.cuh"

// q (BH, M, hd) f32/bf16; k8, v8 (BH, hd, Ta) int8; ks, vs (BH,) f32;
// out (BH, M, hd) f32. The plan (bulk, ldk, smem) is
// ops/kernels.py::cross_plan's.
extern "C" int decode_cross_q8_launch(const void* q, const void* k8,
                                      const void* v8, const void* ks,
                                      const void* vs, void* out, int BH,
                                      int M, int hd, int Ta, float scale,
                                      int bulk, int ldk, int smem,
                                      int q_dtype, void* stream) {
  return arp::xq::entry<8>(q, k8, v8, ks, vs, out, BH, M, hd, Ta, scale,
                           bulk, ldk, smem, q_dtype, stream);
}
