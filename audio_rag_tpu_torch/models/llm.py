"""Decoder-only LLM (llama-3.2 class) of the port: counterpart of
``audio_rag_tpu/models/llm.py`` for answer synthesis and HyDE.

RMSNorm pre-norm blocks, rope, grouped-query attention, a SwiGLU MLP and
an untied head, parameters in the JAX package's layout (stacked (L, ...)
blocks, (din, dout) weights). :func:`llm_generate` is the wave decode the
JAX generator compiles: a left-padded prompt batch prefilled into a static
KV cache, then one :func:`llm_decode_step` per token for every row, greedy
or sampled from explicit keys (:mod:`audio_rag_tpu_torch.ops.random`),
until every row has emitted EOS. The serving engine's programs:
:func:`llm_block_verify` (a teacher-forced k-token step at per-row
positions) and :func:`llm_speculative_generate` (greedy in verify blocks
against the n-gram drafter, the wave's tokens), and the continuous
batcher's :func:`llm_prefill_slots`, :func:`llm_decode_slots` and
:func:`llm_decode_slots_spec` (slots at their own positions and
temperatures in one shared cache).

Attention is the plain product-softmax-product (the JAX package runs it as
an einsum over the whole cache, on no kernel); the wave's decode step reads
only the frames written so far (the masked rest adds exact zeros there),
the per-row programs the whole cache, masked. Under ``decoder_q8``
(:func:`quantize_llm_weights`) every decode-step and verify linear goes
through ``linear_q8``: the ``matmul_q8w`` kernel for int8 weights,
``matmul_q4w`` for int4 (4 launches a layer: fused QKV, output, fused
gate/up, down; one for the head), at B rows a step and B·k a verify.

In bf16 the model rounds where the JAX package's compiled program rounds:
every linear's output, rope's output, the scaled queries (by the bf16
value of hd^-½), the softmax probabilities, the attention output, each
step of ``silu`` and each norm's output. The residual stream is held in
f32: a residual sum adds two bf16-rounded terms and is not rounded, so the
norm that reads it sees the exact sum (XLA removes that round trip), while
the next sum rounds it first; the prefill's layer loop (a ``scan`` in
JAX, whose carry is bf16) rounds the stream at the end of each layer, the
decode step's unrolled loop does not. The unquantized head's logits are
rounded to bf16, the quantized head's are not, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from audio_rag_tpu_torch.models.layers import (
    Params,
    apply_rope,
    embedding_init,
    linear,
    linear_q8,
    make_causal_mask,
    mha_init,
    mm_f32,
    quant_bytes,
    quantize_linear,
    quantize_linear_q4,
    rms_norm,
    rope_frequencies,
    silu,
    swiglu,
    swiglu_init,
    take_layer,
)
from audio_rag_tpu_torch.ops import random as jrandom

__all__ = [
    "LLMDims",
    "LLM_PRESETS",
    "init_llm",
    "llm_forward",
    "llm_decode_step",
    "llm_block_verify",
    "llm_generate",
    "llm_speculative_generate",
    "llm_prefill_slots",
    "llm_decode_slots",
    "llm_decode_slots_spec",
    "quantize_llm_weights",
    "q8_param_bytes",
]


@dataclasses.dataclass(frozen=True)
class LLMDims:
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    n_layers: int
    d_ff: int
    max_len: int
    rope_theta: float = 500000.0


LLM_PRESETS: dict[str, LLMDims] = {
    "llama-3.2-1b": LLMDims(128256, 2048, 32, 8, 16, 8192, 8192),
    "llama-3.2-3b": LLMDims(128256, 3072, 24, 8, 28, 8192, 8192),
    "test": LLMDims(512, 64, 4, 2, 2, 128, 128, rope_theta=10000.0),
    # the committed trained generator's shapes (llm_small.npz)
    "eval-small": LLMDims(2048, 256, 8, 4, 4, 1024, 1024,
                          rope_theta=10000.0),
}


def init_llm(dims: LLMDims, gen: torch.Generator,
             dtype: torch.dtype = torch.bfloat16) -> Params:
    """Seeded random parameters in the JAX package's layout and
    distributions, drawn on ``gen``'s device in f32 one matrix at a time
    and stored in ``dtype`` (llama-3.2-3b: 7.2 GB in bf16, never a full f32
    tree). Not the JAX package's numbers: its trees come in through
    ``weights.convert_llm``."""
    d, L = dims.d_model, dims.n_layers
    dev = gen.device
    ones = torch.ones((L, d), dtype=dtype, device=dev)
    blocks: Params | None = None
    for i in range(L):
        blk = {"attn": mha_init(gen, d, dims.n_heads, dims.n_kv_heads,
                                dtype),
               "mlp": swiglu_init(gen, d, dims.d_ff, dtype)}
        if blocks is None:
            blocks = _stacked_like(blk, L)
        _put_layer(blocks, blk, i)
    blocks.update({"ln_attn": {"g": ones}, "ln_mlp": {"g": ones.clone()}})
    out = {"tok_emb": embedding_init(gen, dims.vocab, d, dtype),
           "blocks": blocks,
           "ln_f": {"g": torch.ones(d, dtype=dtype, device=dev)}}
    out["lm_head"] = {"w": (torch.randn((d, dims.vocab), generator=gen,
                                        device=dev) * d ** -0.5).to(dtype)}
    return out


def _stacked_like(tree: Params, n: int) -> Params:
    return {k: _stacked_like(v, n) if isinstance(v, dict) else
            torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def _put_layer(dst: Params, src: Params, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _put_layer(dst[k], v, i)
        else:
            dst[k][i] = v


_ROPE: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(dims: LLMDims, head_dim: int, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dims.max_len, head_dim, dims.rope_theta, str(device))
    if key not in _ROPE:
        cos, sin = rope_frequencies(head_dim, dims.max_len, dims.rope_theta)
        _ROPE[key] = (torch.from_numpy(cos).to(device),
                      torch.from_numpy(sin).to(device))
    return _ROPE[key]


def _scale(head_dim: int, dtype: torch.dtype) -> float:
    """hd^-½ as the compute dtype holds it (the JAX package multiplies a
    ``dtype`` tensor by a weakly typed Python float)."""
    return float(torch.tensor(head_dim ** -0.5).to(dtype))


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` of f32 scores: exp(s − max) over its sum."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _add(x: torch.Tensor, h: torch.Tensor, dtype: torch.dtype
         ) -> torch.Tensor:
    """The residual sum of the rounded stream and ``h``, kept in f32."""
    return x.to(dtype).float() + h.float()


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """softmax(q·kᵀ)·v of scaled (..., Tq, hd) queries against (..., Tk,
    hd) keys in ``dtype``, f32 scores, ``mask`` True = attend."""
    s = mm_f32(q, k.transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~mask, -1e30)
    return mm_f32(_softmax(s).to(dtype), v).to(dtype)


def llm_forward(
    params: Params,
    dims: LLMDims,
    tokens: torch.Tensor,  # (B, T)
    pos_offset: int = 0,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (L,B,HKV,C,hd)
    dtype: torch.dtype = torch.bfloat16,
    kv_valid: torch.Tensor | None = None,  # (B, C or T) bool, False = pad
    pos_ids: torch.Tensor | None = None,  # (B, T) rope positions per row
    last_pos: torch.Tensor | None = None,  # (B,) the one position to project
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """(logits (B, T, vocab) f32 — (B, 1, vocab) with ``last_pos`` — and
    the cache). With ``cache`` the keys and values of the T tokens are
    written at frames [pos_offset, pos_offset + T) in place and attention
    reads the whole cache, frames from pos_offset + T on masked (as in the
    JAX package: a pad row, all of whose keys are masked, then averages
    the same frames). ``kv_valid`` masks left pads;
    ``pos_ids`` gives each row's true positions for rope (each row counts
    its real tokens), else frame positions from ``pos_offset``."""
    B, T = tokens.shape
    H, HKV = dims.n_heads, dims.n_kv_heads
    hd = dims.d_model // H
    dev = tokens.device
    cos_t, sin_t = _rope_tables(dims, hd, dev)
    if pos_ids is not None:
        cos, sin = cos_t[pos_ids][:, None], sin_t[pos_ids][:, None]
    else:
        cos = cos_t[pos_offset:pos_offset + T]
        sin = sin_t[pos_offset:pos_offset + T]
    if cache is not None:
        C = cache[0].shape[3]
        mask = make_causal_mask(T, C, pos_offset, device=dev)
        mask &= torch.arange(C, device=dev)[None, :] < pos_offset + T
    else:
        mask = make_causal_mask(T, T, device=dev)
    if kv_valid is not None:
        mask = mask[None, None] & kv_valid[:, None, None, :]
    scale = _scale(hd, dtype)

    x = params["tok_emb"]["table"].to(dtype)[tokens].float()
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        xn = rms_norm(p["ln_attn"], x, dtype)

        def heads(t, n):
            return t.reshape(B, T, n, hd).transpose(1, 2)

        q = apply_rope(heads(linear(p["attn"]["q"], xn, dtype), H), cos, sin)
        k = apply_rope(heads(linear(p["attn"]["k"], xn, dtype), HKV),
                       cos, sin)
        v = heads(linear(p["attn"]["v"], xn, dtype), HKV)
        if cache is not None:
            ck, cv = cache[0][i], cache[1][i]
            ck[:, :, pos_offset:pos_offset + T] = k.to(ck.dtype)
            cv[:, :, pos_offset:pos_offset + T] = v.to(cv.dtype)
            k, v = ck.to(dtype), cv.to(dtype)
        k = k.repeat_interleave(H // HKV, dim=1)
        v = v.repeat_interleave(H // HKV, dim=1)
        o = _attend(q * scale, k, v, mask, dtype)
        o = o.transpose(1, 2).reshape(B, T, dims.d_model)
        x = _add(x, linear(p["attn"]["o"], o, dtype), dtype)
        x = _add(x, swiglu(p["mlp"], rms_norm(p["ln_mlp"], x, dtype), dtype),
                 dtype)
        x = x.to(dtype).float()  # the layer loop's carry is rounded
    x = rms_norm(params["ln_f"], x, dtype)
    if last_pos is not None:
        x = x[torch.arange(B, device=dev), last_pos][:, None, :]
    logits = linear(params["lm_head"], x, dtype).float()
    return logits, cache


def quantize_llm_weights(params: Params, dims: LLMDims, bits: int = 8,
                         lm_head_bits: int | None = None) -> Params:
    """Per-out-channel int8 (``bits=8``) or group-wise int4 (``bits=4``)
    copies of every matrix the decode step reads, per layer:
    {"blocks": [{"attn_qkv", "attn_o", "mlp_gateup", "mlp_down"}],
    "lm_head"}. The fused QKV and gate/up are the concatenations of the
    individually quantized matrices (the scales span only dout, so each
    column is what the split matrix would give). ``lm_head_bits``
    overrides ``bits`` for the head. The JAX package's jitted quantizer,
    bit for bit."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    lm_bits = lm_head_bits if lm_head_bits is not None else bits
    if lm_bits not in (8, 4):
        raise ValueError(f"lm_head_bits must be 8 or 4, got {lm_bits}")
    quant = quantize_linear if bits == 8 else quantize_linear_q4
    wkey = "w8" if bits == 8 else "w4"
    saxis = 0 if bits == 8 else 1  # int8 scales (dout,), int4 (din/G, dout)

    def qcat(*ps):
        qs = [quant(p["w"]) for p in ps]
        return {wkey: torch.cat([e[wkey] for e in qs], dim=1),
                "s": torch.cat([e["s"] for e in qs], dim=saxis)}

    blocks = []
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        blocks.append({
            "attn_qkv": qcat(p["attn"]["q"], p["attn"]["k"], p["attn"]["v"]),
            "attn_o": quant(p["attn"]["o"]["w"]),
            "mlp_gateup": qcat(p["mlp"]["gate"], p["mlp"]["up"]),
            "mlp_down": quant(p["mlp"]["down"]["w"]),
        })
    head_quant = quantize_linear if lm_bits == 8 else quantize_linear_q4
    return {"blocks": blocks, "lm_head": head_quant(params["lm_head"]["w"])}


def q8_param_bytes(dims: LLMDims, bits: int = 8,
                   lm_head_bits: int | None = None) -> int:
    """Bytes of the :func:`quantize_llm_weights` copies (weights and f32
    scales), which sit beside the bf16 parameters."""
    d = dims.d_model
    kv_d = dims.n_kv_heads * (d // dims.n_heads)
    block_mats = [(d, d + 2 * kv_d), (d, d), (d, 2 * dims.d_ff),
                  (dims.d_ff, d)] * dims.n_layers
    lm_bits = lm_head_bits if lm_head_bits is not None else bits
    return (quant_bytes(block_mats, bits)
            + quant_bytes([(d, dims.vocab)], lm_bits))


def _qkv(p: Params, p8: Params | None, xn: torch.Tensor, dims: LLMDims,
         dtype: torch.dtype):
    """The query, key and value of a block's normed input (the fused QKV
    under ``p8``: one kernel launch)."""
    if p8 is None:
        return (linear(p["attn"]["q"], xn, dtype),
                linear(p["attn"]["k"], xn, dtype),
                linear(p["attn"]["v"], xn, dtype))
    d, kv_d = dims.d_model, dims.n_kv_heads * (dims.d_model // dims.n_heads)
    qkv = linear_q8({}, p8["attn_qkv"], xn, dtype)
    return qkv[..., :d], qkv[..., d:d + kv_d], qkv[..., d + kv_d:]


def _block_tail(p: Params, p8: Params | None, x: torch.Tensor,
                o: torch.Tensor, dims: LLMDims, dtype: torch.dtype
                ) -> torch.Tensor:
    """The attention output's projection and the MLP, each added to the
    f32 residual stream ``x`` (3 launches under ``p8``)."""
    if p8 is None:
        x = _add(x, linear(p["attn"]["o"], o, dtype), dtype)
        return _add(x, swiglu(p["mlp"], rms_norm(p["ln_mlp"], x, dtype),
                              dtype), dtype)
    x = _add(x, linear_q8({}, p8["attn_o"], o, dtype), dtype)
    gu = linear_q8({}, p8["mlp_gateup"], rms_norm(p["ln_mlp"], x, dtype),
                   dtype)
    gate, up = gu[..., :dims.d_ff], gu[..., dims.d_ff:]
    return _add(x, linear_q8({}, p8["mlp_down"], silu(gate) * up, dtype),
                dtype)


def _head(params: Params, q8: Params | None, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """f32 logits of the final norm's input (the unquantized head's
    rounded to bf16 first, as in the JAX package)."""
    x = rms_norm(params["ln_f"], x, dtype)
    if q8 is None:
        return linear(params["lm_head"], x, dtype).float()
    return linear_q8({}, q8["lm_head"], x, torch.float32)


def llm_decode_step(
    params: Params,
    dims: LLMDims,
    tok: torch.Tensor,  # (B,) each row's current token
    pos: int | torch.Tensor,  # the frame every row writes, or (B,) per row
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    kv_valid: torch.Tensor | None = None,  # (B, C) bool
    dtype: torch.dtype = torch.bfloat16,
    rope_pos: int | torch.Tensor | None = None,  # () or (B,) true positions
    q8: Params | None = None,  # quantize_llm_weights output
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. With an int ``pos`` (the wave) all rows write
    frame ``pos`` and attention reads frames [0, pos]; with a (B,) tensor
    (the continuous batcher's slots) row b writes frame pos[b] and
    attention reads the whole cache, frames past pos[b] masked, as the JAX
    package reads it. Rope takes ``rope_pos`` (each row's true position
    when the frame is left-padded; default ``pos``). With ``q8`` the
    linears run on the quantized copies through ``linear_q8``. Returns
    (logits (B, vocab) f32, cache_k, cache_v)."""
    L, B, HKV, C, hd = cache_k.shape
    H, d = dims.n_heads, dims.d_model
    G = H // HKV
    dev = tok.device
    cos_t, sin_t = _rope_tables(dims, hd, dev)
    per_row = isinstance(pos, torch.Tensor)
    rp = pos if rope_pos is None else rope_pos
    if isinstance(rp, torch.Tensor) and rp.dim() == 1:
        rp = rp.clamp(max=cos_t.shape[0] - 1)  # JAX's gather clamps
        cos, sin = cos_t[rp][:, None, None, :], sin_t[rp][:, None, None, :]
    else:
        cos, sin = cos_t[int(rp)], sin_t[int(rp)]
    if per_row:
        n = C
        rows = torch.arange(B, device=dev)
        # a slot may step past the cache's end inside a segment (the
        # batcher checks its room at segment boundaries; such tokens lie
        # beyond its max_new): its write is dropped, as JAX's scatter
        # drops an update out of bounds
        keep = (pos < C)[:, None, None]
        wpos = pos.clamp(max=C - 1)
        mask = (torch.arange(C, device=dev)[None, :]
                <= pos[:, None])[:, None, None, :]
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, None, :]
    else:
        n = pos + 1
        mask = None if kv_valid is None else kv_valid[:, None, None, :n]
    scale = _scale(hd, dtype)

    x = params["tok_emb"]["table"].to(dtype)[tok][:, None, :].float()
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]
        q, k, v = _qkv(p, p8, rms_norm(p["ln_attn"], x, dtype), dims, dtype)
        q = apply_rope(q.reshape(B, 1, H, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, 1, HKV, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, 1, HKV, hd).transpose(1, 2)
        if per_row:
            ck, cv = cache_k[i], cache_v[i]
            ck[rows, :, wpos] = torch.where(
                keep, k[:, :, 0].to(ck.dtype), ck[rows, :, wpos])
            cv[rows, :, wpos] = torch.where(
                keep, v[:, :, 0].to(cv.dtype), cv[rows, :, wpos])
        else:
            cache_k[i, :, :, pos] = k[:, :, 0].to(cache_k.dtype)
            cache_v[i, :, :, pos] = v[:, :, 0].to(cache_v.dtype)
        # grouped-query attention: the G query heads of a kv head ride the
        # product's rows, no repeated cache
        qg = (q * scale).reshape(B, HKV, G, hd)
        o = _attend(qg, cache_k[i, :, :, :n].to(dtype),
                    cache_v[i, :, :, :n].to(dtype), mask, dtype)
        x = _block_tail(p, p8, x, o.reshape(B, 1, d), dims, dtype)
    return _head(params, q8, x, dtype)[:, 0], cache_k, cache_v


def llm_block_verify(
    params: Params,
    dims: LLMDims,
    block: torch.Tensor,  # (B, k) [cur, draft_1 .. draft_{k-1}]
    pos: torch.Tensor,  # (B,) each row's cache frame of block[:, 0]
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    kv_valid: torch.Tensor | None = None,  # (B, C) bool, False = pad
    rope_pos: torch.Tensor | None = None,  # (B,) true position of block[:, 0]
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced k-token step with per-row positions, the verify pass
    of speculative decoding: row b writes its k keys and values at frames
    clip(pos_b + j, 0, C - 1), rope runs at rope_pos_b + j, and query j
    attends to the frames ≤ pos_b + j; the G·k queries of a kv head ride
    one product's rows, scores in f32. The weights are read once for the
    k tokens (the decode step's kernels at B·k rows). Returns (logits (B,
    k, vocab) f32, cache_k, cache_v)."""
    L, B, HKV, C, hd = cache_k.shape
    H, d = dims.n_heads, dims.d_model
    G = H // HKV
    k = block.shape[1]
    dev = block.device
    j = torch.arange(k, device=dev)[None, :]
    cos_t, sin_t = _rope_tables(dims, hd, dev)
    rp = torch.clamp((pos if rope_pos is None else rope_pos)[:, None] + j,
                     0, dims.max_len - 1)
    cos, sin = cos_t[rp][:, None], sin_t[rp][:, None]  # (B, 1, k, hd/2)
    cpos = torch.clamp(pos[:, None] + j, 0, C - 1)  # (B, k)
    mask = (torch.arange(C, device=dev)[None, None, :]
            <= cpos[:, :, None])  # (B, k, C)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    # (B, 1, G·k, C): query row g·k + j of a kv head is query j of head g
    mask = mask[:, None].expand(B, G, k, C).reshape(B, 1, G * k, C)
    rows = torch.arange(B, device=dev)[:, None]
    scale = _scale(hd, dtype)

    x = params["tok_emb"]["table"].to(dtype)[block].float()  # (B, k, d)
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]
        q, kk, vv = _qkv(p, p8, rms_norm(p["ln_attn"], x, dtype), dims,
                         dtype)
        q = apply_rope(q.reshape(B, k, H, hd).transpose(1, 2), cos, sin)
        kk = apply_rope(kk.reshape(B, k, HKV, hd).transpose(1, 2), cos, sin)
        vv = vv.reshape(B, k, HKV, hd)
        # per-row scatter: cache[i][b, :, cpos[b, j]] = kv[b, j]
        cache_k[i][rows, :, cpos] = kk.transpose(1, 2).to(cache_k.dtype)
        cache_v[i][rows, :, cpos] = vv.to(cache_v.dtype)
        qg = (q * scale).reshape(B, HKV, G * k, hd)
        o = _attend(qg, cache_k[i].to(dtype), cache_v[i].to(dtype), mask,
                    dtype)
        # (B, HKV, G, k, hd) → (B, k, H·hd): head h = kv·G + g
        o = o.reshape(B, HKV, G, k, hd).permute(0, 3, 1, 2, 4).reshape(
            B, k, d)
        x = _block_tail(p, p8, x, o, dims, dtype)
    return _head(params, q8, x, dtype), cache_k, cache_v


def _inverse(temperature: float) -> float:
    """1/T as the f32 reciprocal (XLA compiles ``logits / T`` for a
    constant T as a product with it)."""
    return float(np.float32(1.0) / np.float32(temperature))


def llm_generate(
    params: Params,
    dims: LLMDims,
    prompt: torch.Tensor,  # (B, P)
    max_new_tokens: int,
    eos_id: int,
    temperature: float = 0.0,
    rng: jrandom.Key | None = None,
    dtype: torch.dtype = torch.bfloat16,
    prompt_mask: torch.Tensor | None = None,  # (B, P) bool, False = pad
    decoder_q8: Params | None = None,
    stats: dict | None = None,
) -> torch.Tensor:
    """Wave decode of a (left-padded) prompt batch with a static KV cache;
    returns the (B, P + max_new_tokens) tokens, EOS after each row's end.
    Temperature ≤ 0 is greedy (the first maximum); otherwise each step
    draws one ``categorical`` over the whole batch's logits times 1/T from
    the next key split off ``rng`` (default ``PRNGKey(0)``). The loop stops
    when every row has emitted EOS (read on the host once a step) or the
    tokens are full. ``stats``, when given, receives the decode steps run
    and the prefill's and the decode loop's seconds (host clock, the
    device drained at each end)."""
    B, Pl = prompt.shape
    dev = prompt.device
    t0 = _clock(dev)
    hd = dims.d_model // dims.n_heads
    total = Pl + max_new_tokens
    cache_len = min(dims.max_len, total)
    lk = torch.zeros((dims.n_layers, B, dims.n_kv_heads, cache_len, hd),
                     dtype=dtype, device=dev)
    lv = torch.zeros_like(lk)

    kv_valid = pos_ids = None
    row_offset = torch.zeros(B, dtype=torch.long, device=dev)
    if prompt_mask is not None:
        m = prompt_mask.bool()
        kv_valid = torch.cat([m, torch.ones((B, cache_len - Pl),
                                            dtype=torch.bool, device=dev)], 1)
        # true positions: rope counts each row's real tokens
        pos_ids = torch.clamp(torch.cumsum(m.long(), dim=1) - 1, min=0)
        row_offset = Pl - m.long().sum(dim=1)

    logits, _ = llm_forward(
        params, dims, prompt, 0, (lk, lv), dtype,
        kv_valid=kv_valid[:, :cache_len] if kv_valid is not None else None,
        pos_ids=pos_ids,
        last_pos=torch.full((B,), Pl - 1, dtype=torch.long, device=dev))
    rng = jrandom.PRNGKey(0) if rng is None else rng
    inv_t = _inverse(temperature) if temperature > 0.0 else 0.0

    def pick(lg: torch.Tensor, key: jrandom.Key) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1)
        return jrandom.categorical(key, lg * inv_t)

    k0, rng = jrandom.split(rng)
    tokens = torch.full((B, total), eos_id, dtype=torch.long, device=dev)
    tokens[:, :Pl] = prompt
    first = pick(logits[:, -1, :], k0)
    tokens[:, Pl] = first
    finished = first == eos_id
    t1 = _clock(dev)
    i = Pl
    while i < total - 1 and not bool(finished.all()):
        logits, lk, lv = llm_decode_step(
            params, dims, tokens[:, i], i, lk, lv, kv_valid=kv_valid,
            dtype=dtype,
            rope_pos=None if prompt_mask is None else i - row_offset,
            q8=decoder_q8)
        key, rng = jrandom.split(rng)
        nxt = torch.where(finished, eos_id, pick(logits, key))
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eos_id)
        i += 1
    if stats is not None:
        stats.update(steps=i - Pl, prefill_s=t1 - t0,
                     decode_s=_clock(dev) - t1)
    return tokens


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# -- speculative generation and the continuous batcher's slot programs -------

def upload(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values as a tensor on ``device``; to a card through pinned
    memory without waiting for the work already queued there (a copy from
    pageable memory waits for the stream)."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Temps:
    """Per-row temperatures (host floats, ≤ 0 greedy) made into device
    tensors once for a program: the rows that sample and each row's
    divisor (1 for greedy rows, as the JAX package's ``safe_t``)."""

    def __init__(self, temps, device: torch.device):
        hot = [float(t) > 0.0 for t in temps]
        self.any = any(hot)
        self.hot = upload(hot, torch.bool, device)
        self.safe = upload([float(t) if h else 1.0
                            for t, h in zip(temps, hot)], torch.float32,
                           device)


def _pick_rows(logits: torch.Tensor, temps: _Temps, key: jrandom.Key
               ) -> torch.Tensor:
    """Each row's next token from f32 ``logits`` (R, vocab): the first
    maximum for a greedy row, else ``categorical(key, logits / T)`` over
    the whole batch — a true f32 division, as XLA keeps ``lg /
    safe_t[:, None]`` for a traced array. Without a sampled row no noise
    is drawn (the key is still the step's)."""
    greedy = torch.argmax(logits, dim=-1)
    if not temps.any:
        return greedy
    sampled = jrandom.categorical(key, logits / temps.safe[:, None])
    return torch.where(temps.hot, sampled, greedy)


def llm_speculative_generate(
    params: Params,
    dims: LLMDims,
    prompt: torch.Tensor,  # (B, P), left-padded under prompt_mask
    max_new_tokens: int,
    eos_id: int,
    spec_k: int = 8,
    dtype: torch.dtype = torch.bfloat16,
    prompt_mask: torch.Tensor | None = None,  # (B, P) bool, False = pad
    decoder_q8: Params | None = None,
    stats: dict | None = None,
) -> tuple[torch.Tensor, int]:
    """Greedy decode in verify blocks of ``spec_k`` tokens, with
    :func:`llm_generate`'s tokens at temperature 0: each iteration drafts
    ``spec_k - 1`` tokens with the n-gram drafter
    (:func:`~audio_rag_tpu_torch.models.whisper.ngram_draft`) and verifies
    the block in one :func:`llm_block_verify`; a draft survives only where
    it equals the model's own argmax, and the argmax after the last
    survivor is emitted too. Rows advance by their own counts, stop at
    their first EOS and never write past the buffer; the cache has
    ``spec_k`` frames of headroom for a block's tail. The loop reads the
    rows' ``finished`` on the host once an iteration. Returns the (B, P +
    max_new_tokens) tokens, EOS after each row's end, and the verify
    iterations run; ``stats`` receives the iterations and the prefill's
    and the loop's seconds."""
    from audio_rag_tpu_torch.models.whisper import ngram_draft

    B, Pl = prompt.shape
    dev = prompt.device
    t0 = _clock(dev)
    hd = dims.d_model // dims.n_heads
    k = spec_k
    total = Pl + max_new_tokens
    cache_len = min(dims.max_len, total) + k
    lk = torch.zeros((dims.n_layers, B, dims.n_kv_heads, cache_len, hd),
                     dtype=dtype, device=dev)
    lv = torch.zeros_like(lk)
    kv_valid = pos_ids = None
    row_offset = torch.zeros(B, dtype=torch.long, device=dev)
    if prompt_mask is not None:
        m = prompt_mask.bool()
        kv_valid = torch.cat([m, torch.ones((B, cache_len - Pl),
                                            dtype=torch.bool, device=dev)], 1)
        pos_ids = torch.clamp(torch.cumsum(m.long(), dim=1) - 1, min=0)
        row_offset = Pl - m.long().sum(dim=1)
    logits, _ = llm_forward(
        params, dims, prompt, 0, (lk, lv), dtype, kv_valid=kv_valid,
        pos_ids=pos_ids,
        last_pos=torch.full((B,), Pl - 1, dtype=torch.long, device=dev))
    first = torch.argmax(logits[:, -1, :], dim=-1)
    tokens = torch.full((B, total), eos_id, dtype=torch.long, device=dev)
    tokens[:, :Pl] = prompt
    tokens[:, Pl] = first
    finished = first == eos_id
    n_tok = torch.full((B,), Pl, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    j = torch.arange(k, device=dev)[None, :]
    t1 = _clock(dev)
    iters = 0
    while not bool(finished.all()):
        block = torch.cat([tokens[rows, n_tok][:, None],
                           ngram_draft(tokens, n_tok, k - 1)], dim=1)
        logits, lk, lv = llm_block_verify(
            params, dims, block, n_tok, lk, lv, kv_valid=kv_valid,
            rope_pos=n_tok - row_offset, dtype=dtype, q8=decoder_q8)
        f = torch.argmax(logits, dim=-1)  # (B, k)
        # accepted drafts are the argmaxes f[:, :a], plus the bonus f[:, a]
        a = torch.cumprod((block[:, 1:] == f[:, :-1]).long(), dim=1).sum(1)
        is_eos = f == eos_id
        a = torch.where(is_eos.any(1),
                        torch.minimum(a, is_eos.int().argmax(1)), a)
        a = torch.minimum(a, total - 2 - n_tok)  # emission bound
        write = (j <= a[:, None]) & ~finished[:, None]
        dst = n_tok[:, None] + 1 + j
        tokens[rows[:, None].expand(B, k)[write], dst[write]] = f[write]
        n_tok = n_tok + torch.where(finished, 0, a + 1)
        finished = (finished | (is_eos & write).any(1)
                    | (n_tok >= total - 1))
        iters += 1
    if stats is not None:
        stats.update(steps=iters, prefill_s=t1 - t0,
                     decode_s=_clock(dev) - t1)
    return tokens, iters


def llm_prefill_slots(
    params: Params,
    dims: LLMDims,
    prompts: torch.Tensor,  # (R, Pb), right-padded
    n_valid: torch.Tensor,  # (R,) true prompt lengths
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    slots: list[int],  # the batch slot of each row
    temps,  # R host floats (≤ 0 greedy)
    rng: jrandom.Key,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The continuous batcher's admission: R right-padded prompts
    prefilled in one forward (rope at frame positions, pads masked, only
    each row's last real position projected), their keys and values
    copied into frames [0, Pb) of their slots, and each row's first token
    picked on the device (:func:`_pick_rows` with ``rng`` whole). Rows that
    repeat a slot (the batcher's bucket filler copies row 0) write it once.
    Returns (cache_k, cache_v, first tokens (R,))."""
    L = cache_k.shape[0]
    R, Pb = prompts.shape
    dev = prompts.device
    hd = dims.d_model // dims.n_heads
    sk = torch.zeros((L, R, dims.n_kv_heads, Pb, hd), dtype=dtype,
                     device=dev)
    sv = torch.zeros_like(sk)
    kv_valid = torch.arange(Pb, device=dev)[None, :] < n_valid[:, None]
    logits, _ = llm_forward(params, dims, prompts, 0, (sk, sv), dtype,
                            kv_valid=kv_valid, last_pos=n_valid - 1)
    seen: set[int] = set()
    for r, s in enumerate(slots):
        if s not in seen:
            seen.add(s)
            cache_k[:, s, :, :Pb] = sk[:, r].to(cache_k.dtype)
            cache_v[:, s, :, :Pb] = sv[:, r].to(cache_v.dtype)
    return cache_k, cache_v, _pick_rows(logits[:, 0],
                                        _Temps(temps, dev), rng)


def llm_decode_slots(
    params: Params,
    dims: LLMDims,
    last_tok: torch.Tensor,  # (B,) each slot's most recent token
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # (B,) the frame last_tok's key and value go to
    active: torch.Tensor,  # (B,) bool: the slot holds a request
    temps,  # B host floats (≤ 0 greedy)
    rng: jrandom.Key,
    n_steps: int,
    eos_id: int,
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """``n_steps`` decode steps of every slot at its own position (the
    continuous batcher's segment), one key split off ``rng`` a step; a slot
    stops at EOS by a flag on the device (no host read in the segment) and
    then emits EOS. Returns (tokens (B, n_steps), cache_k, cache_v, new
    positions, finished)."""
    finished = ~active
    out = []
    last = last_tok
    temps = _Temps(temps, last_tok.device)
    for _ in range(n_steps):
        logits, cache_k, cache_v = llm_decode_step(
            params, dims, last, pos, cache_k, cache_v, dtype=dtype, q8=q8)
        key, rng = jrandom.split(rng)
        run = active & ~finished
        last = torch.where(run, _pick_rows(logits, temps, key), eos_id)
        finished = finished | (run & (last == eos_id)) | ~active
        pos = pos + run.long()
        out.append(last)
    return torch.stack(out, dim=1), cache_k, cache_v, pos, finished


def llm_decode_slots_spec(
    params: Params,
    dims: LLMDims,
    history: torch.Tensor,  # (B, Hh) recent tokens, right-aligned, -1 pads
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # (B,) the frame of history[:, -1]
    active: torch.Tensor,  # (B,) bool
    temps,  # B host floats (≤ 0 greedy)
    rng: jrandom.Key,
    n_steps: int,
    eos_id: int,
    spec_k: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """:func:`llm_decode_slots`'s contract (each live slot emits
    ``n_steps`` tokens unless it ends) in verify blocks of ``spec_k``:
    greedy slots draft from ``history`` plus what they emit and keep the
    surviving drafts and the bonus token (the plain slots' tokens);
    sampling slots take one token an iteration, drawn from the block's
    first logits with the iteration's key. A block never writes a valid
    frame past C - 2. The loop's end is read on the host once an
    iteration. Returns (tokens (B, n_steps), cache_k, cache_v, new
    positions, finished)."""
    from audio_rag_tpu_torch.models.whisper import ngram_draft

    C = cache_k.shape[3]
    B, Hh = history.shape
    dev = history.device
    k = spec_k
    work = torch.cat([history.long(), torch.full(
        (B, n_steps + k), -1, dtype=torch.long, device=dev)], dim=1)
    out = torch.full((B, n_steps), eos_id, dtype=torch.long, device=dev)
    n_tok = torch.full((B,), Hh - 1, dtype=torch.long, device=dev)
    n_out = torch.zeros(B, dtype=torch.long, device=dev)
    finished = ~active
    rows = torch.arange(B, device=dev)
    j = torch.arange(k, device=dev)[None, :]
    temps = _Temps(temps, dev)
    while not bool((finished | (n_out >= n_steps)).all()):
        block = torch.cat([work[rows, n_tok][:, None],
                           ngram_draft(work, n_tok, k - 1)], dim=1)
        logits, cache_k, cache_v = llm_block_verify(
            params, dims, block, pos, cache_k, cache_v, dtype=dtype, q8=q8)
        f = torch.argmax(logits, dim=-1)  # (B, k)
        key, rng = jrandom.split(rng)
        emit = f.clone()
        emit[:, 0] = _pick_rows(logits[:, 0], temps, key)
        a = torch.cumprod((block[:, 1:] == f[:, :-1]).long(), dim=1).sum(1)
        a = torch.where(temps.hot, 0, a)  # sampling: a token an iteration
        is_eos = emit == eos_id
        a = torch.where(is_eos.any(1),
                        torch.minimum(a, is_eos.int().argmax(1)), a)
        a = torch.minimum(a, n_steps - 1 - n_out)  # the segment's quota
        a = torch.minimum(a, C - 2 - pos)  # the cache (see cpos's clip)
        write = (j <= a[:, None]) & ~finished[:, None]
        r = rows[:, None].expand(B, k)[write]
        out[r, (n_out[:, None] + j)[write]] = emit[write]
        work[r, (n_tok[:, None] + 1 + j)[write]] = emit[write]
        n_new = torch.where(finished, 0, a + 1)
        n_tok, n_out, pos = n_tok + n_new, n_out + n_new, pos + n_new
        finished = finished | (is_eos & write).any(1) | (pos >= C - 2)
    return out, cache_k, cache_v, pos, finished
