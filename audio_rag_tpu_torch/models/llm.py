"""Decoder-only LLM (llama-3.2 class) of the port: counterpart of
``audio_rag_tpu/models/llm.py`` for answer synthesis and HyDE.

RMSNorm pre-norm blocks, rope, grouped-query attention, a SwiGLU MLP and
an untied head, parameters in the JAX package's layout (stacked (L, ...)
blocks, (din, dout) weights). :func:`llm_generate` is the wave decode the
JAX generator compiles: a left-padded prompt batch prefilled into a static
KV cache, then one :func:`llm_decode_step` per token for every row, greedy
or sampled from explicit keys (:mod:`audio_rag_tpu_torch.ops.random`),
until every row has emitted EOS.

Attention is the plain product-softmax-product (the JAX package runs it as
an einsum over the whole cache, on no kernel); the decode step reads only
the frames written so far (the masked rest adds exact zeros there). Under
``decoder_q8`` (:func:`quantize_llm_weights`) every decode-step linear
goes through ``linear_q8``: the ``matmul_q8w`` kernel for int8 weights,
``matmul_q4w`` for int4 (4 launches a layer: fused QKV, output, fused
gate/up, down; one for the head).

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
    q4_group,
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
    "llm_generate",
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
    def bytes_for(mats, b):
        w = sum(din * dout for din, dout in mats)
        if b == 8:
            return w + 4 * sum(dout for _, dout in mats)
        scales = sum((din // q4_group(din)) * dout for din, dout in mats)
        return w // 2 + 4 * scales

    d = dims.d_model
    kv_d = dims.n_kv_heads * (d // dims.n_heads)
    block_mats = [(d, d + 2 * kv_d), (d, d), (d, 2 * dims.d_ff),
                  (dims.d_ff, d)] * dims.n_layers
    lm_bits = lm_head_bits if lm_head_bits is not None else bits
    return bytes_for(block_mats, bits) + bytes_for([(d, dims.vocab)], lm_bits)


def llm_decode_step(
    params: Params,
    dims: LLMDims,
    tok: torch.Tensor,  # (B,) each row's current token
    pos: int,  # the cache frame every row writes (wave decode)
    cache_k: torch.Tensor,  # (L, B, HKV, C, hd), written in place
    cache_v: torch.Tensor,
    kv_valid: torch.Tensor | None = None,  # (B, C) bool
    dtype: torch.dtype = torch.bfloat16,
    rope_pos: int | torch.Tensor | None = None,  # () or (B,) true positions
    q8: Params | None = None,  # quantize_llm_weights output
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step, all rows at frame ``pos``: each layer's key and
    value are written there and attention reads frames [0, pos]. Rope
    takes ``rope_pos`` (each row's true position when the frame is
    left-padded; default ``pos``). With ``q8`` the linears run on the
    quantized copies through ``linear_q8``. Returns (logits (B, vocab) f32,
    cache_k, cache_v)."""
    L, B, HKV, C, hd = cache_k.shape
    H, d = dims.n_heads, dims.d_model
    G, kv_d = H // HKV, HKV * hd
    cos_t, sin_t = _rope_tables(dims, hd, tok.device)
    rp = pos if rope_pos is None else rope_pos
    if isinstance(rp, torch.Tensor) and rp.dim() == 1:
        cos, sin = cos_t[rp][:, None, None, :], sin_t[rp][:, None, None, :]
    else:
        cos, sin = cos_t[int(rp)], sin_t[int(rp)]
    n = pos + 1
    mask = None if kv_valid is None else kv_valid[:, None, None, :n]
    scale = _scale(hd, dtype)

    x = params["tok_emb"]["table"].to(dtype)[tok][:, None, :].float()
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]
        xn = rms_norm(p["ln_attn"], x, dtype)
        if p8 is None:
            q = linear(p["attn"]["q"], xn, dtype)
            k = linear(p["attn"]["k"], xn, dtype)
            v = linear(p["attn"]["v"], xn, dtype)
        else:  # fused QKV: one kernel launch
            qkv = linear_q8({}, p8["attn_qkv"], xn, dtype)
            q, k, v = qkv[..., :d], qkv[..., d:d + kv_d], qkv[..., d + kv_d:]
        q = apply_rope(q.reshape(B, 1, H, hd).transpose(1, 2), cos, sin)
        k = apply_rope(k.reshape(B, 1, HKV, hd).transpose(1, 2), cos, sin)
        v = v.reshape(B, 1, HKV, hd).transpose(1, 2)
        cache_k[i, :, :, pos] = k[:, :, 0].to(cache_k.dtype)
        cache_v[i, :, :, pos] = v[:, :, 0].to(cache_v.dtype)
        # grouped-query attention: the G query heads of a kv head ride the
        # product's rows, no repeated cache
        qg = (q * scale).reshape(B, HKV, G, hd)
        o = _attend(qg, cache_k[i, :, :, :n].to(dtype),
                    cache_v[i, :, :, :n].to(dtype), mask, dtype)
        o = o.reshape(B, 1, d)
        if p8 is None:
            x = _add(x, linear(p["attn"]["o"], o, dtype), dtype)
            x = _add(x, swiglu(p["mlp"], rms_norm(p["ln_mlp"], x, dtype),
                               dtype), dtype)
        else:
            x = _add(x, linear_q8({}, p8["attn_o"], o, dtype), dtype)
            gu = linear_q8({}, p8["mlp_gateup"],
                           rms_norm(p["ln_mlp"], x, dtype), dtype)
            gate, up = gu[..., :dims.d_ff], gu[..., dims.d_ff:]
            x = _add(x, linear_q8({}, p8["mlp_down"], silu(gate) * up,
                                  dtype), dtype)
    x = rms_norm(params["ln_f"], x, dtype)
    if q8 is None:
        logits = linear(params["lm_head"], x, dtype)[:, 0].float()
    else:
        logits = linear_q8({}, q8["lm_head"], x, torch.float32)[:, 0]
    return logits, cache_k, cache_v


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
