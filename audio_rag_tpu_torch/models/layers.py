"""Shared transformer building blocks on tensors with params in dicts.

Counterpart of ``audio_rag_tpu/models/layers.py``: the same param trees
(``{"w": (din, dout), "b": (dout,)}`` linears, ``{"g", "b"}`` norms), the
same (B, H, T, D) attention layout and the same compute-dtype rules — a
matmul takes its operands in the compute dtype and sums in f32, the bias is
added in f32, the result is rounded to the compute dtype once. On the CPU,
bf16 operands are widened to f32 before the product (exact, like XLA's
``preferred_element_type=f32``); on CUDA a bf16 weight matmul runs on the
bf16 tensor cores with an f32 output (``torch.mm(..., out_dtype=f32)``),
so the product is not rounded to bf16 before the bias is added. f32
products on CUDA run in full f32 whatever PyTorch's TF32 switches say
(:func:`full_f32_matmul`, scoped to the call; no process-wide flag is set).

The llama-style pieces (:func:`rms_norm`, :func:`swiglu`,
:func:`apply_rope`) round where the JAX package's compiled CPU program
rounds: each elementwise step of ``jax.nn.silu`` in the compute dtype,
rope in f32 then once to the compute dtype, the norm's output once after
the gain; :func:`rms_norm` reads its input as given, so a caller that
holds the residual stream in f32 (as XLA does between a sum and the norm
that reads it) passes the f32 sum.

A training step differentiates all of it: :func:`mm_out_f32` has a
gradient of its own (:class:`MmOutF32`), and the flash kernel's wrapper
goes through its ``autograd.Function`` when a gradient is needed.

Three routes go to the port's hand-written kernels
(:mod:`audio_rag_tpu_torch.ops.kernels`): :func:`_attend` sends unmasked
attention with D ≤ 128 to ``flash_attention``, and :func:`linear_q8` sends
int8-weight matmuls to ``matmul_q8w`` and int4-weight ones to
``matmul_q4w``. The wrappers use their plain versions for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.device import full_f32_matmul
from audio_rag_tpu_torch.ops import kernels

Params = dict[str, Any]

# The JAX backend runs its quantizers under jit (the decoder weights once
# at load, the self and cross caches inside the compiled decode), where XLA
# turns a division by a constant into a product with its f32 reciprocal;
# the port multiplies by the same reciprocals (exact f32 values held as
# Python floats) to produce the same bits.
_INV127 = float(torch.tensor(1.0) / 127.0)
_INV7 = float(torch.tensor(1.0) / 7.0)

__all__ = [
    "Params",
    "mm_f32",
    "mm_out_f32",
    "MmOutF32",
    "linear",
    "quantize_linear",
    "q4_tiles",
    "q4_group",
    "quantize_linear_q4",
    "quant_bytes",
    "linear_q8",
    "layer_norm",
    "sum_in_windows",
    "rms_norm",
    "silu",
    "swiglu",
    "rope_frequencies",
    "apply_rope",
    "normal_init",
    "embedding_init",
    "mha_init",
    "swiglu_init",
    "gelu",
    "mlp",
    "mha",
    "make_causal_mask",
    "sinusoid_positions",
    "take_layer",
]


def take_layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a tree of stacked (L, ...) tensors (views, no copies)."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result; bf16 operands are widened first (exact
    products, f32 sums), in full f32 even where the caller let f32
    matmuls take TF32."""
    if a.dtype != torch.float32:
        a = a.float()
    if b.dtype != torch.float32:
        b = b.float()
    with full_f32_matmul():
        return torch.matmul(a, b)


def mm_out_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., din) @ w (din, dout) of bf16 CUDA tensors on the tensor
    cores, returned in f32: exact products summed in f32 and not rounded
    to bf16 (``aten::mm.dtype``, which PyTorch has for CUDA only). Where a
    gradient is needed it goes through :class:`MmOutF32`."""
    rows = a.reshape(-1, a.shape[-1])
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        y = MmOutF32.apply(rows, w)
    else:
        y = torch.mm(rows, w, out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], w.shape[-1])


class MmOutF32(torch.autograd.Function):
    """``torch.mm(a, w, out_dtype=f32)`` of 2-D bf16 tensors with a
    gradient through the same op: dA = dY·Wᵀ and dW = Aᵀ·dY with dY
    rounded to the operands' dtype, summed in f32, then cast to each
    input's dtype, as XLA transposes a bf16 dot with an f32 result. In
    :func:`linear` the f32 result is rounded to bf16 after the bias, so the
    gradient that reaches dY holds bf16 values and its rounding is exact."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        g = dy.to(a.dtype)
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, w.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(a.t(), g, out_dtype=torch.float32).to(w.dtype)
        return da, dw


def linear(p: Params, x: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    x = x.to(dtype)
    w = p["w"].to(dtype)
    if x.is_cuda and dtype != torch.float32:
        y = mm_out_f32(x, w)
    else:
        y = mm_f32(x, w)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


def quantize_linear(w: torch.Tensor) -> Params:
    """Per-out-channel symmetric int8 of a (din, dout) weight:
    {"w8" (din, dout) int8, "s" (dout,) f32}. The JAX package's jitted
    arithmetic (the scale times the f32 reciprocal of 127, rounding half to
    even, the same clipping), so both give identical trees."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=0)
    s = torch.clamp(amax, min=1e-9) * _INV127
    w8 = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return {"w8": w8, "s": s}


def q4_tiles(din: int, cap: int = 2048) -> tuple[int, int] | None:
    """(group, din_tile) that the JAX package's TPU kernel would take for
    ``din``, or None. Only its group is used here: it fixes the stored int4
    format (:func:`q4_group`), so both packages quantize alike; the tile
    rules (din_tile a multiple of 256 and of 8·group, group | din_tile |
    din, the largest group ≤ 128 first, then the largest tile) do not bind
    the CUDA kernel."""
    for group in (128, 112, 96, 80, 64, 48, 32, 16):
        step = math.lcm(256, 8 * group)
        best = None
        for t in range(step, min(din, cap) + 1, step):
            if din % t == 0:
                best = t
        if best is not None:
            return group, best
    return None


def q4_group(din: int) -> int:
    """Quantization group of int4 weights along ``din``: the
    :func:`q4_tiles` choice, else the largest even divisor ≤ 128 (80 for
    din 1280, 128 for 5120 and for 128, 64 for 512)."""
    tiles = q4_tiles(din)
    if tiles is not None:
        return tiles[0]
    if din % 2:
        raise ValueError(f"int4 packing needs an even din, got {din}")
    return next(g for g in (128, 96, 64, 48, 32, 16, 8, 4, 2)
                if din % g == 0)


def quantize_linear_q4(w: torch.Tensor) -> Params:
    """Group-wise symmetric int4 of a (din, dout) weight: {"w4" (din/2,
    dout) int8 with din rows 2r and 2r + 1 in the low and high nibble of
    byte row r, "s" (din/group, dout) f32}, group = :func:`q4_group`. The
    JAX package's jitted arithmetic (the scale times the f32 reciprocal of
    7, the same rounding and clipping), so both give identical trees."""
    w = w.float()
    din, dout = w.shape
    group = q4_group(din)
    g = w.reshape(din // group, group, dout)
    s = torch.clamp(torch.amax(torch.abs(g), dim=1), min=1e-9) * _INV7
    q = torch.clamp(torch.round(g / s[:, None, :]), -7, 7).to(torch.int32)
    q = q.reshape(din, dout)
    packed = (q[0::2] & 0x0F) | (q[1::2] << 4)
    return {"w4": packed.to(torch.int8), "s": s}


def quant_bytes(mats: list[tuple[int, int]], bits: int) -> int:
    """Bytes of the :func:`quantize_linear` (``bits=8``) or
    :func:`quantize_linear_q4` (``bits=4``) copies of (din, dout) weights,
    their f32 scales included."""
    w = sum(din * dout for din, dout in mats)
    if bits == 8:
        return w + 4 * sum(dout for _, dout in mats)
    return w // 2 + 4 * sum((din // q4_group(din)) * dout
                            for din, dout in mats)


def linear_q8(p: Params, p8: Params, x: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`linear` with quantized weights ``p8`` and the bias from
    ``p``, the kernel picked by key: int8 ({"w8", "s"}) through
    ``matmul_q8w`` (scale on the output), int4 ({"w4", "s"}) through
    ``matmul_q4w`` (group scales on the weights). x is rounded to bf16 and
    the products summed in f32."""
    *lead, din = x.shape
    rows = x.reshape(-1, din)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.float()
    if "w4" in p8:
        y = kernels.matmul_q4w(rows.contiguous(), p8["w4"], p8["s"])
    else:
        y = kernels.matmul_q8w(rows.contiguous(), p8["w8"], p8["s"])
    y = y.reshape(*lead, y.shape[-1])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = F.layer_norm(xf, (xf.shape[-1],), p["g"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def sum_in_windows(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis in XLA:CPU's order: windows of 32 elements,
    each summed in order, then the window sums in order."""
    d = x.shape[-1]
    n = -(-d // 32)
    if n * 32 != d:
        x = F.pad(x, (0, n * 32 - d))
    w = x.reshape(*x.shape[:-1], n, 32)
    acc = w[..., 0]
    for j in range(1, 32):
        acc = acc + w[..., j]
    total = acc[..., 0]
    for j in range(1, n):
        total = total + acc[..., j]
    return total


def rms_norm(p: Params, x: torch.Tensor, dtype: torch.dtype | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """x·rsqrt(mean(x²) + eps)·g in f32, rounded to ``dtype`` (default:
    x's). The mean is the sum times the f32 reciprocal of the width, as
    XLA compiles it; on the CPU the sum runs in XLA:CPU's order."""
    xf = x.float()
    sq = xf * xf
    ss = sq.sum(-1) if x.is_cuda else sum_in_windows(sq)
    inv_d = float(torch.tensor(1.0) / x.shape[-1])
    r = torch.rsqrt(ss * inv_d + eps)
    return (xf * r[..., None] * p["g"].float()).to(dtype or x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·1/(1 + exp(−x)) with every step rounded to x's dtype, as XLA
    expands ``jax.nn.silu``."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(p: Params, x: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """down(silu(gate(x))·up(x)), each linear rounded to ``dtype``."""
    gate = linear(p["gate"], x, dtype)
    return linear(p["down"], silu(gate) * linear(p["up"], x, dtype), dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape (max_len, head_dim/2), f32 (computed in
    float64 like the JAX package's numpy tables, then cast)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, T, D) by f32 cos/sin broadcastable to (..., T, D/2):
    the halves' rotation in f32, rounded to x's dtype once."""
    xf = x.float()
    h = xf.shape[-1] // 2
    x1, x2 = xf[..., :h], xf[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def normal_init(gen: torch.Generator, shape: tuple[int, ...], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Seeded normal·``scale`` drawn in f32 on ``gen``'s device, stored in
    ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   dtype: torch.dtype = torch.float32) -> Params:
    """{"table": (vocab, dim)} of normal·0.02 (the JAX package's init)."""
    return {"table": normal_init(gen, (vocab, dim), 0.02, dtype)}


def mha_init(gen: torch.Generator, d_model: int, n_heads: int,
             n_kv_heads: int | None = None,
             dtype: torch.dtype = torch.float32) -> Params:
    """Bias-free attention projections (the LLM's), grouped-query when
    ``n_kv_heads`` < ``n_heads`` (k and v then n_kv_heads·head_dim wide);
    normal·d^-½ weights, as the JAX ``mha_init``."""
    kv_d = (n_kv_heads or n_heads) * (d_model // n_heads)
    return {name: {"w": normal_init(gen, (d_model, dout), d_model ** -0.5,
                                    dtype)}
            for name, dout in (("q", d_model), ("k", kv_d), ("v", kv_d),
                               ("o", d_model))}


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32) -> Params:
    """Bias-free gate, up (d_model → d_ff) and down (d_ff → d_model)."""
    return {"gate": {"w": normal_init(gen, (d_model, d_ff), d_model ** -0.5,
                                      dtype)},
            "up": {"w": normal_init(gen, (d_model, d_ff), d_model ** -0.5,
                                    dtype)},
            "down": {"w": normal_init(gen, (d_ff, d_model), d_ff ** -0.5,
                                      dtype)}}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as Whisper and XLM-R use it."""
    return F.gelu(x)


def mlp(p: Params, x: torch.Tensor,
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return linear(p["down"], gelu(linear(p["up"], x, dtype)), dtype)


def make_causal_mask(q_len: int, kv_len: int, offset: int = 0,
                     device: torch.device | None = None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; True = attend. ``offset`` = #cached tokens."""
    q_pos = torch.arange(q_len, device=device)[:, None] + offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return kv_pos <= q_pos


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    """(B, H, Tq, D) attention; ``mask`` broadcastable to (B, H, Tq, Tk),
    True = attend. Unmasked attention with D ≤ 128 goes to the flash kernel
    (its plain version on the CPU) at any T; the rest takes the einsum."""
    if mask is None and q.shape[-1] <= 128:
        return kernels.flash_attention(q, k, v)
    scale = q.shape[-1] ** -0.5
    logits = mm_f32(q * scale, k.transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return mm_f32(probs, v).to(q.dtype)


def mha(
    p: Params,
    x: torch.Tensor,  # (B, Tq, d_model)
    n_heads: int,
    mask: torch.Tensor | None = None,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B,H,Tc,D)
    cache_index: int | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Self-attention with an optional KV cache. With ``cache`` the new k/v
    are written at ``cache_index`` IN PLACE (the cache tensors are updated,
    not copied) and attention runs over the whole static-size cache."""
    B, Tq, d_model = x.shape
    head_dim = d_model // n_heads
    q = linear(p["q"], x, dtype).reshape(B, Tq, n_heads, head_dim)
    k = linear(p["k"], x, dtype).reshape(B, Tq, n_heads, head_dim)
    v = linear(p["v"], x, dtype).reshape(B, Tq, n_heads, head_dim)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    new_cache = None
    if cache is not None:
        ck, cv = cache
        ck[:, :, cache_index:cache_index + Tq] = k.to(ck.dtype)
        cv[:, :, cache_index:cache_index + Tq] = v.to(cv.dtype)
        k, v = ck, cv
        new_cache = (ck, cv)

    out = _attend(q, k, v, mask)
    out = out.transpose(1, 2).reshape(B, Tq, d_model)
    return linear(p["o"], out, dtype), new_cache


def sinusoid_positions(length: int, dim: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings, (length, dim) f32 (computed in
    float64 like the JAX package's numpy table, then cast)."""
    log_timescale = torch.log(torch.tensor(10000.0, dtype=torch.float64)) \
        / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2,
                                                  dtype=torch.float64))
    scaled = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1).float()
