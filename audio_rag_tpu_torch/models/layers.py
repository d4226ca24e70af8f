"""Shared transformer building blocks on tensors with params in dicts.

Counterpart of ``audio_rag_tpu/models/layers.py``: the same param trees
(``{"w": (din, dout), "b": (dout,)}`` linears, ``{"g", "b"}`` norms), the
same (B, H, T, D) attention layout and the same compute-dtype rules — a
matmul takes its operands in the compute dtype and sums in f32, the bias is
added in f32, the result is cast back. On the CPU, bf16 operands are
widened to f32 before the product (exact, like XLA's
``preferred_element_type=f32``); on CUDA a bf16 weight matmul runs on the
bf16 tensor cores (f32 accumulate, one rounding of the product).

Two routes go to the port's hand-written kernels
(:mod:`audio_rag_tpu_torch.ops.kernels`): :func:`_attend` sends unmasked
attention with D ≤ 128 to ``flash_attention`` and :func:`linear_q8` sends
int8-weight matmuls to ``matmul_q8w``. Both wrappers use their plain
versions for CPU tensors.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.ops import kernels

Params = dict[str, Any]

__all__ = [
    "Params",
    "mm_f32",
    "linear",
    "quantize_linear",
    "linear_q8",
    "layer_norm",
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
    products, f32 sums)."""
    if a.dtype != torch.float32:
        a = a.float()
    if b.dtype != torch.float32:
        b = b.float()
    return torch.matmul(a, b)


def linear(p: Params, x: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    x = x.to(dtype)
    w = p["w"].to(dtype)
    if x.is_cuda and dtype != torch.float32:
        y = torch.matmul(x, w).float()
    else:
        y = mm_f32(x, w)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


def quantize_linear(w: torch.Tensor) -> Params:
    """Per-out-channel symmetric int8 of a (din, dout) weight:
    {"w8" (din, dout) int8, "s" (dout,) f32}. Same rounding (half to even)
    and clipping as the JAX package, so both give identical trees."""
    w = w.float()
    amax = torch.amax(torch.abs(w), dim=0)
    s = torch.clamp(amax, min=1e-9) / 127.0
    w8 = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return {"w8": w8, "s": s}


def linear_q8(p: Params, p8: Params, x: torch.Tensor,
              dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """:func:`linear` with int8 weights ``p8`` ({"w8", "s"}) and the bias
    from ``p``, through the ``matmul_q8w`` kernel (x rounded to bf16, f32
    sums, scale on the output)."""
    *lead, din = x.shape
    rows = x.reshape(-1, din)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        rows = rows.float()
    y = kernels.matmul_q8w(rows.contiguous(), p8["w8"], p8["s"])
    y = y.reshape(*lead, p8["w8"].shape[1])
    if "b" in p:
        y = y + p["b"].float()
    return y.to(dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = F.layer_norm(xf, (xf.shape[-1],), p["g"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


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
