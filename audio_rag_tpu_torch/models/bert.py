"""XLM-RoBERTa-style bidirectional encoder (counterpart of
``audio_rag_tpu/models/bert.py``): post-LN blocks, learned positions with
the RoBERTa offset, exact-GELU FFN, layers stacked on a leading L axis.
Padding is masked, so attention is the plain product-softmax-product (the
JAX ``_attend``'s einsum path), on no kernel.

In a compute dtype narrower than f32 the encoder rounds where the JAX
package's compiled program rounds (XLA keeps some bf16 intermediates in
f32): every linear's output after its bias, the softmax probabilities,
the attention output, GELU's erfc and its product, and each LayerNorm's
output; the residual sums, the embedding sum and the scaled queries stay
f32, and the query scale and GELU's √½ are the compute dtype's values.
In f32 every rounding is the identity. On the CPU, where the tests hold
the port to the JAX package's CPU program, LayerNorm sums its rows in
XLA:CPU's order (windows of 32 summed in order, then the window sums in
order), so that a bf16 rounding of the normalized value seldom falls the
other way; on the card it is PyTorch's LayerNorm.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.models.layers import (
    Params,
    layer_norm,
    linear,
    mm_f32,
    take_layer,
)

__all__ = ["BertDims", "BERT_PRESETS", "init_bert", "bert_encode"]


@dataclasses.dataclass(frozen=True)
class BertDims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    max_len: int
    pad_id: int = 1  # RoBERTa convention
    pos_offset: int = 2


BERT_PRESETS: dict[str, BertDims] = {
    # XLM-R large — BGE-M3 backbone (BAAI/bge-m3)
    "xlmr-large": BertDims(250002, 1024, 16, 24, 4096, 8192),
    # XLM-R base — bge-reranker-base backbone
    "xlmr-base": BertDims(250002, 768, 12, 12, 3072, 512),
    "test": BertDims(1024, 64, 2, 2, 128, 128),
    # the committed trained NLI asset's shapes
    "nli-small": BertDims(4096, 128, 4, 4, 512, 128),
    # the committed trained retrieval embedder's and reranker's shapes
    "retrieval-small": BertDims(4096, 128, 4, 4, 512, 128),
}


def init_bert(dims: BertDims, gen: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> Params:
    """Seeded random parameters in the JAX package's layout and
    distributions (normal·d_in^-½ linears, normal·0.02 embeddings)."""
    L, d = dims.n_layers, dims.d_model

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def lin(din, dout):
        return {"w": normal((L, din, dout), din ** -0.5),
                "b": torch.zeros((L, dout), dtype=dtype, device=device)}

    def ln(lead):
        return {"g": torch.ones((*lead, d), dtype=dtype, device=device),
                "b": torch.zeros((*lead, d), dtype=dtype, device=device)}

    return {
        "tok_emb": {"table": normal((dims.vocab, d), 0.02)},
        "pos_emb": {"table": normal((dims.max_len + dims.pos_offset, d),
                                    0.02)},
        "ln_emb": ln(()),
        "blocks": {
            "attn": {a: lin(d, d) for a in ("q", "k", "v", "o")},
            "ln_attn": ln((L,)),
            "mlp": {"up": lin(d, dims.d_ff), "down": lin(dims.d_ff, d)},
            "ln_mlp": ln((L,)),
        },
    }


def _sum_in_windows(x: torch.Tensor) -> torch.Tensor:
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


def _layer_norm(p: Params, x: torch.Tensor, dtype: torch.dtype,
                eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of f32 rows, rounded to ``dtype``: the JAX package's
    mean, variance of the centered rows and rsqrt, its sums in XLA:CPU's
    order on the CPU."""
    if x.is_cuda:
        return layer_norm(p, x).to(dtype)
    inv_d = float(torch.tensor(1.0) / x.shape[-1])
    mu = _sum_in_windows(x) * inv_d
    c = x - mu[..., None]
    r = torch.rsqrt(_sum_in_windows(c * c) * inv_d + eps)
    return (c * r[..., None] * p["g"].float() + p["b"].float()).to(dtype)


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + h in f32, not rounded (a new tensor)."""
    return x.to(torch.float32, copy=True).add_(h)


def _attention(p: Params, x: torch.Tensor, n_heads: int,
               mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Masked self-attention of (B, T, d) ``dtype`` states → the output
    projection in ``dtype``."""
    B, T, d = x.shape
    hd = d // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    q, k, v = (heads(linear(p[a], x, dtype)) for a in ("q", "k", "v"))
    scale = float(torch.tensor(hd ** -0.5).to(dtype))
    logits = mm_f32(q.float() * scale, k.transpose(-1, -2))
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = mm_f32(probs, v).to(dtype).transpose(1, 2).reshape(B, T, d)
    return linear(p["o"], out, dtype)


def _gelu(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Exact GELU of ``dtype`` values as ``jax.nn.gelu`` computes it,
    0.5·u·erfc(−u·√½): the erfc (of an f32 argument) and the product
    rounded to ``dtype`` (halving is exact)."""
    c = float(torch.tensor(math.sqrt(0.5)).to(dtype))
    e = torch.special.erfc(u.to(torch.float32, copy=True).mul_(-c))
    e = e.to(dtype)
    return (u * e).mul_(0.5)


def bert_encode(params: Params, dims: BertDims, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Token ids (B, T) → contextual states (B, T, d_model) in ``dtype``."""
    if attention_mask is None:
        attention_mask = (tokens != dims.pad_id).long()
    attention_mask = attention_mask.long()
    # RoBERTa positions: pads keep the pad position, real tokens count up
    positions = (torch.cumsum(attention_mask, dim=1) * attention_mask
                 + dims.pos_offset - 1)
    # past the table (inputs longer than max_len) the last row repeats, as
    # JAX's clamping gather gives in the JAX package
    pos_table = params["pos_emb"]["table"]
    positions = torch.clamp(positions, max=pos_table.shape[0] - 1)
    x = (params["tok_emb"]["table"].to(dtype)[tokens].float()
         + pos_table.to(dtype)[positions].float())
    x = _layer_norm(params["ln_emb"], x, dtype)
    mask = attention_mask[:, None, None, :].bool()
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        h = _attention(p["attn"], x, dims.n_heads, mask, dtype)
        x = _layer_norm(p["ln_attn"], _residual(x, h), dtype)
        u = linear(p["mlp"]["up"], x, dtype)
        h = linear(p["mlp"]["down"], _gelu(u, dtype), dtype)
        x = _layer_norm(p["ln_mlp"], _residual(x, h), dtype)
    return x
