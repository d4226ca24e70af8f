"""XLM-RoBERTa-style bidirectional encoder (counterpart of
``audio_rag_tpu/models/bert.py``): post-LN blocks, learned positions with
the RoBERTa offset, exact-GELU FFN, layers stacked on a leading L axis.
Padding is masked, so attention takes the einsum path of ``_attend``.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_rag_tpu_torch.models.layers import (
    Params,
    layer_norm,
    mha,
    mlp,
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
    "test": BertDims(1024, 64, 2, 2, 128, 128),
    # the committed trained retrieval embedder's shapes
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


def bert_encode(params: Params, dims: BertDims, tokens: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Token ids (B, T) → contextual states (B, T, d_model)."""
    if attention_mask is None:
        attention_mask = (tokens != dims.pad_id).long()
    attention_mask = attention_mask.long()
    x = params["tok_emb"]["table"].to(dtype)[tokens]
    # RoBERTa positions: pads keep the pad position, real tokens count up
    positions = (torch.cumsum(attention_mask, dim=1) * attention_mask
                 + dims.pos_offset - 1)
    # past the table (inputs longer than max_len) the last row repeats, as
    # JAX's clamping gather gives in the JAX package
    pos_table = params["pos_emb"]["table"]
    positions = torch.clamp(positions, max=pos_table.shape[0] - 1)
    x = x + pos_table.to(dtype)[positions]
    x = layer_norm(params["ln_emb"], x)
    mask = attention_mask[:, None, None, :].bool()
    for i in range(dims.n_layers):
        p = take_layer(params["blocks"], i)
        h, _ = mha(p["attn"], x, dims.n_heads, mask=mask, dtype=dtype)
        x = layer_norm(p["ln_attn"], x + h)  # post-LN
        x = layer_norm(p["ln_mlp"], x + mlp(p["mlp"], x, dtype))
    return x
