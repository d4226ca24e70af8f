"""Cross-encoder over (query, passage) pairs (counterpart of
``audio_rag_tpu/models/cross_encoder.py``): the XLM-R
sequence-classification head — dense → tanh → out on the CLS state — over
``<s> query </s></s> passage </s>`` rows. ``n_out`` 1 is the reranker's
relevance logit, 3 the NLI head's contradiction / neutral / entailment
logits (the roberta-mnli label order).
"""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.models.bert import BertDims, bert_encode, init_bert
from audio_rag_tpu_torch.models.layers import Params, linear, mm_f32

__all__ = ["init_cross_encoder", "cross_encoder_forward", "nli_forward"]


def init_cross_encoder(dims: BertDims, n_out: int = 1, seed: int = 0,
                       device: str | torch.device = "cpu",
                       dtype: torch.dtype = torch.float32) -> Params:
    """Seeded random parameters in the JAX package's layout
    ({"bert", "dense", "out"}; normal·d_in^-½ linears, zero biases)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = dims.d_model

    def lin(din, dout):
        w = torch.randn((din, dout), generator=gen, device=device)
        return {"w": (w * din ** -0.5).to(dtype),
                "b": torch.zeros((dout,), dtype=dtype, device=device)}

    return {"bert": init_bert(dims, gen, device, dtype),
            "dense": lin(d, d), "out": lin(d, n_out)}


def _head(params: Params, dims: BertDims, tokens: torch.Tensor,
          attention_mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """CLS → dense (rounded to ``dtype``) → tanh (kept f32, as the JAX
    package's compiled program keeps it) → out, rounded to ``dtype``."""
    h = bert_encode(params["bert"], dims, tokens, attention_mask, dtype)
    pooled = torch.tanh(linear(params["dense"], h[:, 0, :], dtype).float())
    out = params["out"]
    y = mm_f32(pooled, out["w"].to(dtype)) + out["b"].to(dtype).float()
    return y.to(dtype).float()


def cross_encoder_forward(params: Params, dims: BertDims,
                          tokens: torch.Tensor, attention_mask: torch.Tensor,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """Relevance scores (B,) f32 (pre-sigmoid logits)."""
    return _head(params, dims, tokens, attention_mask, dtype)[..., 0]


def nli_forward(params: Params, dims: BertDims, tokens: torch.Tensor,
                attention_mask: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NLI class logits (B, n_labels) f32 over ``<s> premise </s></s>
    hypothesis </s>`` rows."""
    return _head(params, dims, tokens, attention_mask, dtype)
