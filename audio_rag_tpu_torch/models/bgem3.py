"""BGE-M3 embedding model (counterpart of ``audio_rag_tpu/models/bgem3.py``):
one forward → L2-normalized CLS dense vector and ReLU lexical weights per
token position."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.models.bert import BertDims, bert_encode, init_bert
from audio_rag_tpu_torch.models.layers import Params, linear

__all__ = ["init_bgem3", "bgem3_forward"]


def init_bgem3(dims: BertDims, seed: int = 0,
               device: str | torch.device = "cpu",
               dtype: torch.dtype = torch.float32) -> Params:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    bert = init_bert(dims, gen, device, dtype)
    w = torch.randn((dims.d_model, 1), generator=gen, device=device)
    return {"bert": bert,
            "sparse": {"w": (w * dims.d_model ** -0.5).to(dtype),
                       "b": torch.zeros((1,), dtype=dtype, device=device)}}


def bgem3_forward(params: Params, dims: BertDims, tokens: torch.Tensor,
                  attention_mask: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (dense (B, d_model) f32 L2-normalized, token weights (B, T)
    f32, 0 at padding)."""
    h = bert_encode(params["bert"], dims, tokens, attention_mask, dtype)
    cls = h[:, 0, :].float()
    dense = cls / torch.clamp(torch.linalg.vector_norm(cls, dim=-1,
                                                       keepdim=True),
                              min=1e-9)
    w = torch.relu(linear(params["sparse"], h, dtype)).float()
    w = w[..., 0] * attention_mask.float()
    return dense, w
