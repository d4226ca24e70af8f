"""The reranker factory (counterpart of
``audio_rag_tpu/reranking/base.py::create_reranker``): backend "none"
gives None, as the JAX package's does."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import RerankingConfig

__all__ = ["create_reranker"]


def create_reranker(config: RerankingConfig | None = None,
                    device: str | torch.device = "cuda"):
    """The reranker that ``config.backend`` names, on ``device``, or None
    for "none" (the config refuses any other name)."""
    from audio_rag_tpu_torch.reranking.bge import BGEReranker
    from audio_rag_tpu_torch.reranking.fake import FakeReranker

    config = config or RerankingConfig()
    if config.backend == "none":
        return None
    if config.backend == "fake":
        return FakeReranker(config)
    return BGEReranker(config, device=device)
