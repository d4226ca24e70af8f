"""Embedders of the port, by the config's backend name through
:func:`create_embedder`."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import EmbeddingConfig

__all__ = ["create_embedder"]


def create_embedder(config: EmbeddingConfig | None = None,
                    device: str | torch.device = "cuda"):
    """"bge-m3" → :class:`BGEM3Embedder`, "multilingual-e5" →
    :class:`E5Embedder` (both on ``device``), "fake" →
    :class:`FakeEmbedder`."""
    config = config or EmbeddingConfig()
    if config.backend == "fake":
        from audio_rag_tpu_torch.embeddings.fake import FakeEmbedder

        return FakeEmbedder(config)
    if config.backend == "multilingual-e5":
        from audio_rag_tpu_torch.embeddings.e5 import E5Embedder

        return E5Embedder(config, device=device)
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder

    return BGEM3Embedder(config, device=device)
