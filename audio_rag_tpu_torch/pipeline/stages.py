"""The stages both halves of the pipeline share: one embedder, one store,
one generator (and the query engine over the embedder and the store),
built lazily on the config's device. :class:`~audio_rag_tpu_torch.
pipeline.orchestrator.AudioRAG` is such a holder and hands itself to its
ingestion and query pipelines, as the JAX orchestrator hands its embedder
and retriever to both; a pipeline built alone makes its own.
"""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import AudioRAGConfig, RetrievalConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.embeddings import create_embedder
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.engine.query_engine import QueryEngine
from audio_rag_tpu_torch.generation.base import create_generator
from audio_rag_tpu_torch.retrieval.store import VectorStore

__all__ = ["SharedStages", "create_store"]


def create_store(config: RetrievalConfig,
                 device: str | torch.device = "cuda") -> VectorStore:
    """The store ``config.backend`` names: "tpu" (the schema's name of the
    in-process store) → :class:`VectorStore` on ``device``; "fake" is
    registered nowhere, in the JAX package either."""
    if config.backend != "tpu":
        raise ConfigError(f"retrieval backend {config.backend!r} is not "
                          "registered; use 'tpu' (the store on the card)",
                          context={"backend": config.backend})
    return VectorStore(config, device=device)


class SharedStages:
    def __init__(self, config: AudioRAGConfig | None = None):
        self.config = config or AudioRAGConfig()
        self.device = resolve_device(self.config.device)
        self._embedder = None
        self._generator = None
        self._generator_built = False
        self._engine: QueryEngine | None = None
        self.store = create_store(self.config.retrieval, self.device)

    @property
    def embedder(self):
        """The configured embedder, loaded."""
        if self._embedder is None:
            self._embedder = create_embedder(self.config.embedding,
                                             device=self.device)
        self._embedder.load()
        return self._embedder

    @property
    def generator(self):
        """The configured generator, loaded; None for backend "none"."""
        if not self._generator_built:
            self._generator = create_generator(self.config.generation,
                                               device=self.device)
            self._generator_built = True
        if self._generator is not None:
            self._generator.load()
        return self._generator

    @property
    def query_engine(self) -> QueryEngine | None:
        """The batched query engine (embed → search → rerank on the card)
        when the embedder is BGE-M3, as the JAX pipeline's fused engine;
        None for the other embedders."""
        if self._engine is None and isinstance(self.embedder, BGEM3Embedder):
            self._engine = QueryEngine(self.embedder, self.store)
        return self._engine

    def unload_shared(self) -> None:
        """Stop the generator's scheduler, drop its weights and the
        embedder's; each is built anew on its next use. The store stays."""
        if self._generator is not None:
            self._generator.unload()
        self._embedder = self._engine = self._generator = None
        self._generator_built = False
