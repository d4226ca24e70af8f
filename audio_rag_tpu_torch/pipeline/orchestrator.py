"""``AudioRAG`` of the port (counterpart of
``audio_rag_tpu/pipeline/orchestrator.py``): one embedder, one store and
one generator shared by the ingestion and the query pipelines, built
lazily on the configured device (CUDA by default; a CUDA request without a
card raises), and the entry points ``from_config``, ``ingest`` (the JAX
argument order), ``ingest_batch``, ``query``, ``query_batch``,
``get_context``, ``status``, ``clear_collection`` and ``unload_all``.

Its backends book their device memory with the process-wide
:class:`~audio_rag_tpu_torch.resources.manager.ResourceManager`, whose
budget the pipeline sets from ``resources.max_hbm_gb``; under
``resources.pin_query_models`` the embedder and the reranker are never
evicted. A backend the manager evicted loads again at its next use.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np

from audio_rag_tpu_torch.config import AudioRAGConfig, load_config
from audio_rag_tpu_torch.engine.engine import get_engine
from audio_rag_tpu_torch.pipeline.ingestion import (
    IngestionPipeline,
    IngestionResult,
)
from audio_rag_tpu_torch.pipeline.query import QueryPipeline, QueryResult
from audio_rag_tpu_torch.pipeline.stages import SharedStages
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.utils.decorators import get_stage_timings
from audio_rag_tpu_torch.utils.tracing import get_trace_summary

__all__ = ["AudioRAG"]


class AudioRAG(SharedStages):
    def __init__(self, config: AudioRAGConfig | None = None):
        super().__init__(config)
        logging.getLogger("audio_rag_tpu_torch").setLevel(
            self.config.log_level)
        rm = get_resource_manager(self.config.resources.max_hbm_gb)
        if self.config.resources.pin_query_models:
            # the query path's models stay while ingest swaps around them
            rm.pin("embeddings")
            rm.pin("reranking")
        self.ingestion = IngestionPipeline(stages=self)
        self.querying = QueryPipeline(stages=self)

    @classmethod
    def from_config(cls, config_path: str | Path | None = None,
                    env: str | None = None,
                    configs_dir: str | Path = "configs") -> "AudioRAG":
        """An ``AudioRAG`` on :func:`load_config`'s layered config
        (``AUDIO_RAG__DEVICE=cpu`` runs it on the CPU)."""
        return cls(load_config(config_path, env, configs_dir))

    # -- the stages, as attributes of the pipeline --------------------------------
    @property
    def asr(self):
        return self.ingestion.asr

    @property
    def diarizer(self):
        return self.ingestion.diarizer

    @property
    def reranker(self):
        return self.querying.reranker

    # -- ingestion ----------------------------------------------------------------
    def ingest(self, audio: str | Path | np.ndarray,
               sample_rate: int | None = None,
               collection: str | None = None, diarize: bool = True,
               metadata: dict[str, Any] | None = None) -> IngestionResult:
        """transcribe → (diarize → align) → chunk → (contextualize) →
        embed → store."""
        return self.ingestion.ingest(audio, sample_rate, collection, diarize,
                                     metadata)

    def ingest_batch(self, audios: list, collection: str | None = None,
                     **kw: Any) -> list[IngestionResult]:
        return self.ingestion.ingest_batch(audios, collection, **kw)

    # -- querying -----------------------------------------------------------------
    def query(self, query: str, **kw: Any) -> QueryResult:
        return self.querying.query(query, **kw)

    def query_batch(self, queries: list[str], **kw: Any) -> list[QueryResult]:
        return self.querying.query_batch(queries, **kw)

    def get_context(self, query: str, **kw: Any) -> str:
        return self.querying.get_context_for_llm(query, **kw)

    # -- management ---------------------------------------------------------------
    def status(self) -> dict[str, Any]:
        """The JAX orchestrator's keys: the configured backends, the
        engine's device and models, the manager's budget, bookings,
        evictions and the card's memory, each collection's count, the
        ``@timed`` registry and the span summary."""
        cfg = self.config
        return {
            "config": {
                "asr": cfg.asr.backend,
                "asr_model": cfg.asr.model_size,
                "diarization": cfg.diarization.backend,
                "embedding": cfg.embedding.backend,
                "retrieval": cfg.retrieval.backend,
                "search_type": cfg.retrieval.search_type,
                "reranking": cfg.reranking.backend,
                "generation": cfg.generation.backend,
            },
            "engine": get_engine(self.device).status(),
            "resources": get_resource_manager().status(),
            "collections": {name: self.store.count(name)
                            for name in self.store.list_collections()},
            "stage_timings": get_stage_timings(),
            "traces": get_trace_summary(),
        }

    def clear_collection(self, collection: str | None = None) -> bool:
        return self.store.delete_collection(collection)

    def count(self, collection: str | None = None) -> int:
        return self.store.count(collection)

    def delete_collection(self, collection: str | None = None) -> bool:
        return self.store.delete_collection(collection)

    def unload_all(self) -> None:
        """Release every model, as the JAX orchestrator's ``unload_all``
        does: the manager unloads every backend it booked; then what only
        the port holds goes too: the generator's scheduler (the wave
        thread, or the continuous batcher's thread and its cache) stops,
        the TTS backend unloads, and each stage is built anew on its next
        use. The store stays."""
        get_resource_manager().unload_all()
        self.unload_shared()
        self.ingestion.unload()
        self.querying.unload()
