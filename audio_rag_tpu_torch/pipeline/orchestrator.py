"""``AudioRAG`` of the port (counterpart of
``audio_rag_tpu/pipeline/orchestrator.py``): one embedder, one store and
one generator shared by the ingestion and the query pipelines, built
lazily on the configured device (CUDA by default; a CUDA request without a
card raises), and the entry points ``from_config``, ``ingest`` (the JAX
argument order), ``ingest_batch``, ``query``, ``query_batch``,
``get_context``, ``status``, ``clear_collection`` and ``unload_all``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.config import AudioRAGConfig, load_config
from audio_rag_tpu_torch.pipeline.ingestion import (
    IngestionPipeline,
    IngestionResult,
)
from audio_rag_tpu_torch.pipeline.query import QueryPipeline, QueryResult
from audio_rag_tpu_torch.pipeline.stages import SharedStages
from audio_rag_tpu_torch.utils.decorators import get_stage_timings
from audio_rag_tpu_torch.utils.tracing import get_trace_summary

__all__ = ["AudioRAG"]


class AudioRAG(SharedStages):
    def __init__(self, config: AudioRAGConfig | None = None):
        super().__init__(config)
        logging.getLogger("audio_rag_tpu_torch").setLevel(
            self.config.log_level)
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
        device and its loaded stages, device memory, each collection's
        count, the ``@timed`` registry and the span summary."""
        cfg = self.config
        resources: dict[str, Any] = {"budget_gb": cfg.resources.max_hbm_gb}
        if self.device.type == "cuda":
            resources["device"] = {
                "bytes_in_use": torch.cuda.memory_allocated(self.device),
                "max_bytes_in_use":
                    torch.cuda.max_memory_allocated(self.device)}
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
            "engine": {
                "device": str(self.device),
                "models": [name for name, stage in (
                    ("asr", self.ingestion._asr),
                    ("diarizer", self.ingestion._diarizer),
                    ("embedder", self._embedder),
                    ("generator", self._generator),
                    ("reranker", self.querying._reranker))
                    if stage is not None and stage.is_loaded],
            },
            "resources": resources,
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
        """Release every model the pipeline loaded, as the JAX
        orchestrator's ``unload_all`` does: the generator's scheduler (the
        wave thread, or the continuous batcher's thread and its cache)
        stops and its weights go, the TTS backend's too, and each stage is
        built anew on its next use. The store stays."""
        self.unload_shared()
        self.ingestion.unload()
        self.querying.unload()
