"""``AudioRAG`` of the port: ingest audio into a collection, query it.

Follows ``audio_rag_tpu/pipeline/ingestion.py::IngestionPipeline.ingest``
and ``pipeline/query.py::QueryPipeline`` with contextual headers, query
expansion, answer generation and TTS off:

* ingest: transcribe with DTW word times → (``diarize=True``, the default)
  diarize → attribute words to speakers → rebuild the transcript by
  speaker turn → speaker-turn chunks → BGE-M3 dense + sparse embeddings →
  the device-resident store;
* query: without a metadata filter, the batched
  :class:`~audio_rag_tpu_torch.engine.query_engine.QueryEngine` (embed →
  dense / sparse / hybrid (RRF) search → top ``initial_k`` → cross-encoder
  → top ``top_k``); with one, embed → filtered search of ``initial_k``
  (``top_k`` without reranking) → rerank with the query. Reranking is on
  unless the config's backend is "none" or the call passes
  ``rerank=False``.

Components are built lazily on the configured device (CUDA by default; a
CUDA request without a card raises).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np

from audio_rag_tpu_torch.alignment.aligner import (
    align_words_to_speakers,
    build_speaker_transcript,
)
from audio_rag_tpu_torch.asr.whisper import WhisperASR
from audio_rag_tpu_torch.chunking.speaker_turn import SpeakerTurnChunker
from audio_rag_tpu_torch.config import AudioRAGConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.diarization import create_diarizer
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.engine.query_engine import QueryEngine
from audio_rag_tpu_torch.reranking import create_reranker
from audio_rag_tpu_torch.retrieval.store import VectorStore

__all__ = ["AudioRAG", "IngestionResult", "QueryResult", "format_context",
           "format_timestamp"]


def format_timestamp(seconds: float) -> str:
    """``MM:SS`` (copy of ``audio_rag_tpu/generation/prompts.py``)."""
    m, s = divmod(int(max(seconds, 0)), 60)
    return f"{m:02d}:{s:02d}"


def format_context(results: list[RetrievalResult]) -> str:
    """The XML-like context block for an external LLM."""
    parts = ["<context>"]
    for i, r in enumerate(results, 1):
        parts.append(
            f'  <excerpt id="{i}" speaker="{r.speaker or "unknown"}" '
            f'start="{r.start:.1f}" end="{r.end:.1f}">')
        parts.append(f"    {r.text}")
        parts.append("  </excerpt>")
    parts.append("</context>")
    return "\n".join(parts)


def _build_response(results: list[RetrievalResult]) -> str:
    """``[speaker at MM:SS] text`` lines, one per result."""
    if not results:
        return "No relevant content found."
    return "\n\n".join(
        f"[{r.speaker or 'Speaker'} at {format_timestamp(r.start)}] {r.text}"
        for r in results)


@dataclass
class IngestionResult:
    source: str
    collection: str
    num_segments: int
    num_chunks: int
    num_speakers: int
    duration_s: float
    elapsed_s: float
    stage_timings: dict[str, float] = field(default_factory=dict)


@dataclass
class QueryResult:
    query: str
    results: list[RetrievalResult]
    response: str
    answer: str | None = None
    audio: bytes | None = None
    expanded_query: str | None = None
    elapsed_s: float = 0.0
    stage_timings: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "query": self.query,
            "results": [r.to_dict() for r in self.results],
            "response": self.response,
            "answer": self.answer,
            "expanded_query": self.expanded_query,
            "elapsed_s": self.elapsed_s,
            "stage_timings": self.stage_timings,
            "has_audio": self.audio is not None,
        }


class AudioRAG:
    def __init__(self, config: AudioRAGConfig | None = None):
        self.config = config or AudioRAGConfig()
        self.device = resolve_device(self.config.device)
        self._asr: WhisperASR | None = None
        self._diarizer = None
        self._embedder: BGEM3Embedder | None = None
        self._reranker = None
        self._reranker_built = False
        self._engine: QueryEngine | None = None
        self.chunker = SpeakerTurnChunker(self.config.chunking)
        self.store = VectorStore(self.config.retrieval, device=self.device)

    @property
    def asr(self) -> WhisperASR:
        if self._asr is None:
            self._asr = WhisperASR(self.config.asr, device=self.device)
        self._asr.load()
        return self._asr

    @property
    def diarizer(self):
        if self._diarizer is None:
            self._diarizer = create_diarizer(self.config.diarization,
                                             device=self.device)
        self._diarizer.load()
        return self._diarizer

    @property
    def embedder(self) -> BGEM3Embedder:
        if self._embedder is None:
            self._embedder = BGEM3Embedder(self.config.embedding,
                                           device=self.device)
        self._embedder.load()
        return self._embedder

    @property
    def reranker(self):
        """The configured reranker, loaded; None for backend "none"."""
        if not self._reranker_built:
            self._reranker = create_reranker(self.config.reranking,
                                             device=self.device)
            self._reranker_built = True
        if self._reranker is not None:
            self._reranker.load()
        return self._reranker

    @property
    def query_engine(self) -> QueryEngine:
        if self._engine is None:
            self._engine = QueryEngine(self.embedder, self.store)
        return self._engine

    def _engine_for(self, collection: str | None,
                    do_rerank: bool) -> QueryEngine:
        engine = self.query_engine
        engine.collection = collection
        engine.reranker = self.reranker if do_rerank else None
        return engine

    def _do_rerank(self, rerank: bool | None) -> bool:
        return (self.config.reranking.backend != "none" if rerank is None
                else rerank)

    def ingest(self, audio: str | Path | np.ndarray,
               collection: str | None = None, diarize: bool = True,
               sample_rate: int | None = None,
               metadata: dict[str, Any] | None = None) -> IngestionResult:
        """transcribe → (diarize → align) → chunk → embed → store."""
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        source = (str(audio) if not isinstance(audio, np.ndarray)
                  else "<array>")
        collection = collection or self.config.retrieval.collection_name

        t0 = time.perf_counter()
        segments = self.asr.transcribe_with_words(audio, sample_rate)
        timings["transcribe"] = time.perf_counter() - t0
        if not segments:
            return IngestionResult(source, collection, 0, 0, 0, 0.0,
                                   time.perf_counter() - t_start, timings)
        if diarize:
            t0 = time.perf_counter()
            diar = self.diarizer.diarize(audio, sample_rate)
            timings["diarize"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            words = [w for s in segments for w in s.words]
            aligned = align_words_to_speakers(
                words, diar, self.config.alignment.tolerance_s)
            segments = build_speaker_transcript(aligned)
            timings["align"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chunks = self.chunker.chunk(segments)
        meta = {"source": source, **(metadata or {})}
        for c in chunks:
            c.metadata.update(meta)
        timings["chunk"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        embeddings = self.embedder.embed([c.text for c in chunks])
        timings["embed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.store.add(chunks, embeddings, collection)
        timings["index"] = time.perf_counter() - t0
        speakers = ({s.speaker for s in segments if s.speaker}
                    or {c.speaker for c in chunks if c.speaker})
        return IngestionResult(
            source=source, collection=collection,
            num_segments=len(segments), num_chunks=len(chunks),
            num_speakers=len(speakers),
            duration_s=round(max(s.end for s in segments), 3),
            elapsed_s=time.perf_counter() - t_start, stage_timings=timings)

    def query(self, query: str, top_k: int | None = None,
              search_type: str | None = None,
              collection: str | None = None, use_hyde: bool | None = None,
              rerank: bool | None = None, generate_answer: bool = False,
              speak_answer: bool = False,
              metadata_filter: dict[str, Any] | None = None) -> QueryResult:
        """The top ``top_k`` chunks for ``query``, reranked unless the
        config's backend is "none" or ``rerank=False``; ``response`` holds
        them as ``[speaker at MM:SS] text`` lines."""
        for name, on in (("use_hyde", use_hyde),
                         ("generate_answer", generate_answer),
                         ("speak_answer", speak_answer)):
            if on:
                raise ConfigError(
                    f"{name}=True needs the LLM (HyDE, answers, speech), "
                    "which is not ported yet (ROADMAP.md §1 item 7)",
                    context={name: on})
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        top_k = top_k or self.config.retrieval.top_k
        search_type = search_type or self.config.retrieval.search_type
        do_rerank = self._do_rerank(rerank)
        initial_k = self.config.reranking.initial_k

        def clock(name: str, t0: float) -> float:
            timings[name] = round(time.perf_counter() - t0, 4)
            return time.perf_counter()

        t0 = time.perf_counter()
        if metadata_filter is None:
            engine = self._engine_for(collection, do_rerank)
            results = engine.query_batch(
                [query], top_k=top_k, search_type=search_type,
                initial_k=initial_k, rerank=do_rerank)[0]
            clock("fused", t0)
        else:
            emb = self.embedder.embed_query(query)
            t0 = clock("embed", t0)
            results = self.store.search(
                emb, top_k=initial_k if do_rerank else top_k,
                search_type=search_type, collection=collection,
                metadata_filter=metadata_filter)
            t0 = clock("search", t0)
            reranker = self.reranker if do_rerank else None
            if reranker is not None and results:
                results = reranker.rerank(query, results, top_k)
                clock("rerank", t0)
            else:
                results = results[:top_k]
        return QueryResult(
            query=query, results=results,
            response=_build_response(results),
            elapsed_s=round(time.perf_counter() - t_start, 4),
            stage_timings=timings)

    def query_batch(self, queries: list[str], top_k: int | None = None,
                    search_type: str | None = None,
                    collection: str | None = None,
                    rerank: bool | None = None) -> list[QueryResult]:
        """Many queries through the query engine at once; each result's
        ``elapsed_s`` is the batch's time over the query count."""
        top_k = top_k or self.config.retrieval.top_k
        search_type = search_type or self.config.retrieval.search_type
        do_rerank = self._do_rerank(rerank)
        engine = self._engine_for(collection, do_rerank)
        t0 = time.perf_counter()
        rows = engine.query_batch(
            queries, top_k=top_k, search_type=search_type,
            initial_k=self.config.reranking.initial_k, rerank=do_rerank)
        dt = round((time.perf_counter() - t0) / max(len(queries), 1), 4)
        return [QueryResult(query=q, results=row,
                            response=_build_response(row), elapsed_s=dt)
                for q, row in zip(queries, rows)]

    def get_context(self, query: str, top_k: int | None = None,
                    search_type: str | None = None,
                    collection: str | None = None) -> str:
        """:func:`format_context` of :meth:`query`'s results."""
        return format_context(self.query(
            query, top_k=top_k, search_type=search_type,
            collection=collection).results)

    def count(self, collection: str | None = None) -> int:
        return self.store.count(collection)

    def delete_collection(self, collection: str | None = None) -> bool:
        return self.store.delete_collection(collection)
