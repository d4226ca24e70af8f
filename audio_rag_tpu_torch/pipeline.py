"""``AudioRAG`` of the port: ingest audio into a collection, query it.

Follows ``audio_rag_tpu/pipeline/ingestion.py::IngestionPipeline.ingest``
and ``pipeline/query.py::QueryPipeline.query`` with contextual headers,
reranking, query expansion, answer generation and TTS off:

* ingest: transcribe with DTW word times → (``diarize=True``, the default)
  diarize → attribute words to speakers → rebuild the transcript by
  speaker turn → speaker-turn chunks → BGE-M3 dense + sparse embeddings →
  the device-resident store;
* query: embed the query → dense / sparse / hybrid (RRF) search → top-k.

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
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.diarization import create_diarizer
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.retrieval.store import VectorStore

__all__ = ["AudioRAG", "IngestionResult", "QueryResult"]


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
    elapsed_s: float = 0.0
    stage_timings: dict[str, float] = field(default_factory=dict)


class AudioRAG:
    def __init__(self, config: AudioRAGConfig | None = None):
        self.config = config or AudioRAGConfig()
        self.device = resolve_device(self.config.device)
        self._asr: WhisperASR | None = None
        self._diarizer = None
        self._embedder: BGEM3Embedder | None = None
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
              collection: str | None = None) -> QueryResult:
        """embed the query → search → the top ``top_k`` results."""
        t_start = time.perf_counter()
        top_k = top_k or self.config.retrieval.top_k
        search_type = search_type or self.config.retrieval.search_type
        t0 = time.perf_counter()
        emb = self.embedder.embed_query(query)
        t1 = time.perf_counter()
        results = self.store.search(emb, top_k=top_k,
                                    search_type=search_type,
                                    collection=collection)[:top_k]
        t2 = time.perf_counter()
        return QueryResult(query=query, results=results,
                           elapsed_s=t2 - t_start,
                           stage_timings={"embed": t1 - t0,
                                          "search": t2 - t1})

    def count(self, collection: str | None = None) -> int:
        return self.store.count(collection)

    def delete_collection(self, collection: str | None = None) -> bool:
        return self.store.delete_collection(collection)
