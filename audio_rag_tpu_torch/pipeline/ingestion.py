"""Ingestion pipeline of the port (counterpart of
``audio_rag_tpu/pipeline/ingestion.py``): transcribe with word times →
(``diarize=True``, the default) diarize → attribute words to speakers →
rebuild the transcript by speaker turn → chunk (the config's strategy) →
(``contextual.enabled``) ``[Context: ...]`` headers → embed → store.

* ``checkpoint_cb(stage, data)`` fires with JSON-ready data after the
  audio stages (``"aligned"``, with the segments, also without
  diarization) and after chunking (``"chunked"``, or ``"contextualized"``
  with headers on, with the chunks); a callback that raises is logged and
  the ingest goes on. ``resume`` (such a checkpoint with its ``"stage"``)
  skips the finished stages and keeps the checkpoint's chunk ids.
* :meth:`IngestionPipeline.ingest_batch` runs every file's audio stages,
  then every file's headers (one ``process_chunks`` call a file, so each
  header wave is the batch the per-file loop makes), then embeds and
  stores each file in order: the per-file loop's outputs, with the header
  model's turn grouped. One file, headers off, or ``checkpoint_cb``/
  ``resume`` take the per-file loop.
* Stage seconds are rounded to the millisecond, as in the JAX pipeline;
  the ``ingest.*`` spans and the ``@timed`` registry record them too.

Components are built lazily on the config's device.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from audio_rag_tpu_torch.alignment.aligner import (
    align_words_to_speakers,
    build_speaker_transcript,
)
from audio_rag_tpu_torch.asr import create_asr
from audio_rag_tpu_torch.chunking import create_chunker
from audio_rag_tpu_torch.config import AudioRAGConfig
from audio_rag_tpu_torch.contextual.processor import ContextualProcessor
from audio_rag_tpu_torch.core.types import AudioChunk, TranscriptSegment
from audio_rag_tpu_torch.diarization import create_diarizer
from audio_rag_tpu_torch.pipeline.stages import SharedStages
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.utils.tracing import span

log = logging.getLogger(__name__)

__all__ = ["IngestionPipeline", "IngestionResult"]


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

    def to_dict(self) -> dict[str, Any]:
        return {
            "source": self.source,
            "collection": self.collection,
            "num_segments": self.num_segments,
            "num_chunks": self.num_chunks,
            "num_speakers": self.num_speakers,
            "duration_s": self.duration_s,
            "elapsed_s": self.elapsed_s,
            "stage_timings": self.stage_timings,
        }


def _source(audio) -> str:
    return str(audio) if not isinstance(audio, np.ndarray) else "<array>"


def _result(source: str, collection: str, segments: list, chunks: list,
            t_start: float, timings: dict[str, float]) -> IngestionResult:
    speakers = ({s.speaker for s in segments if s.speaker}
                or {c.speaker for c in chunks if c.speaker})
    duration = max((s.end for s in segments),
                   default=max((c.end for c in chunks), default=0.0))
    return IngestionResult(
        source=source, collection=collection, num_segments=len(segments),
        num_chunks=len(chunks), num_speakers=len(speakers),
        duration_s=round(duration, 3),
        elapsed_s=round(time.perf_counter() - t_start, 3),
        stage_timings=timings)


class IngestionPipeline:
    def __init__(self, config: AudioRAGConfig | None = None,
                 stages: SharedStages | None = None,
                 progress_callback: Callable[[str, float], None] | None
                 = None):
        self.stages = stages or SharedStages(config)
        self.config = self.stages.config
        self.progress_callback = progress_callback
        self._asr = None
        self._diarizer = None
        self._chunker = None
        self._contextual: ContextualProcessor | None = None

    # -- lazy components ------------------------------------------------------
    @property
    def asr(self):
        if self._asr is None:
            self._asr = create_asr(self.config.asr, device=self.stages.device)
        self._asr.load()
        return self._asr

    @property
    def diarizer(self):
        if self._diarizer is None:
            self._diarizer = create_diarizer(self.config.diarization,
                                             device=self.stages.device)
        self._diarizer.load()
        return self._diarizer

    @property
    def chunker(self):
        if self._chunker is None:
            self._chunker = create_chunker(self.config.chunking)
        return self._chunker

    @property
    def contextual(self) -> ContextualProcessor:
        """The header writer, over the shared generator when its backend
        is "llm" (none is built for "extractive")."""
        if self._contextual is None:
            cfg = self.config.contextual
            self._contextual = ContextualProcessor(
                cfg, self.stages.generator if cfg.backend == "llm" else None)
        return self._contextual

    def unload(self) -> None:
        """Drop the stages this pipeline built (rebuilt on next use)."""
        self._asr = self._diarizer = self._chunker = None
        self._contextual = None

    def _progress(self, stage: str, frac: float) -> None:
        if self.progress_callback:
            try:
                self.progress_callback(stage, frac)
            except Exception:
                pass

    def _audio_stages(self, audio, sample_rate: int | None, diarize: bool,
                      timings: dict[str, float],
                      progress: bool = False) -> list[TranscriptSegment]:
        """transcribe → (diarize → align): the speaker-turn transcript."""
        t0 = time.perf_counter()
        if progress:
            self._progress("transcribing", 0.0)
        with span("ingest.transcribe"):
            segments = self.asr.transcribe_with_words(audio, sample_rate)
        timings["transcribe"] = round(time.perf_counter() - t0, 3)
        if segments and diarize:
            if progress:
                self._progress("diarizing", 0.2)
            t0 = time.perf_counter()
            with span("ingest.diarize"):
                diar = self.diarizer.diarize(audio, sample_rate)
            timings["diarize"] = round(time.perf_counter() - t0, 3)
            if progress:
                self._progress("aligning", 0.4)
            t0 = time.perf_counter()
            words = [w for s in segments for w in s.words]
            aligned = align_words_to_speakers(
                words, diar, self.config.alignment.tolerance_s)
            segments = build_speaker_transcript(aligned)
            timings["align"] = round(time.perf_counter() - t0, 3)
        return segments

    def _store(self, chunks: list[AudioChunk], collection: str,
               timings: dict[str, float], progress: bool = False) -> None:
        """embed → index."""
        if progress:
            self._progress("embedding", 0.7)
        t0 = time.perf_counter()
        with span("ingest.embed"):
            embeddings = self.stages.embedder.embed([c.text for c in chunks])
        timings["embed"] = round(time.perf_counter() - t0, 3)
        if progress:
            self._progress("indexing", 0.9)
        t0 = time.perf_counter()
        with span("ingest.index"):
            self.stages.store.add(chunks, embeddings, collection)
        timings["index"] = round(time.perf_counter() - t0, 3)

    # -- entry points -----------------------------------------------------------
    @timed
    def ingest(self, audio: str | Path | np.ndarray,
               sample_rate: int | None = None,
               collection: str | None = None, diarize: bool = True,
               metadata: dict[str, Any] | None = None,
               checkpoint_cb: Callable[[str, dict[str, Any]], None] | None
               = None,
               resume: dict[str, Any] | None = None) -> IngestionResult:
        """The ingest of one file; see the module docstring for
        ``checkpoint_cb`` and ``resume``."""
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        source = _source(audio)
        collection = collection or self.config.retrieval.collection_name

        def ckpt(stage: str, data: dict[str, Any]) -> None:
            if checkpoint_cb:
                try:
                    checkpoint_cb(stage, data)
                except Exception as exc:
                    log.warning("checkpoint %s failed: %s", stage, exc)

        resume_stage = (resume or {}).get("stage")
        segments: list[TranscriptSegment] = []
        chunks: list[AudioChunk] = []
        if resume_stage in ("transcribed", "aligned"):
            segments = [TranscriptSegment.from_dict(d)
                        for d in resume["segments"]]
        if resume_stage in ("chunked", "contextualized"):
            chunks = [AudioChunk.from_dict(d) for d in resume["chunks"]]

        if not segments and not chunks:
            segments = self._audio_stages(audio, sample_rate, diarize,
                                          timings, progress=True)
            if not segments:
                return _result(source, collection, [], [], t_start, timings)
            ckpt("aligned", {"segments": [s.to_dict() for s in segments]})

        if not chunks:
            self._progress("chunking", 0.5)
            t0 = time.perf_counter()
            chunks = self.chunker.chunk(segments)
            timings["chunk"] = round(time.perf_counter() - t0, 3)
            if self.config.contextual.enabled:
                self._progress("contextualizing", 0.6)
                t0 = time.perf_counter()
                chunks = self.contextual.process_chunks(chunks)
                timings["contextualize"] = round(time.perf_counter() - t0, 3)
            ckpt("contextualized" if self.config.contextual.enabled
                 else "chunked", {"chunks": [c.to_dict() for c in chunks]})

        meta = {"source": source, **(metadata or {})}
        for c in chunks:
            c.metadata.update(meta)
        self._store(chunks, collection, timings, progress=True)
        self._progress("done", 1.0)
        return _result(source, collection, segments, chunks, t_start,
                       timings)

    def ingest_batch(self, audios: list[str | Path | np.ndarray],
                     collection: str | None = None,
                     metadatas: list[dict[str, Any] | None] | None = None,
                     **kw: Any) -> list[IngestionResult]:
        """Many files, stage-grouped when contextual headers are on (see
        the module docstring); ``metadatas`` gives each file its own
        metadata on top of ``metadata`` in ``kw``."""
        if (len(audios) <= 1 or not self.config.contextual.enabled
                or kw.get("checkpoint_cb") or kw.get("resume")):
            metas = metadatas or [None] * len(audios)
            return [self.ingest(a, collection=collection,
                                **{**kw, "metadata": {
                                    **(kw.get("metadata") or {}),
                                    **(m or {})}})
                    for a, m in zip(audios, metas)]

        sample_rate = kw.get("sample_rate")
        diarize = kw.get("diarize", True)
        metadata = kw.get("metadata")
        collection = collection or self.config.retrieval.collection_name

        # pass 1: the audio stages and the chunks of every file
        staged: list[dict[str, Any]] = []
        for audio in audios:
            t_start = time.perf_counter()
            timings: dict[str, float] = {}
            segments = self._audio_stages(audio, sample_rate, diarize,
                                          timings)
            t0 = time.perf_counter()
            chunks = self.chunker.chunk(segments) if segments else []
            timings["chunk"] = round(time.perf_counter() - t0, 3)
            staged.append({"source": _source(audio), "segments": segments,
                           "chunks": chunks, "timings": timings,
                           "t_start": t_start})

        # pass 2: every file's headers, one process_chunks call a file
        for st in staged:
            if not st["chunks"]:
                continue
            t0 = time.perf_counter()
            with span("ingest.contextualize"):
                st["chunks"] = self.contextual.process_chunks(st["chunks"])
            st["timings"]["contextualize"] = round(
                time.perf_counter() - t0, 3)

        # pass 3: embed and store each file in order
        results = []
        for idx, st in enumerate(staged):
            chunks = st["chunks"]
            per_file = (metadatas[idx] if metadatas else None) or {}
            meta = {"source": st["source"], **(metadata or {}), **per_file}
            for c in chunks:
                c.metadata.update(meta)
            if chunks:
                self._store(chunks, collection, st["timings"])
            results.append(_result(st["source"], collection, st["segments"],
                                   chunks, st["t_start"], st["timings"]))
        return results

    def ingest_segments(self, segments: list[TranscriptSegment],
                        collection: str | None = None,
                        metadata: dict[str, Any] | None = None,
                        source: str = "<segments>") -> IngestionResult:
        """A transcript's ingest without audio (chunk → headers → embed →
        store), for pre-transcribed corpora."""
        t_start = time.perf_counter()
        collection = collection or self.config.retrieval.collection_name
        chunks = self.chunker.chunk(segments)
        if self.config.contextual.enabled:
            chunks = self.contextual.process_chunks(chunks)
        meta = {"source": source, **(metadata or {})}
        for c in chunks:
            c.metadata.update(meta)
        embeddings = self.stages.embedder.embed([c.text for c in chunks])
        self.stages.store.add(chunks, embeddings, collection)
        speakers = {s.speaker for s in segments if s.speaker}
        return IngestionResult(
            source=source, collection=collection,
            num_segments=len(segments), num_chunks=len(chunks),
            num_speakers=len(speakers),
            duration_s=round(max((s.end for s in segments), default=0.0), 3),
            elapsed_s=round(time.perf_counter() - t_start, 3))
