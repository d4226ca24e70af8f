"""Streaming-session multiplexer (counterpart of ``audio_rag_tpu/asr/mux.py``):
concurrent live sessions' chunks share one window-batch ASR dispatch.

Built on :class:`~audio_rag_tpu_torch.utils.coalescer.KeyedCoalescer`:
chunks that arrive while a dispatch is on the card accumulate and ride the
next batch. Every dispatch runs on the mux's one worker thread, so
sessions that share a backend never drive the card from their own
threads. Chunks batch when their ``(sample_rate, word_timestamps)`` agree;
``language`` is not part of the key: each row carries its own language
token, so sessions with different languages share one dispatch.

A batch of more than one chunk is padded to ``max_batch`` rows and a lone
chunk runs at one row (``pad_to``), as the JAX mux buckets its batches;
``pad_to`` also bounds the rows a chunk's VAD spans may add
(:meth:`WhisperASR.transcribe_chunk_batch` collapses them).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np

from audio_rag_tpu_torch.audio.synth import speech_like
from audio_rag_tpu_torch.utils.coalescer import KeyedCoalescer

__all__ = ["StreamingMux"]


class StreamingMux(KeyedCoalescer):
    """Batches concurrent sessions' chunks into one ASR dispatch."""

    worker_name = "asr-mux"
    join_timeout_s = 30.0

    def __init__(self, backend, max_batch: int | None = None,
                 linger_ms: float = 8.0):
        """``backend``: a :class:`~audio_rag_tpu_torch.asr.whisper.
        WhisperASR` (one batched dispatch) or any backend with a
        ``transcribe_chunk_batch`` (``asr.fake.FakeASR``'s per-chunk
        loop). ``max_batch`` defaults to the backend config's
        ``window_batch_size``. ``linger_ms``: after a round's first chunk,
        keep draining until no chunk has arrived for this long (sessions
        woken together by one dispatch's end resubmit one at a time)."""
        self.backend = backend
        self._ready_lock = threading.Lock()
        self.warmed = False
        super().__init__(
            max_batch=max_batch or getattr(
                backend.config, "window_batch_size", 8),
            linger_s=linger_ms / 1e3,
        )

    @property
    def chunks_served(self) -> int:
        return self.items_served

    # -- client API ------------------------------------------------------
    def submit(self, chunk: np.ndarray, sample_rate: int | None = None,
               word_timestamps: bool = False,
               language: str | None = None) -> Future:
        """Enqueue one chunk; the future resolves to its
        ``list[TranscriptSegment]`` (times relative to the chunk)."""
        return self._submit((chunk, language),
                            (sample_rate, word_timestamps))

    # -- dispatch ----------------------------------------------------------
    def _run_batch(self, payloads: list, key: tuple):
        sample_rate, word_timestamps = key
        chunks = [chunk for chunk, _ in payloads]
        return self.backend.transcribe_chunk_batch(
            chunks, sample_rate, word_timestamps=word_timestamps,
            language=[lang for _, lang in payloads],
            pad_to=self.max_batch if len(chunks) > 1 else 1)

    # -- load + warm-up ------------------------------------------------------
    def ensure_ready(self, sample_rate: int = 16000,
                     chunk_seconds: float = 5.0) -> None:
        """Load the shared backend and run the two batch sizes live
        traffic takes (1 and ``max_batch`` rows, with word times, as
        every session asks for them) once, on the mux's own
        thread, so that its cuBLAS handle and workspaces exist before the
        first live chunk. Sessions that arrive together wait on one lock;
        a failing load or warm-up raises (and a later call tries again)."""
        with self._ready_lock:
            if self.warmed:
                return
            self.call(lambda: self._warm(sample_rate,
                                         chunk_seconds)).result()
            self.warmed = True

    def _warm(self, sample_rate: int, chunk_seconds: float) -> None:
        self.backend.load()
        # speech-shaped, so that the VAD passes it to the decoder
        warm = speech_like(int(chunk_seconds * sample_rate), sample_rate,
                           seed=0)
        self.backend.transcribe_chunk_batch(
            [warm], sample_rate, word_timestamps=True, pad_to=1)
        if self.max_batch > 1:
            self.backend.transcribe_chunk_batch(
                [warm, warm], sample_rate, word_timestamps=True,
                pad_to=self.max_batch)
