"""Chunked live transcription (counterpart of
``audio_rag_tpu/asr/streaming.py``).

Float32 PCM (or int16 bytes) accumulates in an :class:`AudioBuffer`; each
time ``chunk_duration`` seconds are buffered, the chunk is transcribed and
all but ``overlap_duration`` seconds of it leave the buffer, and a
:class:`StreamingResult` comes back with times absolute within the stream
(rounded to the millisecond). States: IDLE → LISTENING ⇄ PROCESSING →
STOPPED; :meth:`StreamingASR.stop` flushes what is left when it is 0.2 s
or more. Device work runs on one worker thread per session (the event
loop never waits on the card, and chunks keep their order), or, with a
shared :class:`~audio_rag_tpu_torch.asr.mux.StreamingMux`, on the mux's
thread batched with other sessions' chunks; a muxed session without a
language keeps the first one its chunks detect until :meth:`reset`.

Without a backend or mux a session builds the port's Whisper on
``device`` ("cuda" by default: it raises without a card), its decode
budget capped by the streaming config's ``max_decode_tokens`` unless the
ASR config sets one, and unloads it with the session (the JAX session
unloads a backend it was given too). ``StreamingConfig.min_avg_logprob`` is carried and,
as in the JAX package, applied nowhere. Departure: a failing warm-up
raises (the JAX session logs it and streams on).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import enum
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Iterator

import numpy as np

from audio_rag_tpu_torch.audio.synth import speech_like
from audio_rag_tpu_torch.config import ASRConfig
from audio_rag_tpu_torch.core.exceptions import ModelNotLoadedError
from audio_rag_tpu_torch.core.types import Word

__all__ = ["StreamingConfig", "StreamingResult", "StreamState",
           "AudioBuffer", "StreamingASR"]

SAMPLE_RATE = 16_000


@dataclass
class StreamingConfig:
    chunk_duration: float = 5.0
    overlap_duration: float = 1.0
    sample_rate: int = SAMPLE_RATE
    #: carried from the config, applied nowhere (as in the JAX package)
    min_avg_logprob: float | None = None
    #: decode budget per chunk (a 5 s chunk holds about 40 tokens)
    max_decode_tokens: int = 64


@dataclass
class StreamingResult:
    text: str
    start: float
    end: float
    is_final: bool
    words: list[Word] = field(default_factory=list)
    processing_time_ms: float = 0.0

    def to_dict(self) -> dict:
        return {
            "text": self.text,
            "start": self.start,
            "end": self.end,
            "is_final": self.is_final,
            "words": [dataclasses.asdict(w) for w in self.words],
            "processing_time_ms": self.processing_time_ms,
        }


class StreamState(str, enum.Enum):
    IDLE = "idle"
    LISTENING = "listening"
    PROCESSING = "processing"
    STOPPED = "stopped"


class AudioBuffer:
    """Lock-guarded float32 accumulator with absolute-time bookkeeping."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        self.sample_rate = sample_rate
        self._chunks: list[np.ndarray] = []
        self._samples = 0
        #: seconds of audio already trimmed out of the buffer
        self.consumed_duration = 0.0
        self._lock = asyncio.Lock()

    @property
    def buffered_duration(self) -> float:
        return self._samples / self.sample_rate

    @property
    def total_duration(self) -> float:
        return self.consumed_duration + self.buffered_duration

    async def add(self, audio: np.ndarray) -> None:
        async with self._lock:
            audio = np.asarray(audio, np.float32).reshape(-1)
            self._chunks.append(audio)
            self._samples += audio.size

    async def get_and_trim(self, keep_seconds: float) -> np.ndarray:
        """Everything buffered; the last ``keep_seconds`` stay buffered."""
        async with self._lock:
            if not self._chunks:
                return np.zeros(0, np.float32)
            data = np.concatenate(self._chunks)
            keep = int(keep_seconds * self.sample_rate)
            trimmed = max(data.size - keep, 0)
            self._chunks = [data[trimmed:]] if keep > 0 else []
            self._samples = min(keep, data.size)
            self.consumed_duration += trimmed / self.sample_rate
            return data

    async def reset(self) -> None:
        async with self._lock:
            self._chunks = []
            self._samples = 0
            self.consumed_duration = 0.0


class StreamingASR:
    """Chunked streaming over a batch ASR backend or a shared mux."""

    def __init__(self, config: ASRConfig | None = None,
                 streaming: StreamingConfig | None = None,
                 backend=None, mux=None, device: str = "cuda"):
        self.config = config or ASRConfig()
        self.streaming = streaming or StreamingConfig()
        if backend is None and mux is not None:
            backend = mux.backend
        #: a backend the session built is unloaded with it; one it was
        #: given (or a mux's) belongs to the caller
        self._owns_backend = backend is None
        if backend is None:
            from audio_rag_tpu_torch.asr.whisper import WhisperASR

            if self.config.max_decode_tokens is None:
                self.config = dataclasses.replace(
                    self.config,
                    max_decode_tokens=self.streaming.max_decode_tokens)
            backend = WhisperASR(self.config, device)
        self.backend = backend
        #: the backend's booking (the manager books the backend itself)
        self.hbm_required_gb = backend.hbm_required_gb
        #: shared mux: chunks go through it and batch with other
        #: sessions'; the backend is then shared and never unloaded here
        self.mux = mux
        #: the config's language; a muxed session without one keeps the
        #: first language its chunks detect, until reset()
        self._session_lang: str | None = self.config.language
        self.buffer = AudioBuffer(self.streaming.sample_rate)
        self.state = StreamState.IDLE
        self._loaded = False
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def load(self) -> None:
        """Load the backend and warm it for this session's chunks on the
        thread that will run them (the mux's, or the session's worker)."""
        if self._loaded:
            return
        sr = self.streaming.sample_rate
        if self.mux is not None:
            self.mux.ensure_ready(sr, self.streaming.chunk_duration)
        else:
            # speech-shaped, so that the VAD passes it to the decoder
            warm = speech_like(int(self.streaming.chunk_duration * sr), sr,
                               seed=0)

            def prewarm():
                self.backend.load()
                self.backend.transcribe(warm, sr, word_timestamps=True)

            self._worker().submit(prewarm).result()
        self._loaded = True

    def unload(self) -> None:
        """Stop the session's worker; a backend the session built is
        unloaded too (a given or a mux's backend outlives the session)."""
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self._owns_backend:
            self.backend.unload()
        self._loaded = False

    def _worker(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="stream-asr")
        return self._executor

    async def start(self) -> None:
        if not self._loaded:
            raise ModelNotLoadedError(
                "StreamingASR is not loaded; call load() first")
        await self.buffer.reset()
        self.state = StreamState.LISTENING

    async def stop(self) -> StreamingResult | None:
        """Flush whatever remains in the buffer as a final chunk."""
        self.state = StreamState.STOPPED
        remaining = await self.buffer.get_and_trim(0.0)
        if remaining.size < int(0.2 * self.streaming.sample_rate):
            return None
        return await self._transcribe_chunk_async(remaining, final=True)

    async def reset(self) -> None:
        await self.buffer.reset()
        self._session_lang = self.config.language
        self.state = StreamState.LISTENING

    # -- streaming ---------------------------------------------------------
    async def add_audio(self, audio: np.ndarray | bytes
                        ) -> StreamingResult | None:
        """Feed PCM (a float32 array or int16 little-endian bytes);
        returns a result whenever a full chunk was buffered."""
        if self.state not in (StreamState.LISTENING, StreamState.PROCESSING):
            return None
        if isinstance(audio, (bytes, bytearray)):
            audio = (np.frombuffer(audio, dtype="<i2").astype(np.float32)
                     / 32768.0)
        await self.buffer.add(audio)
        if self.buffer.buffered_duration >= self.streaming.chunk_duration:
            self.state = StreamState.PROCESSING
            chunk = await self.buffer.get_and_trim(
                self.streaming.overlap_duration)
            result = await self._transcribe_chunk_async(chunk, final=False)
            if self.state is StreamState.PROCESSING:
                self.state = StreamState.LISTENING
            return result
        return None

    async def _transcribe_chunk_async(self, chunk: np.ndarray,
                                      final: bool) -> StreamingResult:
        loop = asyncio.get_running_loop()
        # the chunk's absolute start within the whole stream
        start = (self.buffer.total_duration
                 - len(chunk) / self.streaming.sample_rate)
        return await loop.run_in_executor(
            self._worker(), self._transcribe_chunk, chunk, max(start, 0.0),
            final)

    def _transcribe_chunk(self, chunk: np.ndarray, offset: float,
                          final: bool) -> StreamingResult:
        t0 = time.perf_counter()
        sr = self.streaming.sample_rate
        if self.mux is not None:
            segments = self.mux.submit(
                chunk, sr, word_timestamps=True,
                language=self._session_lang).result()
            if self._session_lang is None:
                for s in segments:
                    if s.language:  # detected once, kept for the session
                        self._session_lang = s.language
                        break
        else:
            segments = self.backend.transcribe(chunk, sr,
                                               word_timestamps=True)
        dt = (time.perf_counter() - t0) * 1000.0
        text = " ".join(s.text for s in segments).strip()
        words = [
            Word(w.text, round(w.start + offset, 3), round(w.end + offset, 3),
                 w.probability, w.speaker)
            for s in segments for w in s.words
        ]
        end = offset + len(chunk) / sr
        return StreamingResult(
            text=text, start=round(offset, 3), end=round(end, 3),
            is_final=final, words=words, processing_time_ms=dt)

    # -- replay and async iteration ------------------------------------------
    def process_stream(self, audio: np.ndarray,
                       sample_rate: int | None = None
                       ) -> Iterator[StreamingResult]:
        """Replay a recorded array through the chunking state machine in
        feeds of 0.5 s."""

        async def run() -> list[StreamingResult]:
            out = []
            await self.start()
            step = int(0.5 * self.streaming.sample_rate)
            for i in range(0, len(audio), step):
                r = await self.add_audio(audio[i: i + step])
                if r is not None:
                    out.append(r)
            final = await self.stop()
            if final is not None:
                out.append(final)
            return out

        yield from asyncio.run(run())

    async def process_stream_async(self, chunks: AsyncIterator[np.ndarray]
                                   ) -> AsyncIterator[StreamingResult]:
        await self.start()
        async for piece in chunks:
            r = await self.add_audio(piece)
            if r is not None:
                yield r
        final = await self.stop()
        if final is not None:
            yield final
