"""Deterministic fake ASR backend (counterpart of
``audio_rag_tpu/asr/fake.py``): a fixed words-per-second transcript with
exact timings, optionally from a supplied script. It runs no model and no
device; the streaming mux's host tests drive it.

It has no batched path: :meth:`FakeASR.transcribe_chunk_batch` is the
per-chunk loop that the JAX package's ``BaseASR`` gives such a backend
(``core/base.py:107-125``), a per-chunk ``language`` list included, and
:meth:`FakeASR.transcribe_with_words` is ``transcribe`` with word times,
as ``BaseASR`` gives it (``core/base.py:101``).
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from audio_rag_tpu_torch.audio.io import decode_audio
from audio_rag_tpu_torch.config import ASRConfig
from audio_rag_tpu_torch.core.types import TranscriptSegment, Word

__all__ = ["FakeASR"]


class FakeASR:
    def __init__(self, config: ASRConfig | None = None,
                 script: list[str] | None = None,
                 words_per_second: float = 2.0,
                 segment_seconds: float = 5.0):
        self.config = config or ASRConfig()
        self.script = script
        self.words_per_second = words_per_second
        self.segment_seconds = segment_seconds

    is_loaded = True
    hbm_required_gb = 0.0

    def load(self) -> None:
        pass

    def transcribe(self, audio: np.ndarray | str,
                   sample_rate: int | None = None,
                   word_timestamps: bool = False,
                   **kw: Any) -> list[TranscriptSegment]:
        wav, sr = decode_audio(audio, sample_rate)
        duration = len(wav) / sr
        segments: list[TranscriptSegment] = []
        t = 0.0
        idx = 0
        while t < duration:
            end = min(t + self.segment_seconds, duration)
            n_words = max(1, int((end - t) * self.words_per_second))
            if self.script:
                text = self.script[len(segments) % len(self.script)]
                words_txt = text.split()
            else:
                words_txt = [f"word{idx + k}" for k in range(n_words)]
                text = " ".join(words_txt)
            step = (end - t) / len(words_txt)
            words = [
                Word(w, round(t + k * step, 3), round(t + (k + 1) * step, 3))
                for k, w in enumerate(words_txt)
            ] if word_timestamps else []
            segments.append(TranscriptSegment(
                text=text, start=round(t, 3), end=round(end, 3),
                words=words, language="en"))
            idx += len(words_txt)
            t = end
        return segments

    def transcribe_with_words(self, audio: np.ndarray | str,
                              sample_rate: int | None = None,
                              **kw: Any) -> list[TranscriptSegment]:
        return self.transcribe(audio, sample_rate, word_timestamps=True, **kw)

    def transcribe_chunk_batch(self, chunks: Iterable[np.ndarray],
                               sample_rate: int | None = None,
                               pad_to: int | None = None,
                               **kw: Any) -> list[list[TranscriptSegment]]:
        """One segment list per chunk, each chunk transcribed alone
        (``pad_to`` means nothing here); ``language`` may be a list, one
        per chunk."""
        if isinstance(kw.get("language"), list):
            langs = kw.pop("language")
            return [self.transcribe(c, sample_rate, language=lang, **kw)
                    for c, lang in zip(chunks, langs)]
        return [self.transcribe(c, sample_rate, **kw) for c in chunks]
