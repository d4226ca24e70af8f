"""Deterministic fake diarizer (copy of
``audio_rag_tpu/diarization/fake.py``): round-robin speakers on a fixed
period, no model and no device."""

from __future__ import annotations

from typing import Any

import numpy as np

from audio_rag_tpu_torch.audio.io import decode_audio
from audio_rag_tpu_torch.config import DiarizationConfig
from audio_rag_tpu_torch.core.types import TranscriptSegment

__all__ = ["FakeDiarizer"]


class FakeDiarizer:
    is_loaded = True
    hbm_required_gb = 0.0

    def __init__(self, config: DiarizationConfig | None = None,
                 n_speakers: int = 2, turn_seconds: float = 10.0,
                 device: Any = None):
        self.config = config or DiarizationConfig()
        self.n_speakers = n_speakers
        self.turn_seconds = turn_seconds

    def load(self) -> None:
        pass

    def diarize(self, audio: np.ndarray | str,
                sample_rate: int | None = None,
                **kw: Any) -> list[TranscriptSegment]:
        """Turns of ``turn_seconds`` over the audio, speakers in turn."""
        wav, sr = decode_audio(audio, sample_rate)
        duration = len(wav) / sr
        out: list[TranscriptSegment] = []
        t, i = 0.0, 0
        while t < duration:
            end = min(t + self.turn_seconds, duration)
            out.append(TranscriptSegment(
                text="", start=round(t, 3), end=round(end, 3),
                speaker=f"SPEAKER_{i % self.n_speakers:02d}"))
            t, i = end, i + 1
        return out
