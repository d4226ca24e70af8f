"""Null TTS (counterpart of ``audio_rag_tpu/tts/null.py``): a quiet
word-rate-modulated 220 Hz tone, 0.25 s a word (at most 30 s), as WAV at
``config.sample_rate``: the same bytes as the JAX backend's."""

from __future__ import annotations

import numpy as np

from audio_rag_tpu_torch.audio.io import wav_bytes
from audio_rag_tpu_torch.config import TTSConfig
from audio_rag_tpu_torch.tts.base import BaseTTS, register_tts

__all__ = ["NullTTS"]


@register_tts("null")
class NullTTS(BaseTTS):
    def __init__(self, config: TTSConfig | None = None):
        super().__init__(config)
        self._loaded = True

    def synthesize(self, text: str, output_path: str | None = None) -> bytes:
        sr = self.config.sample_rate
        n_words = max(1, len(text.split()))
        dur = min(0.25 * n_words, 30.0)
        t = np.arange(int(dur * sr)) / sr
        tone = 0.05 * np.sin(2 * np.pi * 220.0 * t)
        env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t))
        data = wav_bytes((tone * env).astype(np.float32), sr)
        if output_path:
            with open(output_path, "wb") as f:
                f.write(data)
        return data
