"""Neural TTS backend (counterpart of ``audio_rag_tpu/tts/jax_tts.py``,
registered under the schema's name "jax"): the FastSpeech-class model and
Griffin-Lim vocoder of :mod:`audio_rag_tpu_torch.models.tts` on the
committed trained asset (``tts_small.npz``; seeded random weights, with a
warning, when it is missing), on the card by default.

Text is split at sentence and word boundaries into segments of at most 256
symbols; the longest picks a pow-2 symbol bucket (32, 64, 128, 256), and
segments go up to 16 rows at a time through text → mel → waveform with a
frames cap of ``min(16·bucket, 4096)`` and predicted durations clamped to
``frames // bucket``, so no utterance is cut. (The JAX backend pads each
batch to 16 rows for its compiled program; rows do not mix, so an eager
batch holds only the segments.) Segments
are joined with 0.12 s of silence; the 16 kHz waveform is resampled to
``config.sample_rate`` and returned as WAV bytes. ``load``, ``unload`` and
synthesis share one lock: an unload during a synthesis does not pull the
weights from under it.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading

import numpy as np
import torch

from audio_rag_tpu_torch.audio.io import resample, wav_bytes
from audio_rag_tpu_torch.config import TTSConfig
from audio_rag_tpu_torch.core.exceptions import TTSError
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.models.tts import (
    HOP_LENGTH,
    PAD_ID,
    TTS_PRESETS,
    TTSDims,
    apply_tts,
    init_tts,
    mel_to_audio,
    text_to_ids,
)
from audio_rag_tpu_torch.tts.base import BaseTTS, register_tts
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.weights import load_tts_small

log = logging.getLogger(__name__)

__all__ = ["NeuralTTS", "SR"]

SR = 16_000  # the model's native rate
_BUCKETS = (32, 64, 128, 256)  # symbol-length buckets
_MAX_BATCH = 16
_GAP_S = 0.12  # silence between segments


def _split_segments(text: str, max_len: int) -> list[str]:
    """Sentence-first split into segments of at most ``max_len`` symbols."""
    out: list[str] = []
    for sent in re.split(r"(?<=[.!?])\s+", text.strip()):
        sent = sent.strip()
        while len(sent) > max_len:
            cut = sent.rfind(" ", 0, max_len)
            if cut <= 0:
                cut = max_len
            out.append(sent[:cut].strip())
            sent = sent[cut:].strip()
        if sent:
            out.append(sent)
    return out or [" "]


def bucket_dims(dims: TTSDims, bucket: int) -> TTSDims:
    """The model's dims for one symbol bucket: frames capped at
    16·bucket (4096 at most) and durations at frames // bucket."""
    frames = min(16 * bucket, 4096)
    return dataclasses.replace(dims, max_text=bucket, max_frames=frames,
                               max_dur=min(dims.max_dur, frames // bucket))


@register_tts("jax")
class NeuralTTS(BaseTTS):
    uses_device = True

    def __init__(self, config: TTSConfig | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(config)
        self.device = resolve_device(device)
        self.dims = TTS_PRESETS["small"]
        self._params = None
        self._lock = threading.RLock()

    def load(self) -> None:
        with self._lock:
            self._load_locked()

    def _load_locked(self) -> None:
        if self._loaded:
            return
        params = load_tts_small(self.device)
        if params is None:
            log.warning("NeuralTTS: tts_small.npz is missing, using "
                        "seeded random weights")
            params = init_tts(self.dims, seed=0, device=self.device)
        self._params = params
        self._loaded = True

    def unload(self) -> None:
        with self._lock:
            self._params = None
            self._loaded = False

    def segment_batches(self, text: str):
        """The batches ``text`` is spoken in: (bucket dims, token ids
        (rows, bucket) int32), up to 16 segments a batch."""
        segments = _split_segments(text, _BUCKETS[-1])
        longest = max(len(s) for s in segments)
        bucket = next(b for b in _BUCKETS if longest <= b)
        dims = bucket_dims(self.dims, bucket)
        for base in range(0, len(segments), _MAX_BATCH):
            chunk = segments[base: base + _MAX_BATCH]
            toks = np.full((len(chunk), bucket), PAD_ID, np.int32)
            for i, s in enumerate(chunk):
                toks[i] = text_to_ids(s, bucket)
            yield dims, toks

    def _synthesize_pcm(self, text: str) -> np.ndarray:
        """text → float32 PCM at the model's native 16 kHz."""
        with self._lock:
            self._load_locked()
            params = self._params  # survives a concurrent unload
        gap = np.zeros(int(_GAP_S * SR), np.float32)
        pieces: list[np.ndarray] = []
        for dims, toks in self.segment_batches(text):
            mel, valid, _ = apply_tts(
                params, dims, torch.from_numpy(toks).to(self.device))
            audio = mel_to_audio(mel, n_iter=32).cpu().numpy()
            n_frames = valid.sum(1).cpu().numpy()
            for row in range(len(toks)):
                pieces.append(audio[row, :int(n_frames[row]) * HOP_LENGTH])
                pieces.append(gap)
        return np.concatenate(pieces[:-1]) if pieces else gap

    @timed
    def synthesize(self, text: str, output_path: str | None = None) -> bytes:
        if not self._loaded:
            self.load()
        if not text.strip():
            raise TTSError("empty text")
        pcm = self._synthesize_pcm(text)
        sr = self.config.sample_rate
        if sr != SR:
            pcm = resample(pcm, SR, sr)
        data = wav_bytes(pcm, sr)
        if output_path:
            with open(output_path, "wb") as f:
                f.write(data)
        return data
