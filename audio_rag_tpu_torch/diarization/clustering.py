"""Clustering diarizer: VAD → windowed speaker embeddings → spectral
clustering.

Counterpart of ``audio_rag_tpu/diarization/clustering.py``: speech spans
from the VAD (:mod:`audio_rag_tpu_torch.asr.vad`), 1.5 s windows every
0.75 s inside them, their log-mel (no max − 8 clamp) and speaker
embeddings on the device in fixed batches of 64 or 512 windows (the tail
zero-padded), then spectral clustering of the L2-normalized f32
embeddings on the host, and labeled windows merged into per-speaker
segments. A converted ECAPA-TDNN (``checkpoint_path``) embeds its windows'
speechbrain filterbanks instead of the log-mel, in f32.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.asr.vad import VADOptions, speech_segments
from audio_rag_tpu_torch.audio.io import decode_audio
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, stored_elements
from audio_rag_tpu_torch.config import DiarizationConfig
from audio_rag_tpu_torch.core.types import TranscriptSegment
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.diarization.spectral import spectral_cluster
from audio_rag_tpu_torch.engine.engine import get_engine, peek_engine
from audio_rag_tpu_torch.models.ecapa import (
    ecapa_embed,
    ecapa_fbank,
    is_ecapa_params,
)
from audio_rag_tpu_torch.models.speaker import (
    SPEAKER_PRESETS,
    SpeakerDims,
    resolve_speaker_params,
    speaker_embed,
)
from audio_rag_tpu_torch.ops.mel import log_mel_batch
from audio_rag_tpu_torch.resources.estimates import speaker_gb
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["ClusteringDiarizer", "window_embeddings", "windows_to_segments"]

#: windows per device call: fixed buckets, the tail zero-padded
_EMBED_BATCHES = (64, 512)


@torch.inference_mode()
def window_embeddings(wav: np.ndarray, sr: int,
                      spans: list[tuple[float, float]],
                      config: DiarizationConfig, dims: SpeakerDims,
                      params: dict, device: torch.device
                      ) -> tuple[list[float], np.ndarray]:
    """Window starts and their L2-normalized f32 speaker embeddings
    (N, emb_dim), computed on ``device`` in fixed batches. Windows start
    every ``shift_s`` inside each span, each at least half inside it; one
    window per span when no span holds half a window."""
    win, win_n = config.window_s, int(config.window_s * sr)
    starts: list[float] = []
    for s, e in spans:
        t = s
        while t + 0.5 * win <= e:
            starts.append(t)
            t += config.shift_s
    starts = starts or [s for s, _ in spans]
    frames = np.zeros((len(starts), win_n), np.float32)
    for i, t in enumerate(starts):
        seg = wav[int(t * sr): int(t * sr) + win_n]
        frames[i, : len(seg)] = seg
    chunks: list[np.ndarray] = []
    base, n = 0, frames.shape[0]
    while base < n:
        rem = n - base
        batch = next((b for b in _EMBED_BATCHES if rem <= b),
                     _EMBED_BATCHES[-1])
        m = min(batch, rem)
        block = np.zeros((batch, win_n), np.float32)
        block[:m] = frames[base: base + m]
        wav_b = torch.from_numpy(block).to(device)
        if is_ecapa_params(params):
            emb = ecapa_embed(params, ecapa_fbank(wav_b, n_mels=dims.n_mels),
                              dtype=torch.float32)
        else:
            mel = log_mel_batch(wav_b, n_mels=dims.n_mels, global_norm=False)
            emb = speaker_embed(params, dims, mel, dtype=torch.float32)
        chunks.append(emb[:m].cpu().numpy())
        base += m
    return starts, np.concatenate(chunks, axis=0)


def windows_to_segments(starts: list[float], labels: np.ndarray, win: float,
                        shift: float, total_end: float
                        ) -> list[TranscriptSegment]:
    """Labeled windows → merged per-speaker segments."""
    segs: list[TranscriptSegment] = []
    for t, lab in zip(starts, labels):
        spk = f"SPEAKER_{int(lab):02d}"
        end = t + win
        if segs and segs[-1].speaker == spk and t <= segs[-1].end + shift:
            segs[-1].end = round(end, 3)
        else:
            segs.append(TranscriptSegment(text="", start=round(t, 3),
                                          end=round(end, 3), speaker=spk))
    for s in segs:
        s.end = min(s.end, round(total_end, 3))
    return segs


class ClusteringDiarizer:
    """Spectral-clustering diarizer on one device.

    ``timings`` holds, per :meth:`diarize` call, host-clock seconds of the
    VAD, the window embeddings (ends in a device-to-host copy) and the
    clustering, and the number of windows."""

    def __init__(self, config: DiarizationConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or DiarizationConfig()
        self.device = resolve_device(device)
        preset = (self.config.model if self.config.model in SPEAKER_PRESETS
                  else "titanet-jax")
        self.dims = SPEAKER_PRESETS[preset]
        self._allow_asset = self.config.model != "test"
        #: the manager's booking: the encoder that load() will take (a
        #: converted checkpoint's tensors in f32, else the committed
        #: asset's shape when it is there)
        n_ckpt = (stored_elements(self.config.checkpoint_path, "speaker")
                  if self.config.checkpoint_path else None)
        if n_ckpt is not None:
            self.hbm_required_gb = 4 * n_ckpt / 1e9
        else:
            self.hbm_required_gb = speaker_gb(
                SPEAKER_PRESETS["small"] if self._allow_asset
                and (ASSETS_DIR / "speaker_small.npz").exists()
                else self.dims)
        self._params = None
        self.source: str | None = None
        self.timings: dict[str, float] = {}

    @property
    def is_loaded(self) -> bool:
        return self._params is not None

    def load(self) -> None:
        if self.is_loaded:
            return
        rm = get_resource_manager()
        rm.ensure_hbm(self.hbm_required_gb, for_model="diarization")
        dims, params, self.source = resolve_speaker_params(
            self.config.checkpoint_path, self.dims,
            allow_asset=self._allow_asset, device=self.device)
        get_engine(self.device).put_params("speaker", params)
        self.dims, self._params = dims, params
        rm.register_model("diarization", self.hbm_required_gb, self)

    def unload(self) -> None:
        """Drop the encoder (and its booking); the next use loads it."""
        if not self.is_loaded:
            return
        engine = peek_engine()
        if engine is not None:
            engine.drop_params("speaker")
        self._params = None
        get_resource_manager().unregister("diarization")

    def _spans_and_embeddings(self, audio, sample_rate):
        if not self.is_loaded:
            self.load()
        self.timings = {"vad_s": 0.0, "embed_s": 0.0, "cluster_s": 0.0,
                        "windows": 0}
        wav, sr = decode_audio(audio, sample_rate)
        if wav.size == 0:
            return None
        t0 = time.perf_counter()
        spans = speech_segments(wav, sr, VADOptions(
            min_speech_ms=self.config.min_speech_duration_ms or 250,
            backend=self.config.vad_backend), device=self.device)
        t1 = time.perf_counter()
        self.timings["vad_s"] = t1 - t0
        if not spans:
            return None
        starts, emb = window_embeddings(wav, sr, spans, self.config,
                                        self.dims, self._params, self.device)
        self.timings["embed_s"] = time.perf_counter() - t1
        self.timings["windows"] = len(starts)
        return spans, starts, emb

    @timed
    def diarize(self, audio: np.ndarray | str,
                sample_rate: int | None = None,
                num_speakers: int | None = None) -> list[TranscriptSegment]:
        got = self._spans_and_embeddings(audio, sample_rate)
        if got is None:
            return []
        spans, starts, emb = got
        t0 = time.perf_counter()
        labels = spectral_cluster(emb,
                                  max_speakers=self.config.max_speakers or 8,
                                  num_speakers=num_speakers,
                                  min_speakers=self.config.min_speakers)
        segs = windows_to_segments(starts, labels, self.config.window_s,
                                   self.config.shift_s,
                                   max(e for _, e in spans))
        self.timings["cluster_s"] = time.perf_counter() - t0
        return segs

    def get_speaker_timeline(self, segments: list[TranscriptSegment]
                             ) -> list[dict[str, Any]]:
        """Total talk time per speaker."""
        totals: dict[str, float] = {}
        for s in segments:
            if s.speaker:
                totals[s.speaker] = totals.get(s.speaker, 0.0) + s.duration
        return [{"speaker": k, "talk_time": round(v, 3)}
                for k, v in sorted(totals.items())]
