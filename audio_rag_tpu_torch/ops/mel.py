"""Whisper-compatible log-mel spectrogram as f32 windowed-DFT matmuls.

Counterpart of ``audio_rag_tpu/ops/mel.py`` (n_fft=400, hop=160, periodic
Hann window, slaney mel filterbank, log10 → clamp to max−8 → (x+4)/4):
frames @ (window⊙cos) and frames @ (window⊙sin), the power spectrum, then
the mel projection, all in f32. The filterbank and DFT bases are the same
float64 numpy tables cast to f32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "SAMPLE_RATE",
    "N_FFT",
    "HOP_LENGTH",
    "N_SAMPLES",
    "mel_filterbank",
    "log_mel_spectrogram",
    "log_mel_batch",
    "pad_or_trim",
]

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30  # seconds per Whisper window
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE


def _hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freqs,
    )


@functools.lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 128, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(
        np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_bases(n_fft: int = N_FFT) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real-DFT bases: (n_fft, n_fft//2+1) cos and -sin."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    ang = 2.0 * np.pi * n * k / n_fft
    cos_b = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (window[:, None] * -np.sin(ang)).astype(np.float32)
    return cos_b, sin_b


def log_mel_batch(windows: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """(B, n_samples) f32 PCM → (B, n_mels, n_samples // HOP) log-mel, each
    window clamped to its own max − 8 (Whisper's per-input normalization)."""
    windows = windows.float()
    dev = windows.device
    n_frames = windows.shape[-1] // HOP_LENGTH
    padded = F.pad(windows[:, None, :], (N_FFT // 2, N_FFT // 2),
                   mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    cos_b, sin_b = (torch.from_numpy(b).to(dev) for b in _dft_bases(N_FFT))
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    power = re * re + im * im
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
    mel = torch.matmul(power, fb.t())
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    top = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, top - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """(n_samples,) f32 PCM → (n_mels, n_frames) log-mel."""
    return log_mel_batch(audio[None], n_mels=n_mels)[0]


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Pad with zeros or trim to exactly ``length`` samples (host-side)."""
    if audio.shape[-1] > length:
        return audio[..., :length]
    if audio.shape[-1] < length:
        pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
        return np.pad(audio, pad)
    return audio
