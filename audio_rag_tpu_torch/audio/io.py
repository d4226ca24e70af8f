"""Host-side audio decode / resample / WAV writing (numpy).

Counterpart of ``audio_rag_tpu/audio/io.py`` for the formats the slice
reads: PCM WAV files (all sample widths) and float arrays with their rate.
Compressed formats are not decoded here. Resampling to 16 kHz uses the
band-limited Fourier method; the JAX package's polyphase filter gives
slightly different samples at rates other than 16 kHz.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path

import numpy as np

from audio_rag_tpu_torch.core.exceptions import AudioProcessingError

__all__ = ["TARGET_SR", "decode_audio", "resample", "wav_bytes", "write_wav"]

TARGET_SR = 16_000


def _decode_wav(path: Path) -> tuple[np.ndarray, int]:
    try:
        with wave.open(str(path), "rb") as wf:
            sr = wf.getframerate()
            n_ch = wf.getnchannels()
            width = wf.getsampwidth()
            raw = wf.readframes(wf.getnframes())
    except (wave.Error, EOFError) as exc:
        raise AudioProcessingError(
            f"invalid WAV file: {path}: {exc}", context={"path": str(path)}
        ) from exc
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    else:
        raise AudioProcessingError(
            f"unsupported WAV sample width {width}", context={"path": str(path)}
        )
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x, sr


def resample(audio: np.ndarray, sr: int,
             target_sr: int = TARGET_SR) -> np.ndarray:
    """Band-limited resample to ``target_sr`` (identity when already there)."""
    if sr == target_sr:
        return audio.astype(np.float32, copy=False)
    n_in = audio.shape[-1]
    n_out = int(round(n_in * target_sr / sr))
    if n_in == 0 or n_out == 0:
        return np.zeros(n_out, np.float32)
    spec = np.fft.rfft(audio.astype(np.float64))
    out = np.zeros(n_out // 2 + 1, np.complex128)
    m = min(out.size, spec.size)
    out[:m] = spec[:m]
    return (np.fft.irfft(out, n_out) * (n_out / n_in)).astype(np.float32)


def decode_audio(
    path: str | Path | np.ndarray,
    sample_rate: int | None = None,
    target_sr: int = TARGET_SR,
) -> tuple[np.ndarray, int]:
    """Decode a WAV path, or an ndarray with its ``sample_rate``, to mono
    float32 at ``target_sr``."""
    if isinstance(path, np.ndarray):
        if sample_rate is None:
            raise AudioProcessingError(
                "sample_rate required for ndarray input")
        x = path.astype(np.float32, copy=False)
        if x.ndim > 1:
            x = x.mean(axis=-1)
        return resample(x, sample_rate, target_sr), target_sr

    p = Path(path)
    if not p.is_file():
        raise AudioProcessingError(f"audio file not found: {p}",
                                   context={"path": str(p)})
    if p.suffix.lower() != ".wav":
        raise AudioProcessingError(
            f"cannot decode {p.suffix}: the port reads WAV only",
            context={"path": str(p), "format": p.suffix},
        )
    x, sr = _decode_wav(p)
    return resample(x, sr, target_sr), target_sr


def wav_bytes(audio: np.ndarray, sr: int = TARGET_SR) -> bytes:
    """Mono float32 [-1, 1] → 16-bit PCM WAV bytes."""
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_wav(path: str | Path, audio: np.ndarray,
              sr: int = TARGET_SR) -> None:
    """Write mono float32 [-1, 1] as a 16-bit PCM WAV file."""
    Path(path).write_bytes(wav_bytes(audio, sr))
