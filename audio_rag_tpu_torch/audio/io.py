"""Host-side audio decode / resample / WAV writing.

Counterpart of ``audio_rag_tpu/audio/io.py``. WAV files (PCM 8/16/24/32-bit
and 32-bit IEEE float, channels averaged) decode in the native runtime
(:mod:`audio_rag_tpu_torch.native`), and resampling to 16 kHz runs its
Kaiser-windowed sinc polyphase filter, so both packages read and resample
to the same samples. Where the library is missing, numpy copies of both
give the same numbers. Other formats decode through an ``ffmpeg``
subprocess when the binary exists. ``get_duration`` reads a WAV header
itself (the JAX package's ``wave`` module refuses float WAV files there).
"""

from __future__ import annotations

import functools
import io
import math
import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

from audio_rag_tpu_torch import native
from audio_rag_tpu_torch.core.exceptions import AudioProcessingError

__all__ = ["TARGET_SR", "decode_audio", "get_duration", "resample",
           "wav_bytes", "write_wav"]

TARGET_SR = 16_000


# -- WAV ---------------------------------------------------------------------

def _wav_chunks(data: bytes) -> tuple[tuple[int, int, int, int], bytes]:
    """((format, channels, rate, bits), sample bytes) of a RIFF/WAVE
    buffer, walked as the native decoder walks it: word-aligned chunks, a
    chunk running past the end cut to what is there. Raises on a bad
    header."""
    if (len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE"):
        raise ValueError("no RIFF/WAVE header")
    fmt = None
    pcm = None
    pos = 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4: pos + 8], "little")
        size = min(size, len(data) - pos - 8)
        body = data[pos + 8: pos + 8 + size]
        if data[pos: pos + 4] == b"fmt " and size >= 16:
            fmt = (int.from_bytes(body[0:2], "little"),
                   int.from_bytes(body[2:4], "little"),
                   int.from_bytes(body[4:8], "little"),
                   int.from_bytes(body[14:16], "little"))
        elif data[pos: pos + 4] == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if pcm is None or fmt is None or fmt[1] == 0 or fmt[2] == 0:
        raise ValueError("no fmt or data chunk")
    return fmt, pcm


def _wav_decode_np(data: bytes) -> tuple[np.ndarray, int]:
    """numpy copy of the native ``arag_wav_decode``, with its arithmetic:
    each sample to f32 as the C code converts it, channels summed in f32
    in order and multiplied by the f32 reciprocal of their count."""
    (code, channels, rate, bits), pcm = _wav_chunks(data)
    if code not in (1, 3) or (code == 3 and bits != 32) or bits not in (
            8, 16, 24, 32):
        raise NotImplementedError(f"WAV format {code} with {bits}-bit "
                                  f"samples")
    width = bits // 8
    frames = len(pcm) // (width * channels)
    raw = np.frombuffer(pcm, np.uint8, frames * width * channels)
    if bits == 8:
        v = (raw.astype(np.float32) - np.float32(128)) / np.float32(128)
    elif bits == 16:
        v = raw.view("<i2").astype(np.float32) / np.float32(32768)
    elif bits == 24:
        b = raw.reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        x = np.where(x & 0x800000, x - 0x1000000, x)
        v = x.astype(np.float32) / np.float32(8388608)
    elif code == 3:
        v = raw.view("<f4").astype(np.float32)
    else:
        v = raw.view("<i4").astype(np.float32) / np.float32(2147483648)
    v = v.reshape(frames, channels)
    acc = np.zeros(frames, np.float32)
    for c in range(channels):
        acc = acc + v[:, c]
    return acc * (np.float32(1) / np.float32(channels)), rate


def _decode_wav(path: Path) -> tuple[np.ndarray, int]:
    data = path.read_bytes()
    out = native.wav_decode(data)
    if out is not None:
        return out
    try:
        return _wav_decode_np(data)
    except ValueError as exc:
        raise AudioProcessingError(
            f"invalid WAV file: {path}: {exc}", context={"path": str(path)}
        ) from exc
    except NotImplementedError as exc:
        raise AudioProcessingError(
            f"unsupported WAV file: {path}: {exc}",
            context={"path": str(path)}) from exc


def _decode_ffmpeg(path: Path, sr: int) -> tuple[np.ndarray, int]:
    """Any format ``ffmpeg`` reads → mono float32 at ``sr``."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise AudioProcessingError(
            f"cannot decode {path.suffix} without ffmpeg",
            context={"path": str(path), "format": path.suffix},
        )
    cmd = [ffmpeg, "-v", "error", "-i", str(path),
           "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True,
                             timeout=600)
    except subprocess.CalledProcessError as exc:
        raise AudioProcessingError(
            f"ffmpeg failed on {path}: {exc.stderr.decode()[:500]}",
            context={"path": str(path)},
        ) from exc
    return np.frombuffer(out.stdout, dtype=np.float32).copy(), sr


# -- resampling ----------------------------------------------------------------

_TAPS_PER_PHASE = 32
_BETA = 8.6  # Kaiser window, ~90 dB stopband


def _bessel_i0(x: float) -> float:
    s = t = 1.0
    for k in range(1, 32):
        t *= (x / (2.0 * k)) * (x / (2.0 * k))
        s += t
        if t < 1e-12 * s:
            break
    return s


@functools.lru_cache(maxsize=16)
def _polyphase_taps(L: int, M: int) -> np.ndarray:
    """The native resampler's f64 taps, in the same float operations."""
    half = _TAPS_PER_PHASE * L // 2
    cutoff = 0.5 / float(max(L, M))
    i0b = _bessel_i0(_BETA)
    h = np.empty(2 * half + 1, np.float64)
    for i in range(2 * half + 1):
        t = float(i - half)
        x = 2.0 * cutoff * t
        sinc = 1.0 if t == 0.0 else math.sin(math.pi * x) / (math.pi * x)
        w = t / float(half)
        kais = (_bessel_i0(_BETA * math.sqrt(1.0 - w * w)) / i0b
                if abs(w) <= 1.0 else 0.0)
        h[i] = 2.0 * cutoff * float(L) * sinc * kais
    return h


def _resample_np(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """numpy copy of the native ``arag_resample``: output k is the f64
    sum over input n, in ascending n, of x[n]·h[k·M − n·L + half], rounded
    to f32 once; floor(n_in·L/M) outputs."""
    x = np.ascontiguousarray(audio, np.float32)
    if sr == target_sr:
        return x.copy()
    g = math.gcd(sr, target_sr)
    L, M = target_sr // g, sr // g
    h = _polyphase_taps(L, M)
    half = (len(h) - 1) // 2
    n_in = x.size
    up = np.arange(n_in * L // M, dtype=np.int64) * M
    first = -((half - up) // L)  # ceil((up - half) / L)
    last = (up + half) // L
    acc = np.zeros(up.size, np.float64)
    xd = x.astype(np.float64)
    for j in range(2 * half // L + 2):
        n = first + j
        ok = (n <= last) & (n >= 0) & (n < n_in)
        tap = np.where(ok, up - n * L + half, 0)
        acc = acc + np.where(ok, xd[np.clip(n, 0, max(n_in - 1, 0))]
                             * h[tap], 0.0)
    return acc.astype(np.float32)


def resample(audio: np.ndarray, sr: int,
             target_sr: int = TARGET_SR) -> np.ndarray:
    """Kaiser-sinc polyphase resample to ``target_sr`` (identity when
    already there): the native filter, else its numpy copy."""
    if sr == target_sr:
        return audio.astype(np.float32, copy=False)
    out = native.resample(audio, sr, target_sr)
    return out if out is not None else _resample_np(audio, sr, target_sr)


# -- entry points ----------------------------------------------------------------

def decode_audio(
    path: str | Path | np.ndarray,
    sample_rate: int | None = None,
    target_sr: int = TARGET_SR,
) -> tuple[np.ndarray, int]:
    """Decode a file (WAV natively, other formats through ffmpeg when it
    is installed), or an ndarray with its ``sample_rate``, to mono float32
    at ``target_sr``."""
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
    if p.suffix.lower() == ".wav":
        x, sr = _decode_wav(p)
    else:
        x, sr = _decode_ffmpeg(p, target_sr)
    return resample(x, sr, target_sr), target_sr


def get_duration(path: str | Path) -> float:
    """Duration in seconds: from the header for WAV, else by decoding."""
    p = Path(path)
    if p.suffix.lower() == ".wav":
        try:
            (_, channels, rate, bits), pcm = _wav_chunks(p.read_bytes())
        except (ValueError, OSError) as exc:
            raise AudioProcessingError(
                f"invalid WAV file: {p}", context={"path": str(p)}) from exc
        return len(pcm) // max(channels * (bits // 8), 1) / float(rate)
    audio, sr = decode_audio(p)
    return len(audio) / sr


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
