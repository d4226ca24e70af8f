"""Voice activity detection: the learned conv VAD (device) and the energy
gate (host).

Own copy of ``audio_rag_tpu/asr/vad.py``. Two backends behind one option
surface:

* ``learned`` — :func:`audio_rag_tpu_torch.models.speaker.vad_scores` over
  10 ms log-mel frames of 3 s clips (each clip's mel clamped to its own
  max − 8, as the model was trained), batched in fixed buckets of 8, 32 or
  128 clips on the device, with the committed ``vad_small.npz`` weights;
* ``energy`` — frame RMS in dBFS against a threshold, on the host.

``auto`` takes the learned backend when its weights load and the audio is
16 kHz, else the energy gate. The spans are post-processed alike (drop
spans under ``min_speech_ms``, pad by the hangover, merge gaps under
``min_silence_ms``), so the backend changes only the frame decisions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.device import resolve_device

__all__ = ["VADOptions", "energy_vad", "learned_vad", "speech_segments",
           "speech_segments_batch"]

_SR = 16_000
_WINDOW_S = 3.0  # the clip length the learned VAD was trained on
_WINDOW = int(_SR * _WINDOW_S)
_FRAMES_PER_WINDOW = int(_WINDOW_S * 100)
#: clips per device call: fixed buckets, the tail zero-padded
_BATCHES = (8, 32, 128)


@dataclass
class VADOptions:
    frame_ms: int = 30
    threshold_db: float = -38.0  # energy backend: speech if dBFS above
    threshold: float = 0.5  # learned backend: speech if P(speech) above
    hangover_frames: int = 10  # keep speech active this many frames after
    min_speech_ms: int = 250
    min_silence_ms: int = 500
    #: "auto" | "learned" | "energy"
    backend: str = "energy"


def energy_vad(audio: np.ndarray, sr: int = 16000,
               opts: VADOptions | None = None) -> np.ndarray:
    """Raw per-frame speech flags at ``frame_ms`` granularity (no
    hangover: :func:`speech_segments` smooths)."""
    opts = opts or VADOptions()
    frame = int(sr * opts.frame_ms / 1000)
    n = len(audio) // frame
    if n == 0:
        return np.zeros(0, bool)
    x = audio[: n * frame].reshape(n, frame).astype(np.float64)
    rms = np.sqrt(np.mean(x * x, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms + 1e-12)
    return db > opts.threshold_db


# -- learned backend ---------------------------------------------------------

#: device → the runner on it, or False when the weights are missing
_runners: dict[torch.device, object] = {}


class _LearnedRunner:
    """The VAD's weights on one device and its (B, 48000) → (B, 300)
    probability function."""

    def __init__(self, params: dict, device: torch.device):
        self.params = params
        self.device = device

    @torch.inference_mode()
    def __call__(self, clips: np.ndarray) -> np.ndarray:
        from audio_rag_tpu_torch.models.speaker import vad_scores
        from audio_rag_tpu_torch.ops.mel import log_mel_batch

        x = torch.from_numpy(clips).to(self.device)
        mel = log_mel_batch(x, n_mels=80)
        return vad_scores(self.params, mel, dtype=torch.float32).cpu().numpy()


def _get_learned_runner(device: str | torch.device = "cuda"):
    """The runner on ``device``, built once per device; False when the
    weights are missing."""
    dev = resolve_device(device)
    runner = _runners.get(dev)
    if runner is None:
        from audio_rag_tpu_torch.weights import vad_params

        tree = load_npz_asset(ASSETS_DIR / "vad_small.npz")
        runner = (False if tree is None
                  else _LearnedRunner(vad_params(tree, dev), dev))
        _runners[dev] = runner
    return runner


def _run_windows(clips_all: np.ndarray, device) -> np.ndarray:
    """All (n, 48000) clips through the runner in bucketed calls →
    (n, 300) probabilities. Clips are independent to the model, so a
    caller may stack clips of many audios into one call."""
    run = _get_learned_runner(device)
    n_windows = len(clips_all)
    probs = np.zeros((n_windows, _FRAMES_PER_WINDOW), np.float32)
    base = 0
    while base < n_windows:
        rem = n_windows - base
        batch = next((b for b in _BATCHES if rem <= b), _BATCHES[-1])
        m = min(batch, rem)
        if m == batch:
            clips = clips_all[base: base + batch]
        else:  # the tail, zero-padded to its bucket
            clips = np.zeros((batch, _WINDOW), np.float32)
            clips[:m] = clips_all[base: base + m]
        out = run(np.ascontiguousarray(clips, np.float32))
        probs[base: base + m] = out[:m, :_FRAMES_PER_WINDOW]
        base += m
    return probs


def _window_clips(audio: np.ndarray) -> np.ndarray:
    n_windows = (len(audio) + _WINDOW - 1) // _WINDOW
    padded = np.zeros(n_windows * _WINDOW, np.float32)
    padded[: len(audio)] = audio
    return padded.reshape(n_windows, _WINDOW)


def learned_vad(audio: np.ndarray, sr: int = 16000,
                opts: VADOptions | None = None,
                device: str | torch.device = "cuda") -> np.ndarray | None:
    """Per-10 ms-frame speech flags from the learned VAD, or None when it
    cannot run (weights missing, audio not at 16 kHz)."""
    opts = opts or VADOptions()
    if sr != _SR or not _get_learned_runner(device):
        return None
    n_frames = len(audio) // (_SR // 100)
    if n_frames == 0:
        return np.zeros(0, bool)
    probs = _run_windows(_window_clips(audio), device).reshape(-1)
    return probs[:n_frames] > opts.threshold


def _spans_from_flags(flags: np.ndarray, frame_s: float,
                      opts: VADOptions) -> list[tuple[float, float]]:
    """Flags → merged spans: raw spans → drop those under min_speech_ms
    (before padding, so the hangover cannot promote blips) → pad the ends
    by the hangover → merge spans less than min_silence_ms apart."""
    spans: list[tuple[float, float]] = []
    start = None
    for i, f in enumerate(flags):
        if f and start is None:
            start = i * frame_s
        elif not f and start is not None:
            spans.append((start, i * frame_s))
            start = None
    if start is not None:
        spans.append((start, len(flags) * frame_s))
    spans = [(s, e) for s, e in spans
             if (e - s) >= opts.min_speech_ms / 1000.0]
    total = len(flags) * frame_s
    pad = opts.hangover_frames * frame_s
    merged: list[tuple[float, float]] = []
    for s, e in spans:
        e = min(e + pad, total)
        if merged and s - merged[-1][1] < opts.min_silence_ms / 1000.0:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def speech_segments(audio: np.ndarray, sr: int = 16000,
                    opts: VADOptions | None = None,
                    device: str | torch.device = "cuda"
                    ) -> list[tuple[float, float]]:
    """Merged (start_s, end_s) speech spans from the configured backend
    (the learned one on ``device``)."""
    opts = opts or VADOptions()
    if opts.backend in ("learned", "auto"):
        flags = learned_vad(audio, sr, opts, device)
        if flags is not None:
            return _spans_from_flags(flags, 0.01, opts)
    flags = energy_vad(audio, sr, opts)
    if flags.size == 0:
        return []
    return _spans_from_flags(flags, opts.frame_ms / 1000.0, opts)


def speech_segments_batch(audios: list[np.ndarray], sr: int = 16000,
                          opts: VADOptions | None = None,
                          device: str | torch.device = "cuda"
                          ) -> list[list[tuple[float, float]]]:
    """Spans of many audios, the learned VAD's clips of all of them
    stacked into one bucketed call set; the same spans as
    :func:`speech_segments` per audio."""
    opts = opts or VADOptions()
    use_learned = (opts.backend in ("learned", "auto") and sr == _SR
                   and bool(_get_learned_runner(device)))
    if not use_learned:
        return [speech_segments(a, sr, opts, device) for a in audios]
    metas = []  # (n_frames, n_windows) per audio
    clip_list = []
    for a in audios:
        n_frames = len(a) // (_SR // 100)
        n_windows = (len(a) + _WINDOW - 1) // _WINDOW if n_frames else 0
        metas.append((n_frames, n_windows))
        if n_windows:
            clip_list.append(_window_clips(a))
    probs = (_run_windows(np.concatenate(clip_list), device)
             if clip_list else np.zeros((0, _FRAMES_PER_WINDOW)))
    out: list[list[tuple[float, float]]] = []
    base = 0
    for n_frames, n_windows in metas:
        if not n_frames:
            out.append([])
            continue
        flags = (probs[base: base + n_windows].reshape(-1)[:n_frames]
                 > opts.threshold)
        out.append(_spans_from_flags(flags, 0.01, opts))
        base += n_windows
    return out
