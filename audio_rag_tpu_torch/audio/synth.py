"""Synthetic speech-shaped audio and parametric voices.

Own copy of ``audio_rag_tpu/audio/synth.py``: :func:`speech_like` (a
harmonic stack with syllabic amplitude modulation, which the learned VAD
takes for speech) and a source-filter voice per speaker (pitch, formants,
spectral tilt, vibrato, breathiness: :class:`VoiceProfile`,
:func:`sample_voice`), its :func:`utterance`, and multi-speaker
:func:`conversation` with ground-truth turns, the audio the diarization
error rate is scored on. The same ``numpy.random.Generator`` draws give
the same samples as the JAX package's copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "speech_like",
    "VoiceProfile",
    "sample_voice",
    "utterance",
    "conversation",
]


def speech_like(
    n_samples: int,
    sample_rate: int = 16_000,
    f0: float = 160.0,
    am_hz: float = 4.0,
    level: float = 0.4,
    seed: int | None = None,
) -> np.ndarray:
    """Voiced-speech-shaped signal: harmonics of ``f0`` with 2–8 Hz
    amplitude modulation; optional noise floor when ``seed`` is given."""
    t = np.arange(n_samples) / sample_rate
    phase = 2 * np.pi * f0 * t
    sig = sum(np.sin(h * phase) / h for h in range(1, 7))
    sig *= 0.3 + 0.7 * 0.5 * (1 + np.sin(2 * np.pi * am_hz * t))
    sig = level * sig / (np.abs(sig).max() + 1e-9)
    if seed is not None:
        sig = sig + 0.02 * np.random.default_rng(seed).standard_normal(
            n_samples)
    return sig.astype(np.float32)


# -- parametric voice identities ------------------------------------------


@dataclasses.dataclass(frozen=True)
class VoiceProfile:
    """Per-speaker acoustic identity for the source-filter synthesizer.

    The discriminable axes mirror what real speaker embeddings latch
    onto: fundamental frequency, vocal-tract resonances (formants), and
    glottal spectral tilt.
    """

    f0: float                       # base pitch, Hz
    formants: tuple[float, ...]     # resonance centers, Hz
    bandwidths: tuple[float, ...]   # resonance bandwidths, Hz
    tilt: float                     # harmonic rolloff exponent
    vibrato_hz: float
    vibrato_depth: float            # relative f0 excursion
    breathiness: float              # aspiration-noise level


def sample_voice(rng: np.random.Generator) -> VoiceProfile:
    """Draw a random voice. Wide ranges → voices are well-spread; two
    independent draws almost surely differ in pitch AND formant layout."""
    f0 = float(np.exp(rng.uniform(np.log(80.0), np.log(300.0))))
    # formant layouts roughly spanning male..female..child tract lengths
    scale = rng.uniform(0.85, 1.25)
    jitter = rng.uniform(0.88, 1.12, size=3)
    formants = tuple(float(f * scale * j) for f, j in
                     zip((550.0, 1650.0, 2750.0), jitter))
    bandwidths = tuple(float(rng.uniform(60.0, 140.0) * (1 + 0.5 * i))
                       for i in range(3))
    return VoiceProfile(
        f0=f0,
        formants=formants,
        bandwidths=bandwidths,
        tilt=float(rng.uniform(0.6, 1.6)),
        vibrato_hz=float(rng.uniform(3.0, 7.0)),
        vibrato_depth=float(rng.uniform(0.005, 0.03)),
        breathiness=float(rng.uniform(0.005, 0.05)),
    )


def _formant_fir(voice: VoiceProfile, sr: int, n_taps: int = 129
                 ) -> np.ndarray:
    """Linear-phase FIR with resonant peaks at the voice's formants."""
    n_fft = 1024
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mag = np.full_like(freqs, 0.05)
    for fc, bw in zip(voice.formants, voice.bandwidths):
        mag += np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
    # gentle high-frequency rolloff (lip radiation + tract losses)
    mag *= 1.0 / (1.0 + (freqs / 4000.0) ** 2)
    impulse = np.fft.irfft(mag, n_fft)
    impulse = np.roll(impulse, n_taps // 2)[:n_taps]
    return (impulse * np.hanning(n_taps)).astype(np.float64)


def utterance(
    rng: np.random.Generator,
    voice: VoiceProfile,
    duration_s: float,
    sample_rate: int = 16_000,
    level: float = 0.35,
) -> np.ndarray:
    """One utterance by ``voice``: harmonic source with syllabic f0
    movement and amplitude modulation, filtered by the voice's formant
    FIR, plus aspiration noise."""
    n = int(duration_s * sample_rate)
    t = np.arange(n) / sample_rate
    # f0 contour: slow random walk (prosody) + vibrato, around voice.f0
    walk = np.cumsum(rng.standard_normal(max(n // 1600, 2)))
    walk = np.interp(np.linspace(0, 1, n), np.linspace(0, 1, walk.size),
                     walk)
    walk = walk - walk.mean()
    f0_t = voice.f0 * np.exp(
        0.06 * walk
        + voice.vibrato_depth * np.sin(2 * np.pi * voice.vibrato_hz * t)
    )
    phase = 2 * np.pi * np.cumsum(f0_t) / sample_rate
    nyq = sample_rate / 2
    sig = np.zeros(n)
    max_h = max(int(min(4000.0, nyq * 0.9) / voice.f0), 2)
    for h in range(1, max_h + 1):
        sig += np.sin(h * phase) / h ** voice.tilt
    sig = np.convolve(sig, _formant_fir(voice, sample_rate), mode="same")
    # syllabic AM (3-7 Hz) with occasional near-closures
    am_hz = rng.uniform(3.0, 7.0)
    am = 0.5 * (1 + np.sin(2 * np.pi * am_hz * t + rng.uniform(0, 6.28)))
    sig *= 0.25 + 0.75 * am ** rng.uniform(1.0, 1.8)
    sig += voice.breathiness * rng.standard_normal(n)
    sig = level * sig / (np.abs(sig).max() + 1e-9)
    return sig.astype(np.float32)


def conversation(
    rng: np.random.Generator,
    voices: list[VoiceProfile],
    duration_s: float,
    sample_rate: int = 16_000,
    turn_s: tuple[float, float] = (2.0, 6.0),
    gap_s: tuple[float, float] = (0.3, 1.0),
) -> tuple[np.ndarray, list[tuple[float, float, int]]]:
    """Round-robin-ish multi-speaker conversation.

    Returns ``(audio, turns)`` where ``turns`` is a list of
    ``(start_s, end_s, speaker_index)`` ground-truth spans — the
    reference labels the DER tests score against.
    """
    n = int(duration_s * sample_rate)
    audio = np.zeros(n, np.float32)
    turns: list[tuple[float, float, int]] = []
    t = float(rng.uniform(0.0, 0.5))
    prev = -1
    while t < duration_s - turn_s[0]:
        # pick a speaker, avoiding immediate self-succession mostly
        cand = int(rng.integers(0, len(voices)))
        if cand == prev and len(voices) > 1 and rng.random() < 0.8:
            cand = (cand + 1 + int(rng.integers(0, len(voices) - 1))) \
                % len(voices)
        dur = float(rng.uniform(*turn_s))
        dur = min(dur, duration_s - t)
        if dur < 0.8:
            break
        i0 = int(t * sample_rate)
        seg = utterance(rng, voices[cand], dur, sample_rate,
                        level=float(rng.uniform(0.25, 0.5)))
        audio[i0: i0 + seg.size] += seg
        turns.append((round(t, 3), round(t + dur, 3), cand))
        prev = cand
        t += dur + float(rng.uniform(*gap_s))
    return audio, turns
