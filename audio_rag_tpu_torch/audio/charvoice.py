"""The deterministic synthetic "charvoice" (numpy copy of
``audio_rag_tpu/audio/charvoice.py``): every character has a fixed spectral
identity and duration class. The committed tiny Whisper asset was trained
to transcribe this voice, so speech rendered here closes the speech → text
loop without downloaded weights. Deterministic given the rng; the same rng
gives the same samples, and the same utterance texts, as the JAX package's
copy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SR", "HOP", "VOWELS", "char_duration", "synth_char", "synth_text",
           "corpus_lexicon", "make_utterance_texts"]

SR = 16_000
HOP = 160  # one duration frame = 10 ms

VOWELS = "aeiou"


def char_duration(c: str) -> int:
    """Frames (10 ms) per character."""
    if c in VOWELS:
        return 9
    if c == " ":
        return 6
    if c.isdigit():
        return 7
    if c.isalpha():
        return 5
    return 10  # punctuation = pause


def vowel_f0(c: str) -> float:
    return 120.0 + 18.0 * VOWELS.index(c)


def char_band(c: str) -> float:
    """Per-character spectral center (Hz) — each symbol's identity."""
    if c in VOWELS:
        return 450.0 + 220.0 * VOWELS.index(c)
    if c.isalpha():
        k = "bcdfghjklmnpqrstvwxyz".index(c)
        return 900.0 + 140.0 * k
    if c.isdigit():
        return 600.0 + 130.0 * int(c)
    return 0.0


def synth_char(c: str, rng: np.random.Generator) -> np.ndarray:
    """Waveform for one character at its duration."""
    n = char_duration(c) * HOP
    t = np.arange(n) / SR
    if c == " " or not c.isalnum():
        return np.zeros(n, np.float32)
    if c in VOWELS:
        f0 = vowel_f0(c)
        sig = np.zeros(n)
        band = char_band(c)
        for h in range(1, 13):
            f = h * f0
            amp = np.exp(-0.5 * ((f - band) / 220.0) ** 2) + 0.15 / h
            sig += amp * np.sin(2 * np.pi * f * t)
    elif c.isdigit():
        lo = 400.0 + 40.0 * int(c)
        sig = np.sin(2 * np.pi * lo * t) + np.sin(
            2 * np.pi * char_band(c) * 2.0 * t)
    else:
        band = char_band(c)
        tone = np.sin(2 * np.pi * band * t)
        noise = rng.standard_normal(n)
        taps = np.sinc(np.linspace(-3, 3, 25)) * np.hanning(25)
        taps = taps * np.cos(2 * np.pi * (band / SR) * np.arange(25))
        noise = np.convolve(noise, taps, mode="same")
        noise /= np.abs(noise).max() + 1e-9
        sig = 0.75 * tone + 0.35 * noise
    env = np.minimum(1.0, np.minimum(t, (n / SR) - t) / 0.012)  # 12ms ramps
    sig = sig * env
    return (sig / (np.abs(sig).max() + 1e-9)).astype(np.float32) * 0.6


def synth_text(
    text: str,
    rng: np.random.Generator,
    noise_level: float = 0.0,
    gain: float = 1.0,
) -> np.ndarray:
    """Speak ``text`` in the charvoice: concatenated per-char waveforms."""
    pieces = [synth_char(c, rng) for c in text.lower()]
    audio = (np.concatenate(pieces) if pieces
             else np.zeros(HOP, np.float32))
    audio = gain * audio
    if noise_level > 0.0:
        audio = audio + noise_level * rng.standard_normal(
            audio.size).astype(np.float32)
    return audio.astype(np.float32)


# -- utterance texts (the WER sets and the audio-in ladder speak them) --

_WORD_CHARS = "abcdefghijklmnopqrstuvwxyz"


def corpus_lexicon() -> list[str]:
    """Pseudo-English words from the discriminating eval corpus — the
    text distribution the audio-in quality ladder speaks."""
    from audio_rag_tpu_torch.evaluation.corpus import make_corpus

    c = make_corpus()
    words: set[str] = set()
    for chunk in c.chunks[:120]:
        for w in chunk.lower().split():
            w = w.strip(".,;:!?()[]\"'")
            if w and all(ch in _WORD_CHARS + "0123456789" for ch in w):
                words.add(w)
    return sorted(words)


def make_utterance_texts(
    rng: np.random.Generator, n: int, lexicon: list[str],
    max_frames: int = 540, max_chars: int = 100,
    double_p: float = 0.0,
) -> list[str]:
    """Utterance texts fitting one 6 s tiny-synth window (≤ ``max_frames``
    charvoice duration frames and ≤ ``max_chars`` chars): a mix of
    corpus-lexicon words, random letter strings, and digit strings.

    ``double_p``: per-word probability of doubling one letter — a
    TRAINING-side boost (repeated chars render as one long tone with only
    an amplitude dip, the hardest case; eval keeps the natural rate)."""
    texts = []
    for _ in range(n):
        words: list[str] = []
        frames = 0
        budget = int(rng.integers(150, max_frames))
        while True:
            if rng.random() < 0.55 and lexicon:
                w = lexicon[int(rng.integers(len(lexicon)))]
            elif rng.random() < 0.12:
                w = "".join(
                    rng.choice(list("0123456789"),
                               int(rng.integers(1, 5))))
            else:
                w = "".join(
                    rng.choice(list(_WORD_CHARS),
                               int(rng.integers(2, 9))))
            if double_p and rng.random() < double_p and w.isalpha():
                j = int(rng.integers(len(w)))
                w = w[:j] + w[j] + w[j:]
            need = sum(char_duration(c) for c in w) + char_duration(" ")
            if (frames + need > budget
                    or len(" ".join(words + [w])) > max_chars):
                break
            words.append(w)
            frames += need
        if not words:
            words = ["ok"]
        texts.append(" ".join(words))
    return texts
