"""The held-out speech sets of the WER harness (counterpart of
``scripts/eval_wer.py``'s sets), built from ``default_rng(777)`` as there,
so the same seed gives the same texts and the same samples:

* **charvoice**: ``n`` utterances in the synthetic voice with noise and
  gain drawn per utterance (one 6 s window each);
* **multi-window**: 16 files of three short utterances with silences
  between, cut into 6 s windows by the transcribe path (window-boundary
  word losses count);
* **tts**: the first ``max(n // 4, 8)`` charvoice texts spoken by the
  trained neural TTS.

The audio is made before any transcription, so one set can be transcribed
by several ASRs (the card's and the CPU's) and compared hypothesis by
hypothesis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audio_rag_tpu_torch.audio.charvoice import (
    SR,
    corpus_lexicon,
    make_utterance_texts,
    synth_text,
)
from audio_rag_tpu_torch.evaluation.wer import WERCounts, aggregate_wer, cer

__all__ = ["SpeechSets", "make_sets", "transcribe_all", "tts_texts",
           "wer_stats", "wer_result", "tiny_asr", "ASR_PROFILES",
           "BASELINE_WER"]

#: the cited (not measured) large-v3 English WER the record sets beside
BASELINE_WER = 0.042

#: the harness's decode profiles: the record's (f32 weights, no quantized
#: decode) and int8 cross K/V + int8 decode weights
ASR_PROFILES = {
    "f32": {},
    "int8": {"cross_kv_int8": True, "decoder_int8": True},
}


def tiny_asr(profile: str = "f32", device: str = "cuda"):
    """The committed trained tiny ASR (tiny-synth, float32, VAD filter and
    temperature ladder off) in ``profile`` on ``device``, loaded."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.config import ASRConfig

    asr = WhisperASR(ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False, **ASR_PROFILES[profile]), device=device)
    asr.load()
    return asr


@dataclass
class SpeechSets:
    texts: list[str]           # the charvoice utterances' texts
    wavs: list[np.ndarray]     # their audio
    stream_refs: list[str]     # each multi-window file's joined texts
    stream_wavs: list[np.ndarray]


def make_sets(n: int = 64, seed: int = 777) -> SpeechSets:
    rng = np.random.default_rng(seed)
    lexicon = corpus_lexicon()
    texts = make_utterance_texts(rng, n, lexicon)
    wavs = []
    for text in texts:
        noise = float(rng.uniform(0, 0.02))
        gain = float(rng.uniform(0.5, 1.2))
        wavs.append(synth_text(text, rng, noise_level=noise, gain=gain))
    refs, streams = [], []
    for _ in range(16):
        texts2 = make_utterance_texts(rng, 3, lexicon, max_frames=330,
                                      max_chars=55)
        pieces = [np.zeros(int(rng.uniform(0.1, 0.4) * SR), np.float32)]
        for tx in texts2:
            pieces.append(synth_text(tx, rng, noise_level=0.005))
            pieces.append(np.zeros(int(rng.uniform(0.3, 0.8) * SR),
                                   np.float32))
        streams.append(np.concatenate(pieces))
        refs.append(" ".join(texts2))
    return SpeechSets(texts, wavs, refs, streams)


def tts_texts(sets: SpeechSets) -> list[str]:
    """The texts the TTS set speaks: the first ``max(n // 4, 8)``."""
    return sets.texts[: max(len(sets.texts) // 4, 8)]


def transcribe_all(asr, wavs: list[np.ndarray]) -> list[str]:
    """Each waveform (16 kHz) through ``asr.transcribe``, its segments'
    texts joined."""
    return [" ".join(s.text for s in asr.transcribe(
        np.asarray(w, np.float32), SR)) for w in wavs]


def wer_stats(refs: list[str], hyps: list[str]) -> tuple[WERCounts, float]:
    """(pooled counts, mean per-utterance CER)."""
    pairs = list(zip(refs, hyps))
    return aggregate_wer(pairs), float(np.mean([cer(r, h)
                                                for r, h in pairs]))


def wer_result(sets: SpeechSets, hyps: list[str], stream_hyps: list[str],
               tts_hyps: list[str] | None, note: str) -> dict:
    """The record's JSON (``docs/bench_runs/wer_tiny_synth.json``'s keys)."""
    charvoice, charvoice_cer = wer_stats(sets.texts, hyps)
    stream, _ = wer_stats(sets.stream_refs, stream_hyps)
    tts_stats = None
    if tts_hyps is not None:
        t, t_cer = wer_stats(tts_texts(sets), tts_hyps)
        tts_stats = {"wer": round(t.wer, 4), "cer": round(t_cer, 4),
                     "n_ref_words": t.n_ref,
                     "substitutions": t.substitutions,
                     "deletions": t.deletions, "insertions": t.insertions}
    return {
        "metric": "wer_tiny_synth",
        "value": round(charvoice.wer, 4),
        "unit": "wer",
        "vs_baseline": round(BASELINE_WER / max(charvoice.wer, 1e-4), 2),
        "extra": {
            "cer": round(charvoice_cer, 4),
            "n_utterances": len(sets.texts),
            "n_ref_words": charvoice.n_ref,
            "substitutions": charvoice.substitutions,
            "deletions": charvoice.deletions,
            "insertions": charvoice.insertions,
            "tts_rendered": tts_stats,
            "multi_window_stream": {
                "wer": round(stream.wer, 4),
                "n_ref_words": stream.n_ref,
                "note": "3-utterance files through the 6 s windowed "
                        "transcribe; includes window-boundary word cuts",
            },
            "baseline_wer_cited": BASELINE_WER,
            "note": note,
        },
    }
