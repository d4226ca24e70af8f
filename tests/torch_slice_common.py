"""Shared pieces of the slice tests (``tests/test_torch_slice*.py``): the
spine's spoken turns, the decode profiles both packages take, both
packages' pipelines as the slice runs them, and the comparison of one
profile's ingest and rankings."""

from pathlib import Path

import numpy as np

from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu_torch.config import (
    ASRConfig,
    AudioRAGConfig,
    ChunkingConfig,
    DiarizationConfig,
    EmbeddingConfig,
    RerankingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.pipeline import AudioRAG

ROOT = Path(__file__).resolve().parents[1]
TURNS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure",
         "attention layers mix token information"]
QUERIES = ["gradient descent loss", "spectrogram harmonic"]
WINDOW_S = 6.0  # tiny-synth's audio context


def _turn_audio():
    """The JAX trained end-to-end test's turns (rng 7), each 0.3 s into a
    6 s window of its own, so that each turn is one segment and one chunk
    when diarization is off."""
    rng = np.random.default_rng(7)
    win, lead = int(WINDOW_S * SR), int(0.3 * SR)
    out = np.zeros(len(TURNS) * win, np.float32)
    for i, text in enumerate(TURNS):
        wav = synth_text(text, rng, noise_level=0.005)
        out[i * win + lead: i * win + lead + wav.size] = wav
    return out


def _gap_audio():
    """The JAX trained end-to-end test's own layout: 0.3 s of silence, then
    each turn (rng 7) followed by 0.5 s of silence."""
    rng = np.random.default_rng(7)
    pieces = [np.zeros(int(0.3 * SR), np.float32)]
    for text in TURNS:
        pieces.append(synth_text(text, rng, noise_level=0.005))
        pieces.append(np.zeros(int(0.5 * SR), np.float32))
    return np.concatenate(pieces)


TIME_TOL = 0.02  # one encoder frame


def _timed(segments):
    """(text, start, end, [(word, start, end)]) of each segment."""
    return [(s.text, float(s.start), float(s.end),
             [(w.text, float(w.start), float(w.end)) for w in s.words])
            for s in segments]


def _assert_same_times(got, ref):
    """Same segment and word texts; bounds and word times within 0.02 s."""
    assert [g[0] for g in got] == [r[0] for r in ref]
    for (_, gs, ge, gw), (_, rs, re, rw) in zip(got, ref):
        assert abs(gs - rs) <= TIME_TOL and abs(ge - re) <= TIME_TOL, (
            (gs, ge), (rs, re))
        assert [w[0] for w in gw] == [w[0] for w in rw]
        for (_, a, b), (_, c, d) in zip(gw, rw):
            assert abs(a - c) <= TIME_TOL and abs(b - d) <= TIME_TOL, (
                gw, rw)


def _spy(monkeypatch, obj, name, seen):
    orig = getattr(obj, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen.extend(out)
        return out

    monkeypatch.setattr(obj, name, spy)


#: profile → the ASR quantization switches both packages take
PROFILES = {
    "fp32": {},
    "int8": {"cross_kv_int8": True, "decoder_int8": True},
    "int8+dec4+skv8": {"cross_kv_int8": True, "decoder_int4": True,
                       "self_kv_int8": True},
    "kv4+int8+lm4": {"cross_kv_int4": True, "decoder_int8": True,
                     "lm_head_int4": True},
    # beam search (the port's default lazy reorder) and speculative greedy
    # decoding in the production profile
    "beam5+int8": {"cross_kv_int8": True, "decoder_int8": True,
                   "decode": "beam", "beam_size": 5},
    "spec8+int8": {"cross_kv_int8": True, "decoder_int8": True,
                   "speculative_k": 8},
    # the temperature-fallback ladder on in both packages (the profiles
    # above run it off on both sides)
    "fp32+ladder": {"temperature_fallback": True},
}


def _jax_rag(switches, diarization=None, max_tokens=8, reranking=None):
    """The JAX package's pipeline as the port runs: one device, so each
    window's log-mel is clamped to its own max − 8 (``mel_sharded=False``;
    the test process's 8 virtual CPU devices would otherwise compute a
    time-contiguous batch's mel as one span with one clamp)."""
    cfg = JaxConfig(**{
        "asr": {"backend": "whisper-jax", "model_size": "tiny-synth",
                "compute_type": "float32", "vad_filter": False,
                "temperature_fallback": False, "mel_sharded": False,
                **switches},
        **({"diarization": diarization} if diarization else {}),
        "embedding": {"backend": "bge-m3", "model": "eval-small"},
        "retrieval": {"backend": "tpu", "capacity_step": 128},
        "reranking": reranking or {"backend": "none"},
        "generation": {"backend": "none"},
        "tts": {"backend": "null"},
        "chunking": {"min_chunk_tokens": 1, "overlap_tokens": 0},
    })
    # max_tokens 8: one chunk per window (below the schema's floor of 50)
    cfg.chunking.max_tokens = max_tokens
    return JaxAudioRAG(cfg)


def _port_rag(switches, diarization=None, max_tokens=8, reranking=None):
    return AudioRAG(AudioRAGConfig(
        asr=ASRConfig(**{"model_size": "tiny-synth",
                         "compute_type": "float32", "vad_filter": False,
                         "temperature_fallback": False, **switches}),
        diarization=diarization or DiarizationConfig(),
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        # as the JAX side (``_jax_rag``): no reranking unless asked for
        reranking=reranking or RerankingConfig(backend="none"),
        chunking=ChunkingConfig(max_tokens=max_tokens, min_chunk_tokens=1,
                                overlap_tokens=0),
        device="cpu"))


def _chunks(payloads):
    return [(p["text"], p["speaker"], float(p["start"]), float(p["end"]))
            for p in payloads]


def _run_jax(path, switches, monkeypatch, diarize=False, **rag_kw):
    rag = _jax_rag(switches, **rag_kw)
    try:
        segments = []
        _spy(monkeypatch, rag.ingestion.asr, "transcribe_with_words",
             segments)
        rag.ingest(str(path), collection="slice", diarize=diarize)
        chunks = _chunks(rag._retriever._coll("slice").payloads)
        ranks = [[r.text for r in rag.query(
            q, top_k=2, search_type="hybrid", collection="slice").results]
            for q in QUERIES]
    finally:
        rag.unload_all()
    return _timed(segments), chunks, ranks


def _run_port(path, switches, monkeypatch, diarize=False, **rag_kw):
    rag = _port_rag(switches, **rag_kw)
    segments = []
    _spy(monkeypatch, rag.asr, "transcribe_with_words", segments)
    res = rag.ingest(str(path), collection="slice", diarize=diarize)
    chunks = _chunks(rag.store._coll("slice").payloads)
    ranks = [[r.text for r in rag.query(
        q, top_k=2, search_type="hybrid", collection="slice").results]
        for q in QUERIES]
    assert res.num_chunks == len(chunks) == rag.count("slice")
    assert all(w.end >= w.start for s in segments for w in s.words)
    assert set(res.stage_timings) >= (
        {"transcribe", "diarize", "align"} if diarize else {"transcribe"})
    return _timed(segments), chunks, ranks


def check_slice_profile(profile, tmp_path, monkeypatch):
    """Both packages give the same segments, word times (DTW, within
    0.02 s), chunks and rankings in the decode profile. Under int4 cross
    K/V the JAX package garbles the turns' words on tiny-synth ("gradint
    descescent"), so there the port is held to it and not to the spoken
    words."""
    path = tmp_path / "turns.wav"
    write_wav(path, _turn_audio(), SR)
    switches = PROFILES[profile]
    jax_segments, jax_chunks, jax_ranks = _run_jax(path, switches,
                                                   monkeypatch)
    segments, chunks, ranks = _run_port(path, switches, monkeypatch)
    _assert_same_times(segments, jax_segments)
    assert [c[0] for c in chunks] == [c[0] for c in jax_chunks]
    assert ranks == jax_ranks
    assert len(chunks) == 3
    if not switches.get("cross_kv_int4"):
        # the spoken content is what the queries find
        assert "gradient" in ranks[0][0] and "spectrogram" in ranks[1][0]
