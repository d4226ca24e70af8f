"""The PyTorch port's ingest → query slice as a whole: the same audio through
the port's ``AudioRAG`` and the JAX package's gives identical segment texts,
chunk texts and top-2 rankings, the same DTW word times and segment bounds
within 0.02 s, with diarization the same speakers and chunk bounds, and with
the VAD filter the same spans transcribed; with the default reranking (the
trained eval-small cross-encoder) ``query``, ``query_batch`` and
``get_context`` give the JAX package's rankings, scores and responses; the
port's entry points refuse a missing card instead of running on the CPU;
the port and ``chip_smoke.py`` import nothing of JAX or of the JAX
package."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    ASRConfig,
    AudioRAGConfig,
    ChunkingConfig,
    DiarizationConfig,
    EmbeddingConfig,
    RerankingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
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


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", list(PROFILES))
def test_slice_matches_jax(profile, tmp_path, monkeypatch):
    """Both packages give the same segments, word times (DTW, within
    0.02 s), chunks and rankings in each decode profile. Under int4 cross
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


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
def test_diarized_slice_matches_jax(tmp_path, monkeypatch):
    """The twin of the JAX package's trained end-to-end test on its own
    0.5 s-gap layout and configuration (f32, no VAD filter), diarizing by
    default (clustering, learned VAD, at most 2 speakers): the same chunk
    texts, speakers, start and end, the same top-2 rankings, and the
    spoken words in each query's top hit. (``chip_smoke.py`` runs the int8
    profile of it on the card against this CPU path.)"""
    path = tmp_path / "lecture.wav"
    write_wav(path, _gap_audio(), SR)
    switches = PROFILES["fp32"]
    jax_out = _run_jax(path, switches, monkeypatch, diarize=True,
                       diarization={"backend": "clustering",
                                    "max_speakers": 2}, max_tokens=256)
    port_out = _run_port(path, switches, monkeypatch, diarize=True,
                         diarization=DiarizationConfig(max_speakers=2),
                         max_tokens=256)
    _assert_same_times(port_out[0], jax_out[0])
    (segments, chunks, ranks), (_, jax_chunks, jax_ranks) = port_out, jax_out
    assert [c[:2] for c in chunks] == [c[:2] for c in jax_chunks]
    for got, ref in zip(chunks, jax_chunks):
        assert abs(got[2] - ref[2]) <= TIME_TOL
        assert abs(got[3] - ref[3]) <= TIME_TOL
    assert ranks == jax_ranks
    assert chunks and all(c[1] for c in chunks)
    assert "gradient" in ranks[0][0] or "descent" in ranks[0][0]
    assert "spectrogram" in ranks[1][0] or "harmonic" in ranks[1][0]


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
def test_vad_filtered_transcribe_matches_jax(tmp_path, monkeypatch):
    """With the VAD filter on (the default, learned backend under
    "auto"), both packages transcribe the same speech spans: the same
    segments, word times within 0.02 s, chunks and rankings."""
    path = tmp_path / "lecture.wav"
    write_wav(path, _gap_audio(), SR)
    switches = {"vad_filter": True, "vad_backend": "auto"}
    jax_segments, jax_chunks, jax_ranks = _run_jax(path, switches,
                                                   monkeypatch)
    segments, chunks, ranks = _run_port(path, switches, monkeypatch)
    _assert_same_times(segments, jax_segments)
    assert len(segments) >= 2 and segments[0][1] > 0.3  # spans, not 0 s
    assert [c[0] for c in chunks] == [c[0] for c in jax_chunks]
    assert ranks == jax_ranks
    assert ASRConfig().vad_filter and ASRConfig().vad_backend == "auto"


# -- the query half, reranking by default ----------------------------------------

def _score_tol(score):
    """8e-3 (the ranking goldens' bound), or two bf16 ulps of the score
    where that is more (cross-encoder logits are bf16 values)."""
    a = abs(score)
    return max(8e-3, 2 * 2.0 ** (np.floor(np.log2(a)) - 7) if a else 0)


def _key(r):
    """A chunk's identity across the packages (chunk ids are random)."""
    return r.text, round(r.start, 3)


def _assert_same_results(got, ref):
    """The same chunks in the same order but for near-ties, scores within
    :func:`_score_tol`."""
    ref_score = {_key(r): r.score for r in ref}
    assert len(got) == len(ref) and set(ref_score) == {_key(r) for r in got}
    ranked = [ref_score[_key(r)] for r in got]
    for r in got:
        assert abs(r.score - ref_score[_key(r)]) <= _score_tol(
            ref_score[_key(r)]), (got, ref)
    assert all(a >= b - _score_tol(a) for a, b in zip(ranked, ranked[1:]))


@pytest.fixture(scope="module")
def reranking_rags(tmp_path_factory):
    """The trained spine ingested by both packages with the default
    reranking on the trained eval-small cross-encoder."""
    if not (ASSETS_DIR / "asr_tiny_synth.npz").exists():
        pytest.skip("trained ASR asset not built")
    path = tmp_path_factory.mktemp("query") / "turns.wav"
    write_wav(path, _turn_audio(), SR)
    jax_rag = _jax_rag(PROFILES["fp32"], reranking={
        "backend": "bge-reranker", "model": "eval-small"})
    port = _port_rag(PROFILES["fp32"],
                     reranking=RerankingConfig(model="eval-small"))
    assert port.config.reranking.backend == "bge-reranker"
    for rag in (jax_rag, port):
        rag.ingest(str(path), collection="slice", diarize=False)
    yield jax_rag, port, str(path)
    jax_rag.unload_all()


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_query_reranks_as_jax(reranking_rags, search_type):
    """``query`` with the config's reranking (fused engine: the three
    chunks are reranked although they are fewer than top_k); for hybrid
    search also with a metadata filter (embed → filtered search → rerank,
    which keeps the retrieval scores of three candidates) and with
    ``rerank=False``."""
    jax_rag, port, path = reranking_rags
    extra = ([{"metadata_filter": {"source": path}}, {"rerank": False}]
             if search_type == "hybrid" else [])
    for kw in [{}, *extra]:
        for q in QUERIES:
            ref = jax_rag.query(q, search_type=search_type,
                                collection="slice", **kw)
            got = port.query(q, search_type=search_type, collection="slice",
                             **kw)
            _assert_same_results(got.results, ref.results)
            if list(map(_key, got.results)) == list(map(_key, ref.results)):
                assert got.response == ref.response
            assert set(got.to_dict()) == set(ref.to_dict())
            assert set(got.stage_timings) == set(ref.stage_timings)
    top = port.query(QUERIES[0], collection="slice").results
    assert len(top) == 3 and "gradient" in top[0].text
    assert top[0].score != port.query(QUERIES[0], collection="slice",
                                      rerank=False).results[0].score


def test_query_batch_and_context_match_jax(reranking_rags):
    jax_rag, port, _ = reranking_rags
    ref = jax_rag.query_batch(QUERIES, collection="slice")
    got = port.query_batch(QUERIES, collection="slice")
    for g, r in zip(got, ref):
        _assert_same_results(g.results, r.results)
        assert g.query == r.query and g.elapsed_s > 0
        if list(map(_key, g.results)) == list(map(_key, r.results)):
            assert g.response == r.response
    for q in QUERIES:
        ctx = port.get_context(q, collection="slice")
        assert ctx.startswith("<context>") and ctx.count("<excerpt") == 3
        if list(map(_key, port.query(q, collection="slice").results)) == \
                list(map(_key, jax_rag.query(q, collection="slice").results)):
            assert ctx == jax_rag.get_context(q, collection="slice")


def test_llm_options_are_refused(reranking_rags):
    _, port, _ = reranking_rags
    for kw in ({"use_hyde": True}, {"generate_answer": True},
               {"speak_answer": True}):
        with pytest.raises(ConfigError, match="not ported"):
            port.query(QUERIES[0], collection="slice", **kw)
    assert port.query("nothing here", collection="empty").response == \
        "No relevant content found."


# -- entry points ---------------------------------------------------------------

@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_refuse_a_missing_card(no_cuda):
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.device import resolve_device
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    for make in (lambda: AudioRAG(), lambda: AudioRAG(AudioRAGConfig()),
                 lambda: WhisperASR(), lambda: BGEM3Embedder(),
                 lambda: VectorStore(), lambda: resolve_device("cuda:0")):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ConfigError, match="unsupported"):
        resolve_device("meta")


# -- import isolation ---------------------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import audio_rag_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from audio_rag_tpu_torch.config import AudioRAGConfig
        from audio_rag_tpu_torch.pipeline import AudioRAG
        AudioRAG(AudioRAGConfig(device="cpu"))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "audio_rag_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_of_port_and_chip_smoke_import_no_jax():
    """No import of JAX or the JAX package, and no use of the JAX
    package's native library or its Makefile: the port builds its own
    copy of the C++ source."""
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "audio_rag_tpu_torch").rglob("*.py"))]
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "audio_rag_tpu"}
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    for path in [*files, *sorted(
            (ROOT / "audio_rag_tpu_torch" / "csrc").glob("*.cpp"))]:
        text = path.read_text()
        for name in ("libaudiorag_audio", "Makefile"):
            assert name not in text, f"{path.relative_to(ROOT)} names {name}"


# -- chip_smoke.py without a card -------------------------------------------------

@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(no_cuda, alone, tmp_path):
    """Without a card, and beside nothing of the repository, the script
    exits non-zero and prints no result line."""
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        cwd = ROOT
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
