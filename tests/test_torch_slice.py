"""The PyTorch port's ingest → query slice as a whole: the same audio through
the port's ``AudioRAG`` and the JAX package's gives identical segment texts,
chunk texts and top-2 rankings, the same DTW word times and segment bounds
within 0.02 s (two decode profiles here; the other five, diarization
and the VAD filter in ``test_torch_slice_profiles.py``); with the default
reranking (the trained eval-small cross-encoder) ``query``,
``query_batch`` and ``get_context`` give the JAX package's rankings, scores
and responses; what the slice does not port raises; the port's entry points
refuse a missing card instead of running on the CPU; the port and
``chip_smoke.py`` import nothing of JAX or of the JAX package."""

import ast
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    AudioRAGConfig,
    ExpansionConfig,
    RerankingConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.pipeline import AudioRAG
from torch_slice_common import (
    PROFILES,
    QUERIES,
    ROOT,
    _jax_rag,
    _port_rag,
    _turn_audio,
    check_slice_profile,
)


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", ["fp32", "int8"])
def test_slice_matches_jax(profile, tmp_path, monkeypatch):
    """Both packages give the same segments, word times (DTW, within
    0.02 s), chunks and rankings in each decode profile
    (:func:`check_slice_profile`)."""
    check_slice_profile(profile, tmp_path, monkeypatch)


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
    """Speech without an answer speaks nothing, as in the JAX package.
    HyDE's sibling, pseudo-relevance feedback (on by default when the expansion
    backend names it), is ported: a query expanded by it gives the JAX
    package's expansion and results (both mine the default collection,
    empty here, so the query stands); an empty collection still
    answers."""
    from audio_rag_tpu.config.schema import ExpansionConfig as JaxExpansion

    jax_rag, port, _ = reranking_rags
    # speech without an answer: neither pipeline speaks
    for rag in (port, jax_rag):
        assert rag.query(QUERIES[0], collection="slice",
                         speak_answer=True).audio is None
    saved = port.config.expansion, jax_rag.config.expansion
    port.config.expansion = ExpansionConfig(backend="prf")
    jax_rag.config.expansion = JaxExpansion(backend="prf")
    try:
        got = port.query(QUERIES[0], collection="slice")
        ref = jax_rag.query(QUERIES[0], collection="slice")
    finally:
        port.config.expansion, jax_rag.config.expansion = saved
        port.querying._expander = jax_rag.querying._expander = None
    assert got.expanded_query == ref.expanded_query == QUERIES[0]
    _assert_same_results(got.results, ref.results)
    assert port.query("nothing here", collection="empty").response == \
        "No relevant content found."


# -- entry points ---------------------------------------------------------------

@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_refuse_a_missing_card(no_cuda):
    from audio_rag_tpu_torch.asr.streaming import StreamingASR
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.device import resolve_device
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    for make in (lambda: AudioRAG(), lambda: AudioRAG(AudioRAGConfig()),
                 lambda: WhisperASR(), lambda: StreamingASR(),
                 lambda: BGEM3Embedder(),
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
        from audio_rag_tpu_torch.config import AudioRAGConfig, load_config
        from audio_rag_tpu_torch.pipeline import AudioRAG
        AudioRAG(AudioRAGConfig(device="cpu"))
        load_config(env="production", overrides={"device": "cpu"})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "audio_rag_tpu",
                                            "yaml"))
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
    """No import of JAX, the JAX package or PyYAML (the card's machine has
    no PyYAML: the port reads its profiles with its own reader), and no
    use of the JAX package's native library or its Makefile: the port
    builds its own copy of the C++ source."""
    files = [ROOT / "chip_smoke.py",
             ROOT / "scripts" / "run_torch.py",
             ROOT / "scripts" / "eval_torch.py",
             *sorted((ROOT / "audio_rag_tpu_torch").rglob("*.py"))]
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "audio_rag_tpu",
                                       "yaml"}
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
