"""The PyTorch port's ingest → query slice in four of its decode profiles
(int4 weights with an int8 self cache, beam search, speculative greedy,
the fallback ladder) and its query half with the default reranking, apart
from ``test_torch_slice.py`` so that the two files share the test run's
workers: the same audio through both packages' ``AudioRAG`` gives the
same segments, word times, chunks and rankings; with the default
reranking (the trained eval-small cross-encoder) ``query``,
``query_batch`` and ``get_context`` give the JAX package's rankings,
scores and responses; what the slice does not port raises."""

import numpy as np
import pytest

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import ExpansionConfig, RerankingConfig
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import (
    PROFILES,
    QUERIES,
    _jax_rag,
    _port_rag,
    _turn_audio,
    check_slice_profile,
)


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", ["int8+dec4+skv8", "beam5+int8",
                                     "spec8+int8", "fp32+ladder"])
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
