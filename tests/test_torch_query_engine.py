"""The PyTorch port's batched ``QueryEngine`` against the JAX package's:
``query_batch`` on the eval-small embedder and reranker for every search
type, with rerank on and off, on corpora smaller and larger than
``initial_k``; a replay of ``tests/goldens/rankings.json`` (a real BPE
tokenizer, ``test``-preset weights from ``PRNGKey(0)``) through the
port's engine; the fake reranker, which scores no pairs, is refused."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import EmbeddingConfig as JaxEmbeddingConfig
from audio_rag_tpu.config.schema import RerankingConfig as JaxRerankingConfig
from audio_rag_tpu.config.schema import RetrievalConfig as JaxRetrievalConfig
from audio_rag_tpu.core.types import AudioChunk as JaxChunk
from audio_rag_tpu.embeddings.bge import BGEM3Embedder as JaxEmbedder
from audio_rag_tpu.engine.query_engine import QueryEngine as JaxEngine
from audio_rag_tpu.models import bert as jbert
from audio_rag_tpu.models.bgem3 import init_bgem3 as jax_init_bgem3
from audio_rag_tpu.models.cross_encoder import (
    init_cross_encoder as jax_init_ce,
)
from audio_rag_tpu.reranking.bge import BGEReranker as JaxReranker
from audio_rag_tpu.reranking.fake import FakeReranker as JaxFake
from audio_rag_tpu.retrieval.tpu_store import TPUVectorStore
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    EmbeddingConfig,
    RerankingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import AudioChunk
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.engine.query_engine import QueryEngine
from audio_rag_tpu_torch.models.bert import BERT_PRESETS
from audio_rag_tpu_torch.reranking import BGEReranker, FakeReranker
from audio_rag_tpu_torch.retrieval.store import VectorStore
from audio_rag_tpu_torch.weights import bgem3_params, cross_encoder_params
from torch_llm_common import one_torch_thread  # noqa: F401

GOLDENS = Path(__file__).resolve().parent / "goldens"

#: the JAX goldens' own bound (``tests/integration/test_ranking_goldens.py``)
SCORE_ULP = 8e-3


def score_tol(score: float) -> float:
    """Tolerance of a score against the JAX package's: the goldens' 8e-3,
    or two bf16 ulps of the score where that is more (cross-encoder logits
    are bf16 values; the two packages' bf16 layers round alike but sum in
    other orders, which moves a logit by about an ulp)."""
    a = abs(score)
    return max(SCORE_ULP, 2 * 2.0 ** (np.floor(np.log2(a)) - 7) if a else 0)


TOPICS = ["gradient descent", "learning rate", "spectrogram harmonic",
          "attention layers", "speaker diarization", "cross encoder",
          "vector search", "loss function", "token information",
          "beam search"]


def _corpus(n):
    rng = np.random.default_rng(n)
    words = ("model data signal window audio chunk query vector fusion "
             "rank weight step update noise speech meeting lecture").split()
    return [f"{TOPICS[i % len(TOPICS)]} "
            + " ".join(rng.choice(words, 6 + i % 9).tolist())
            for i in range(n)]


QUERIES = ["gradient descent loss", "spectrogram harmonic structure",
           "which speaker said attention", "vector search fusion rank"]


def _tie_groups(scores, atol=SCORE_ULP):
    """Positions grouped by runs of near-equal reference scores."""
    groups, cur = [], [0]
    for i in range(1, len(scores)):
        if abs(scores[i] - scores[i - 1]) <= atol:
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    groups.append(cur)
    return groups


def assert_same_ranking(rows, ref_rows, k):
    """``rows`` (top ``k``) rank as the deeper reference ``ref_rows`` do up
    to near-ties: each result is a reference hit with its score within
    :func:`score_tol`; no pair of results is ordered against the
    reference by more than the tolerance; no reference hit within the top
    ``k`` that beats the last result by more than the tolerance is
    missing."""
    assert len(rows) == len(ref_rows)
    for qi, (row, ref) in enumerate(zip(rows, ref_rows)):
        ref_score = {r.chunk_id: r.score for r in ref}
        assert len(row) == len(ref[:k]), (qi, row, ref)
        for r in row:
            assert r.chunk_id in ref_score, (qi, r.chunk_id, ref)
            want = ref_score[r.chunk_id]
            assert abs(r.score - want) <= score_tol(want), (
                qi, r.chunk_id, r.score, want)
        got = [ref_score[r.chunk_id] for r in row]
        for i in range(len(got) - 1):
            assert got[i] >= got[i + 1] - score_tol(got[i]), (qi, row, ref)
        if row:
            floor = got[-1] + score_tol(got[-1])
            ids = {r.chunk_id for r in row}
            assert all(r.chunk_id in ids for r in ref[:k]
                       if r.score > floor), (qi, row, ref)


# -- eval-small models on generated corpora ---------------------------------------

@pytest.fixture(scope="module")
def models():
    assert (ASSETS_DIR / "retr_reranker_small.npz").exists()
    j_emb = JaxEmbedder(JaxEmbeddingConfig(model="eval-small"))
    j_emb.load()
    j_rr = JaxReranker(JaxRerankingConfig(model="eval-small"))
    j_rr.load()
    t_emb = BGEM3Embedder(EmbeddingConfig(model="eval-small"), device="cpu")
    t_emb.load()
    t_rr = BGEReranker(RerankingConfig(model="eval-small"), device="cpu")
    t_rr.load()
    yield j_emb, j_rr, t_emb, t_rr
    j_emb.unload()
    j_rr.unload()


def _engines(models, n):
    j_emb, j_rr, t_emb, t_rr = models
    texts = _corpus(n)
    j_store = TPUVectorStore(JaxRetrievalConfig(capacity_step=128))
    j_store.add([JaxChunk(t, float(i), i + 1.0, chunk_id=f"c{i}")
                 for i, t in enumerate(texts)], j_emb.embed(texts))
    t_store = VectorStore(RetrievalConfig(capacity_step=128), device="cpu")
    t_store.add([AudioChunk(t, float(i), i + 1.0, chunk_id=f"c{i}")
                 for i, t in enumerate(texts)], t_emb.embed(texts))
    return JaxEngine(j_emb, j_store, j_rr), QueryEngine(t_emb, t_store, t_rr)


@pytest.fixture(scope="module")
def engines(models):
    """corpus size → (JAX engine, port engine): 12 chunks (below
    initial_k, 20) and 45 (above)."""
    return {n: _engines(models, n) for n in (12, 45)}


@pytest.mark.parametrize("n", [12, 45])
@pytest.mark.parametrize("rerank", [False, True])
@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_query_batch_matches_jax(engines, n, rerank, search_type):
    """The port's top 5 against the JAX engine's top 8 (the same programs:
    8 is the pow-2 bucket of 5), so that near-ties across the cut are
    seen."""
    jax_engine, engine = engines[n]
    kw = dict(search_type=search_type, initial_k=20, rerank=rerank)
    ref = jax_engine.query_batch(QUERIES, top_k=8, **kw)
    got = engine.query_batch(QUERIES, top_k=5, **kw)
    assert_same_ranking(got, ref, 5)
    assert all(len(row) == 5 for row in got)


def test_two_step_rerank_matches_jax(engines):
    """The path without a cross-encoder to run on the device (the JAX
    engine's fallback): search to the host, then ``score_pairs_multi``
    over every (query, candidate) pair."""
    jax_engine, engine = engines[45]
    got, ref = [], []
    for eng, out, k in ((jax_engine, ref, 8), (engine, got, 5)):
        rr = eng.reranker
        eng.reranker = _PairsOnly(rr)
        try:
            out.extend(eng.query_batch(QUERIES, top_k=k, initial_k=20))
        finally:
            eng.reranker = rr
    assert_same_ranking(got, ref, 5)


class _PairsOnly:
    """A reranker that scores pairs but that the engine cannot run on the
    device (no ``_params`` for the JAX engine, no ``forward_ids`` for the
    port's)."""

    def __init__(self, rr):
        self._rr = rr

    def score_pairs_multi(self, queries, texts):
        return self._rr.score_pairs_multi(queries, texts)


def test_fake_reranker_is_refused(engines):
    """The JAX engine sends a fake reranker down the two-step path, where
    it has no ``score_pairs_multi`` (AttributeError); the port raises a
    ConfigError that says so."""
    jax_engine, engine = engines[12]
    saved = jax_engine.reranker
    jax_engine.reranker = JaxFake()
    try:
        with pytest.raises(AttributeError, match="score_pairs_multi"):
            jax_engine.query_batch(QUERIES[:1])
    finally:
        jax_engine.reranker = saved
    saved = engine.reranker
    engine.reranker = FakeReranker()
    try:
        with pytest.raises(ConfigError, match="scores no"):
            engine.query_batch(QUERIES[:1])
        assert len(engine.query_batch(QUERIES[:1], rerank=False)[0]) == 5
    finally:
        engine.reranker = saved


def test_a_failing_cross_encoder_raises(engines, monkeypatch):
    """The JAX engine falls back to the two-step path when the rerank on
    the device fails; the port's raises."""
    _, engine = engines[12]

    def broken(ids):
        raise RuntimeError("cross-encoder failed")

    monkeypatch.setattr(engine.reranker, "forward_ids", broken)
    with pytest.raises(RuntimeError, match="cross-encoder failed"):
        engine.query_batch(QUERIES)


def test_reranker_cache_follows_the_collection(models):
    """Rows are appended as the collection grows and rebuilt when it is
    recreated; results stay those of a fresh engine."""
    _, _, t_emb, t_rr = models
    texts = _corpus(30)
    store = VectorStore(RetrievalConfig(capacity_step=16), device="cpu")
    engine = QueryEngine(t_emb, store, t_rr)

    def add(lo, hi):
        store.add([AudioChunk(t, float(i), i + 1.0, chunk_id=f"c{i}")
                   for i, t in enumerate(texts[lo:hi], lo)],
                  t_emb.embed(texts[lo:hi]))

    add(0, 10)
    engine.query_batch(QUERIES)
    add(10, 30)  # grows past one capacity step
    got = engine.query_batch(QUERIES)
    fresh = QueryEngine(t_emb, store, t_rr).query_batch(QUERIES)
    assert [[(r.chunk_id, r.score) for r in row] for row in got] == \
        [[(r.chunk_id, r.score) for r in row] for row in fresh]
    uid = store._coll(None).uid
    store.delete_collection()
    add(0, 5)
    assert store._coll(None).uid != uid
    got = engine.query_batch(QUERIES)
    assert {r.chunk_id for row in got for r in row} <= {f"c{i}"
                                                        for i in range(5)}


# -- the ranking goldens --------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_engine():
    """The goldens' setup in the port: ``test``-preset BGE-M3 and
    cross-encoder weights from the JAX package's ``PRNGKey(0)``, carried
    across, and the goldens' HF tokenizer put into both models (the port
    itself reads no HF tokenizer)."""
    from audio_rag_tpu.text.tokenizer import HFTokenizer

    golden = json.loads((GOLDENS / "rankings.json").read_text())
    tok = HFTokenizer(str(GOLDENS / "tiny_tokenizer"))
    jdims = jbert.BERT_PRESETS["test"]
    dims = BERT_PRESETS["test"]
    emb = BGEM3Embedder(EmbeddingConfig(model="test"), device="cpu")
    emb._params = bgem3_params(
        jax.tree.map(np.asarray, jax_init_bgem3(jax.random.PRNGKey(0),
                                                jdims)),
        dims, "cpu", dtype=torch.bfloat16)
    emb._tok = tok
    rr = BGEReranker(RerankingConfig(model="test", fused_doc_tokens=64),
                     device="cpu")
    rr._params = cross_encoder_params(
        jax.tree.map(np.asarray, jax_init_ce(jax.random.PRNGKey(0), jdims)),
        dims, "cpu", dtype=torch.bfloat16)
    rr._tok = tok
    store = VectorStore(RetrievalConfig(capacity_step=128), device="cpu")
    corpus = golden["corpus"]
    store.add([AudioChunk(t, float(i) * 30.0, float(i + 1) * 30.0,
                          speaker=f"SPEAKER_{i % 2:02d}", chunk_id=f"g{i:02d}")
               for i, t in enumerate(corpus)], emb.embed(corpus))
    return golden, QueryEngine(emb, store, rr)


@pytest.mark.parametrize("stype", ["dense", "hybrid"])
@pytest.mark.parametrize("rerank", [False, True])
def test_rankings_match_golden(golden_engine, stype, rerank):
    golden, engine = golden_engine
    rows = engine.query_batch(golden["queries"], top_k=5, search_type=stype,
                              rerank=rerank)
    expected = golden["runs"][f"{stype}_rerank{int(rerank)}"]
    for qi, (row, exp) in enumerate(zip(rows, expected)):
        ids = [r.chunk_id for r in row]
        for grp in _tie_groups(exp["scores"]):
            assert sorted(ids[g] for g in grp) == \
                sorted(exp["ids"][g] for g in grp), (
                    f"ranking drift on query {qi}: {golden['queries'][qi]!r}"
                    f" — got {ids}, want {exp['ids']}")
        np.testing.assert_allclose([r.score for r in row], exp["scores"],
                                   atol=SCORE_ULP,
                                   err_msg=f"score drift on query {qi}")
