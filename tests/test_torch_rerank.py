"""The PyTorch port's cross-encoder and BGE reranker against the JAX
package's: the forward on the committed trained reranker and NLI assets
and on ``test``-preset trees from ``PRNGKey(0)``, the pair tokenizer, the
reranker's pair scores (in both batch-bucket regimes) and its reranking,
short-circuit included; a failing reranker raises in the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import RerankingConfig as JaxRerankingConfig
from audio_rag_tpu.core.types import RetrievalResult as JaxResult
from audio_rag_tpu.models import bert as jbert
from audio_rag_tpu.models import cross_encoder as jce
from audio_rag_tpu.reranking.bge import BGEReranker as JaxReranker
from audio_rag_tpu.text.tokenizer import HashWordTokenizer as JaxTokenizer
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.config import RerankingConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.models import bert as tbert
from audio_rag_tpu_torch.models import cross_encoder as tce
from audio_rag_tpu_torch.reranking import (
    BGEReranker,
    FakeReranker,
    create_reranker,
)
from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer
from audio_rag_tpu_torch.weights import cross_encoder_params
from torch_llm_common import one_torch_thread  # noqa: F401

QUERY = "gradient descent loss"
PASSAGES = [
    "gradient descent minimizes the loss function",
    "the spectrogram shows harmonic structure",
    "attention layers mix token information",
    "the learning rate controls the step size of gradient descent",
    "regularization adds a penalty on large weights",
    "a loss that is too flat makes descent slow",
    "clustering groups similar examples without labels",
    # longer than the small presets' 128 positions: truncated to the
    # reranker's max_len; in the query engine its row runs past the
    # position table, whose last row then repeats (clamped)
    " ".join(f"w{i}" for i in range(150)) + " gradient descent",
]


def _tol(ref):
    """The ranking goldens' 8e-3, or two bf16 ulps of ``ref`` where that
    is more: both packages round the logits to bf16, after bf16 layers
    that round alike but sum in other orders (which moves a logit by about
    an ulp)."""
    a = np.abs(np.asarray(ref, np.float64))
    ulp = np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1)))
                                  - 7), 0)
    return np.maximum(8e-3, 2 * ulp)


def _assert_close_bf16(got, ref):
    """Each logit within :func:`_tol` of the JAX package's."""
    got, ref = np.asarray(got), np.asarray(ref)
    tol = _tol(ref)
    bad = np.abs(got - ref) > tol
    assert not bad.any(), (got[bad], ref[bad], tol[bad])


# -- the model ---------------------------------------------------------------------

def _trees():
    """name → (JAX-layout numpy tree, preset, head width)."""
    out = {}
    for name, asset, n_out in (("reranker", "retr_reranker_small.npz", 1),
                               ("nli", "nli_small.npz", 3)):
        tree = load_npz_asset(ASSETS_DIR / asset)
        if tree is not None:
            out[name] = (tree, "retrieval-small" if n_out == 1
                         else "nli-small", n_out)
    for n_out in (1, 3):
        tree = jce.init_cross_encoder(jax.random.PRNGKey(0),
                                      jbert.BERT_PRESETS["test"], n_out)
        out[f"test{n_out}"] = (jax.tree.map(np.asarray, tree), "test", n_out)
    return out


TREES = _trees()


def _stored(tree, dtype):
    """The tree on the JAX device, in bf16 as the JAX reranker stores it
    (``bf16_storage``) when the compute is bf16."""
    return jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, dtype)), tree)


def _pair_rows(rng, vocab, B=4, T=160):
    """−1-padded rows: ragged lengths, one row with a hole of −1 between a
    prefix and a passage (the query engine's rows), one longer than the
    presets' 128 positions."""
    ids = rng.integers(4, vocab, (B, T)).astype(np.int64)
    ids[:, 0] = 0
    ids[0, 40:] = -1
    ids[1, 9:16] = -1  # a hole
    ids[1, 90:] = -1
    ids[2, 20:] = -1
    return ids  # row 3 runs the full 160 positions


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encoder_matches_jax(name, dtype):
    tree, preset, n_out = TREES[name]
    jdims, tdims = jbert.BERT_PRESETS[preset], tbert.BERT_PRESETS[preset]
    assert dataclasses.astuple(tdims) == dataclasses.astuple(jdims)
    ids = _pair_rows(np.random.default_rng(0), jdims.vocab)
    mask = (ids >= 0).astype(np.int32)
    tokens = np.where(mask > 0, ids, jdims.pad_id)
    fwd_j = jce.nli_forward if n_out == 3 else jce.cross_encoder_forward
    fwd_t = tce.nli_forward if n_out == 3 else tce.cross_encoder_forward
    # jitted, as the JAX reranker runs it (eager ops round every output)
    ref = np.asarray(jax.jit(lambda p, t, m: fwd_j(p, jdims, t, m, getattr(
        jnp, dtype)))(_stored(tree, dtype), jnp.asarray(tokens, jnp.int32),
                      jnp.asarray(mask)))
    params = cross_encoder_params(tree, tdims, "cpu",
                                  dtype=getattr(torch, dtype))
    got = fwd_t(params, tdims, torch.from_numpy(tokens),
                torch.from_numpy(mask), getattr(torch, dtype)).numpy()
    assert got.shape == ref.shape == ((4, 3) if n_out == 3 else (4,))
    assert got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(
            1.0, np.max(np.abs(ref))))
    else:
        _assert_close_bf16(got, ref)


def test_cross_encoder_params_checks_the_tree():
    tree, _, _ = TREES["test1"]
    dims = tbert.BERT_PRESETS["test"]
    bad = {**tree, "out": {"w": tree["out"]["w"]}}
    with pytest.raises(KeyError):
        cross_encoder_params(bad, dims)
    with pytest.raises(ValueError):
        cross_encoder_params(tree, tbert.BERT_PRESETS["retrieval-small"])
    for preset in ("xlmr-base", "nli-small"):
        assert dataclasses.astuple(tbert.BERT_PRESETS[preset]) == \
            dataclasses.astuple(jbert.BERT_PRESETS[preset])
    init = tce.init_cross_encoder(dims, n_out=3, seed=1)
    assert init["out"]["w"].shape == (64, 3)


@pytest.mark.parametrize("max_len", [6, 12, 128])
def test_encode_pair_matches_jax(max_len):
    a = "what is gradient descent and why"
    for b in PASSAGES:
        assert HashWordTokenizer(4096).encode_pair(a, b, max_len) == \
            JaxTokenizer(4096).encode_pair(a, b, max_len)


# -- the reranker ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def rerankers():
    assert (ASSETS_DIR / "retr_reranker_small.npz").exists()
    jax_rr = JaxReranker(JaxRerankingConfig(model="eval-small"))
    jax_rr.load()
    port = BGEReranker(RerankingConfig(model="eval-small"), device="cpu")
    port.load()
    yield jax_rr, port
    jax_rr.unload()


def test_score_pairs_match_jax(rerankers):
    jax_rr, port = rerankers
    ref = jax_rr.score_pairs(QUERY, PASSAGES)
    got = port.score_pairs(QUERY, PASSAGES)
    _assert_close_bf16(got, ref)
    assert np.argmax(got) == np.argmax(ref) == 0


@pytest.mark.parametrize("n", [3, 300])
def test_score_pairs_multi_match_jax(rerankers, n):
    """3 pairs (a pow-2 batch bucket) and 300 (a multiple of 512)."""
    jax_rr, port = rerankers
    rng = np.random.default_rng(n)
    queries = [f"{QUERY} {w}" for w in rng.choice(
        ["harmonic", "weights", "labels", "rate"], n)]
    # the short passages: the long one is score_pairs' case
    texts = [PASSAGES[i] for i in rng.integers(0, len(PASSAGES) - 1, n)]
    ref = jax_rr.score_pairs_multi(queries, texts)
    got = port.score_pairs_multi(queries, texts)
    assert got.shape == ref.shape == (n,)
    _assert_close_bf16(got, ref)


def _results(cls, texts):
    return [cls(text=t, score=1.0 - 0.1 * i, start=float(i), end=i + 1.0,
                speaker="SPEAKER_00", chunk_id=f"c{i}", metadata={"i": i})
            for i, t in enumerate(texts)]


@pytest.mark.parametrize("top_k", [3, 8])
def test_rerank_matches_jax(rerankers, top_k):
    """Cross-encoder scores replace the retrieval scores; with top_k (8)
    candidates or fewer the results come back untouched."""
    jax_rr, port = rerankers
    ref = jax_rr.rerank(QUERY, _results(JaxResult, PASSAGES), top_k)
    cands = _results(RetrievalResult, PASSAGES)
    got = port.rerank(QUERY, cands, top_k)
    assert len(got) == len(ref) == min(top_k, len(PASSAGES))
    _assert_close_bf16([r.score for r in got], [r.score for r in ref])
    assert [r.metadata for r in got] == [{"i": int(r.chunk_id[1:])}
                                         for r in got]
    if top_k >= len(PASSAGES):
        assert got is cands
        return
    # the JAX order, but for near-ties: by every candidate's JAX score
    full = dict(zip((f"c{i}" for i in range(len(PASSAGES))),
                    jax_rr.score_pairs(QUERY, PASSAGES)))
    ranked = [full[r.chunk_id] for r in got]
    assert all(a >= b - _tol(a) for a, b in zip(ranked, ranked[1:]))
    kth = sorted(full.values())[-len(got)]
    assert min(ranked) >= kth - _tol(kth)


def test_fake_reranker_and_factory():
    cands = _results(RetrievalResult, PASSAGES)
    got = FakeReranker(RerankingConfig(backend="fake")).rerank(QUERY, cands,
                                                               2)
    assert [r.chunk_id for r in got] == ["c0", "c3"]  # c5, c7 tie c3
    assert [r.score for r in got] == [1.0, 2 / 3]
    assert create_reranker(RerankingConfig(backend="none"), "cpu") is None
    assert isinstance(create_reranker(RerankingConfig(backend="fake"),
                                      "cpu"), FakeReranker)
    assert isinstance(create_reranker(RerankingConfig(model="test"), "cpu"),
                      BGEReranker)
    with pytest.raises(ConfigError):
        RerankingConfig(backend="cohere")
    missing = BGEReranker(RerankingConfig(model="test",
                                          checkpoint_path="/nonexistent"),
                          "cpu")
    missing.load()  # no reranker.safetensors there: the seeded weights
    assert missing.is_loaded


def test_a_failing_reranker_raises(monkeypatch):
    """The JAX reranker keeps the retrieval order when scoring fails; the
    port's raises (a fault on the card must not pass unseen)."""
    port = BGEReranker(RerankingConfig(model="test"), device="cpu")

    def broken(ids):
        raise RuntimeError("scoring failed")

    monkeypatch.setattr(port, "forward_ids", broken)
    with pytest.raises(RuntimeError, match="scoring failed"):
        port.rerank(QUERY, _results(RetrievalResult, PASSAGES), 3)


def test_reranker_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for make in (lambda: BGEReranker(),
                 lambda: create_reranker(RerankingConfig())):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            make()
