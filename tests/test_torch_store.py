"""The PyTorch port's vector store against the JAX package's
``TPUVectorStore``: metadata filters (a hashable value, an absent key, an
unhashable value through the host mask, several keys, and columns that
grow with later adds), score thresholds, the int8 dense corpus (scores bit
for bit) and persistence read and written by either package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import RetrievalConfig as JaxRetrievalConfig
from audio_rag_tpu.core import types as jtypes
from audio_rag_tpu.core.exceptions import RetrievalError as JaxRetrievalError
from audio_rag_tpu.ops import similarity as jsim
from audio_rag_tpu.retrieval.tpu_store import TPUVectorStore
from audio_rag_tpu_torch.config import RetrievalConfig
from audio_rag_tpu_torch.core import types as ttypes
from audio_rag_tpu_torch.core.exceptions import RetrievalError
from audio_rag_tpu_torch.ops import similarity as tsim
from audio_rag_tpu_torch.retrieval.store import VectorStore
from torch_llm_common import one_torch_thread  # noqa: F401

DIM = 16


def _inputs(types, lo, hi, seed=4):
    """Chunks ``lo``..``hi`` of a fixed corpus: random dense rows, sparse
    terms, and metadata with a string, an int and a list (unhashable)."""
    rng = np.random.default_rng(seed)
    chunks, embs = [], []
    for i in range(hi):
        k = int(rng.integers(0, 12))
        dense = rng.standard_normal(DIM).astype(np.float32)
        idx, val = rng.integers(0, 40, k), rng.uniform(0.05, 1.0, k)
        if i < lo:
            continue
        meta = {"lang": ("en", "de", "fr")[i % 3], "n": i % 4,
                "tags": ["a", "b"] if i % 5 else ["c"]}
        if i % 7 == 0:
            meta["extra"] = True
        chunks.append(types.AudioChunk(text=f"chunk {i}", start=float(i),
                                       end=i + 1.0, speaker=f"S{i % 2}",
                                       chunk_id=f"id{i}", metadata=meta))
        embs.append(types.EmbeddingResult(
            dense=dense, sparse=types.SparseVector(idx, val)))
    return chunks, embs


def _queries(n=3, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.standard_normal(DIM).astype(np.float32)
        out.append((dense, rng.integers(0, 40, 6), rng.uniform(0.1, 1.0, 6)))
    return out


def _search(store, types, q, **kw):
    dense, idx, val = q
    return store.search(types.EmbeddingResult(
        dense=dense, sparse=types.SparseVector(idx, val)), **kw)


def _stores(tmp=None, **cfg):
    jcfg = JaxRetrievalConfig(capacity_step=128, max_doc_nnz=8, **cfg)
    tcfg = RetrievalConfig(capacity_step=128, max_doc_nnz=8, **cfg)
    return TPUVectorStore(jcfg), VectorStore(tcfg, device="cpu")


def _assert_same(got, ref, exact=False):
    assert [r.chunk_id for r in got] == [r.chunk_id for r in ref]
    assert [r.metadata for r in got] == [r.metadata for r in ref]
    if exact:
        assert [r.score for r in got] == [r.score for r in ref]
    else:
        np.testing.assert_allclose([r.score for r in got],
                                   [r.score for r in ref], atol=1e-6)


FILTERS = {
    "hashable": {"lang": "en"},
    "absent_key": {"missing": 1},
    "absent_value": {"lang": "jp"},
    "unhashable": {"tags": ["a", "b"]},
    "several_keys": {"lang": "de", "n": 1},
    "bool_key": {"extra": True},
}


@pytest.mark.parametrize("search_type", ["dense", "hybrid"])
@pytest.mark.parametrize("name", list(FILTERS))
def test_filtered_search_matches_jax(name, search_type):
    """The same hits under each filter, before and after more chunks are
    added (the interned columns grow with the collection)."""
    flt = FILTERS[name]
    jstore, tstore = _stores()
    for lo, hi in ((0, 30), (30, 45)):
        jstore.add(*_inputs(jtypes, lo, hi), "c")
        tstore.add(*_inputs(ttypes, lo, hi), "c")
        for q in _queries():
            kw = dict(top_k=8, search_type=search_type, collection="c",
                      metadata_filter=flt)
            ref = _search(jstore, jtypes, q, **kw)
            got = _search(tstore, ttypes, q, **kw)
            _assert_same(got, ref)
            for r in got:
                assert all(r.metadata.get(k) == v for k, v in flt.items())
    coll = tstore._coll("c")
    if name == "unhashable":
        assert "tags" not in coll.index_cols  # the host mask took it
    elif name != "absent_key":
        assert set(flt) <= set(coll.index_cols)
        assert all(col.shape == (coll.capacity,)
                   for col in coll.index_cols.values())


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("threshold", [None, 0.0, 0.2, 0.35])
def test_score_threshold_matches_jax(search_type, threshold):
    jstore, tstore = _stores(score_threshold=0.1)
    jstore.add(*_inputs(jtypes, 0, 40))
    tstore.add(*_inputs(ttypes, 0, 40))
    for q in _queries():
        kw = dict(top_k=10, search_type=search_type,
                  score_threshold=threshold)
        ref = _search(jstore, jtypes, q, **kw)
        got = _search(tstore, ttypes, q, **kw)
        _assert_same(got, ref)


def test_quantized_query_is_bit_exact():
    """The query's int8 scale and values, and the scores over an int8
    corpus, are the JAX package's jitted program's bits."""
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((300, 64)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    scales = (np.maximum(np.abs(corpus).max(axis=1), 1e-9) / 127.0
              ).astype(np.float32)
    q8 = np.clip(np.round(corpus / scales[:, None]), -127, 127
                 ).astype(np.int8)
    queries = rng.standard_normal((256, 64)).astype(np.float32)
    queries[1] *= 1e-3  # a tiny query
    # rows whose scale max|q|/127 differs from max|q|·(1/127) in f32:
    # XLA compiles the division by a constant as the product
    q_max = np.abs(queries).max(axis=1)
    assert (q_max / np.float32(127) != q_max * (np.float32(1)
                                                / np.float32(127))).any()
    ref = np.asarray(jax.jit(jsim.dense_scores)(
        jnp.asarray(queries), jnp.asarray(q8), jnp.asarray(scales)))
    got = tsim.dense_scores(torch.from_numpy(queries), torch.from_numpy(q8),
                            torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_quantized_corpus_matches_jax(search_type):
    """``quantize_dense``: the same int8 rows and scales uploaded, and the
    same hits with the same scores, bit for bit where the dense product
    decides them (the sparse scores' f32 sums run in another order)."""
    jstore, tstore = _stores(quantize_dense=True)
    jstore.add(*_inputs(jtypes, 0, 45))
    tstore.add(*_inputs(ttypes, 0, 45))
    for q in _queries(4):
        kw = dict(top_k=8, search_type=search_type)
        _assert_same(_search(tstore, ttypes, q, **kw),
                     _search(jstore, jtypes, q, **kw),
                     exact=search_type != "sparse")
    jdev = jstore._coll(None).device_arrays()
    tdev = tstore._coll(None).upload(tstore.device)
    assert tdev["dense"].dtype == torch.int8
    np.testing.assert_array_equal(tdev["dense"].numpy(),
                                  np.asarray(jdev["dense"]))
    np.testing.assert_array_equal(tdev["scales"].numpy(),
                                  np.asarray(jdev["scales"]))


def _same_search(a, a_types, b, b_types, name):
    for search_type in ("dense", "sparse", "hybrid"):
        for q in _queries():
            kw = dict(top_k=6, search_type=search_type, collection=name)
            _assert_same(_search(a, a_types, q, **kw),
                         _search(b, b_types, q, **kw))


def test_persistence_both_ways(tmp_path):
    """A collection the JAX store persisted loads in the port with the
    same results, and one the port persisted loads in the JAX store."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore = TPUVectorStore(JaxRetrievalConfig(capacity_step=128,
                                               max_doc_nnz=8,
                                               persist_dir=jdir))
    jstore.add(*_inputs(jtypes, 0, 30), "talks")
    jstore.add(*_inputs(jtypes, 30, 40), "talks")
    loaded = VectorStore(RetrievalConfig(capacity_step=128, persist_dir=jdir),
                         device="cpu")
    assert loaded.list_collections() == ["talks"]
    assert loaded.count("talks") == 40
    _same_search(loaded, ttypes, jstore, jtypes, "talks")
    info = loaded.collection_info("talks")
    assert info == {**jstore.collection_info("talks"),
                    "hbm_bytes": info["hbm_bytes"]}

    tstore = VectorStore(RetrievalConfig(capacity_step=128, max_doc_nnz=8,
                                         persist_dir=tdir), device="cpu")
    tstore.add(*_inputs(ttypes, 0, 25), "notes")
    tstore.add(*_inputs(ttypes, 25, 35), "notes")
    back = TPUVectorStore(JaxRetrievalConfig(capacity_step=128,
                                             persist_dir=tdir))
    assert back.list_collections() == ["notes"] and back.count("notes") == 35
    _same_search(back, jtypes, tstore, ttypes, "notes")
    # the filter works on a loaded collection too
    q = _queries(1)[0]
    kw = dict(top_k=6, collection="notes", metadata_filter={"lang": "fr"})
    _assert_same(_search(VectorStore(RetrievalConfig(persist_dir=tdir),
                                     device="cpu"), ttypes, q, **kw),
                 _search(back, jtypes, q, **kw))

    assert tstore.delete_collection("notes")
    assert not (tmp_path / "port" / "notes.npz").exists()
    assert not (tmp_path / "port" / "notes.json").exists()
    assert not tstore.collection_exists("notes")
    with pytest.raises(JaxRetrievalError):
        back._coll("gone")
    with pytest.raises(RetrievalError):
        tstore.collection_info("notes")


def test_a_recreated_collection_has_a_new_uid():
    store = VectorStore(RetrievalConfig(capacity_step=128), device="cpu")
    store.add(*_inputs(ttypes, 0, 5))
    uid = store._coll(None).uid
    assert store.collection_exists()
    store.delete_collection()
    store.add(*_inputs(ttypes, 0, 5))
    assert store._coll(None).uid != uid
