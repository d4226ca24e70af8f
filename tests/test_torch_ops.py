"""The PyTorch port's host and device ops against the JAX package's on the
CPU: log-mel, retrieval scoring and the vector store, and the port's own
copies of the chunker, tokenizer, charvoice and WAV I/O."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.audio import charvoice as jvoice
from audio_rag_tpu.audio import io as jio
from audio_rag_tpu.chunking.speaker_turn import SpeakerTurnChunker as JaxChunker
from audio_rag_tpu.config.schema import ChunkingConfig as JaxChunkingConfig
from audio_rag_tpu.config.schema import RetrievalConfig as JaxRetrievalConfig
from audio_rag_tpu.core import types as jtypes
from audio_rag_tpu.ops import mel as jmel
from audio_rag_tpu.ops import similarity as jsim
from audio_rag_tpu.retrieval.tpu_store import TPUVectorStore
from audio_rag_tpu.text.tokenizer import HashWordTokenizer as JaxTokenizer
from audio_rag_tpu.text.tokenizer import pad_batch as jax_pad_batch
from audio_rag_tpu_torch.audio import charvoice as tvoice
from audio_rag_tpu_torch.audio import io as tio
from audio_rag_tpu_torch.chunking.speaker_turn import SpeakerTurnChunker
from audio_rag_tpu_torch.config import ChunkingConfig, RetrievalConfig
from audio_rag_tpu_torch.core import types as ttypes
from audio_rag_tpu_torch.ops import mel as tmel
from audio_rag_tpu_torch.ops import similarity as tsim
from audio_rag_tpu_torch.retrieval.store import VectorStore
from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer, pad_batch
from torch_llm_common import one_torch_thread  # noqa: F401


# -- log-mel ---------------------------------------------------------------------

@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_batch_matches_jax(n_mels):
    rng = np.random.default_rng(0)
    win = (rng.standard_normal((3, 96_000)) * 0.1).astype(np.float32)
    win[1] = 0.0  # a silent window clamps to its own max − 8
    ref = np.asarray(jmel.log_mel_batch(jnp.asarray(win), n_mels=n_mels))
    got = tmel.log_mel_batch(torch.from_numpy(win), n_mels=n_mels)
    assert got.shape == ref.shape == (3, n_mels, 600)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    one = tmel.log_mel_spectrogram(torch.from_numpy(win[2]), n_mels=n_mels)
    np.testing.assert_allclose(one.numpy(), ref[2], atol=1e-4)


def test_mel_tables_and_padding_match_jax():
    np.testing.assert_array_equal(tmel.mel_filterbank(128),
                                  jmel.mel_filterbank(128))
    x = np.arange(10, dtype=np.float32)
    for n in (4, 10, 16):
        np.testing.assert_array_equal(tmel.pad_or_trim(x, n),
                                      jmel.pad_or_trim(x, n))


# -- retrieval scoring -------------------------------------------------------------

def _corpus(rng, N=40, dim=16, nnz=8, vocab=30):
    dense = rng.standard_normal((N, dim)).astype(np.float32)
    dense /= np.linalg.norm(dense, axis=1, keepdims=True)
    toks = rng.integers(0, vocab, (N, nnz)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (N, nnz)).astype(np.float32)
    toks[:, -2:] = -1  # padding slots
    w[:, -2:] = 0.0
    toks[N // 2:, :] = -1  # half the docs share no term with anything
    w[N // 2:, :] = 0.0
    return dense, toks, w


def _queries(rng, B=3, dim=16, q=6, vocab=30):
    qd = rng.standard_normal((B, dim)).astype(np.float32)
    qt = rng.integers(0, vocab, (B, q)).astype(np.int32)
    qt[:, 1] = qt[:, 0]  # a duplicate token max-pools
    qt[:, -1] = -1
    qw = rng.uniform(0.1, 1.0, (B, q)).astype(np.float32)
    qw[:, -1] = 0.0
    return qd, qt, qw


def test_dense_and_sparse_scores_match_jax():
    rng = np.random.default_rng(1)
    dense, toks, w = _corpus(rng)
    qd, qt, qw = _queries(rng)
    np.testing.assert_allclose(
        tsim.dense_scores(torch.from_numpy(qd), torch.from_numpy(dense)),
        np.asarray(jsim.dense_scores(jnp.asarray(qd), jnp.asarray(dense))),
        atol=1e-6)
    np.testing.assert_allclose(
        tsim.sparse_scores(*map(torch.from_numpy, (qt, qw, toks, w))),
        np.asarray(jsim.sparse_scores(*map(jnp.asarray, (qt, qw, toks, w)))),
        atol=1e-6)


def test_rrf_and_topk_match_jax_ties_included():
    rng = np.random.default_rng(2)
    N = 40
    a = rng.integers(0, 5, (2, N)).astype(np.float32)  # many ties
    b = rng.integers(-2, 3, (2, N)).astype(np.float32)
    valid = np.arange(N) < 33
    ref = np.asarray(jsim.rrf_fuse([jnp.asarray(a), jnp.asarray(b)],
                                   jnp.asarray(valid), rrf_k=2.0, prefetch=8,
                                   min_scores=(None, 0.0)))
    got = tsim.rrf_fuse([torch.from_numpy(a), torch.from_numpy(b)],
                        torch.from_numpy(valid), rrf_k=2.0, prefetch=8,
                        min_scores=(None, 0.0))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-7)
    rv, ri = jsim.topk_with_mask(jnp.asarray(a), jnp.asarray(valid), 10)
    tv, ti = tsim.topk_with_mask(torch.from_numpy(a), torch.from_numpy(valid),
                                 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_hybrid_search_matches_jax(search_type):
    rng = np.random.default_rng(3)
    dense, toks, w = _corpus(rng)
    qd, qt, qw = _queries(rng, B=1)
    valid = np.arange(dense.shape[0]) < 37
    packed = np.asarray(jsim.hybrid_search(
        *map(jnp.asarray, (qd, qt, qw, dense, toks, w, valid)),
        top_k=8, search_type=search_type, rrf_k=2.0, prefetch=8))
    scores, idx = tsim.hybrid_search(
        *map(torch.from_numpy, (qd, qt, qw, dense, toks, w, valid)),
        top_k=8, search_type=search_type, rrf_k=2.0, prefetch=8)
    np.testing.assert_array_equal(idx.numpy(), packed[1].astype(np.int64))
    np.testing.assert_allclose(scores.numpy(), packed[0], atol=1e-6)


# -- vector store ----------------------------------------------------------------

def _store_inputs(types, rng, n=30, dim=16):
    chunks, embs = [], []
    for i in range(n):
        k = int(rng.integers(0, 12))
        chunks.append(types.AudioChunk(text=f"chunk {i}", start=float(i),
                                       end=i + 1.0, speaker=f"S{i % 2}",
                                       chunk_id=f"id{i}"))
        embs.append(types.EmbeddingResult(
            dense=rng.standard_normal(dim).astype(np.float32),
            sparse=types.SparseVector(rng.integers(0, 40, k),
                                      rng.uniform(0.05, 1.0, k))))
    return chunks, embs


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
def test_store_search_matches_jax(search_type):
    jstore = TPUVectorStore(JaxRetrievalConfig(capacity_step=128,
                                               max_doc_nnz=8))
    tstore = VectorStore(RetrievalConfig(capacity_step=128, max_doc_nnz=8),
                         device="cpu")
    jstore.add(*_store_inputs(jtypes, np.random.default_rng(4)), "c")
    tstore.add(*_store_inputs(ttypes, np.random.default_rng(4)), "c")
    assert tstore.count("c") == jstore.count("c") == 30
    qrng = np.random.default_rng(5)
    for _ in range(3):
        dense = qrng.standard_normal(16).astype(np.float32)
        idx, val = qrng.integers(0, 40, 6), qrng.uniform(0.1, 1.0, 6)
        ref = jstore.search(jtypes.EmbeddingResult(
            dense=dense, sparse=jtypes.SparseVector(idx, val)), top_k=5,
            search_type=search_type, collection="c")
        got = tstore.search(ttypes.EmbeddingResult(
            dense=dense, sparse=ttypes.SparseVector(idx, val)), top_k=5,
            search_type=search_type, collection="c")
        assert [r.chunk_id for r in got] == [r.chunk_id for r in ref]
        np.testing.assert_allclose([r.score for r in got],
                                   [r.score for r in ref], atol=1e-6)
    assert tstore.delete_collection("c") and tstore.count("c") == 0
    assert tstore.search(ttypes.EmbeddingResult(dense=dense), 5,
                         collection="c") == []


# -- host-side copies ---------------------------------------------------------------

def _segments(types):
    words = ("one two three four five six seven eight nine ten "
             "eleven twelve").split()
    segs, t = [], 0.0
    for i, spk in enumerate(["A", "A", "B", "A", "A", "A", "B", "B"]):
        text = " ".join(words[: 3 + (i * 5) % 9])
        segs.append(types.TranscriptSegment(text=text, start=t, end=t + 2.0,
                                            speaker=spk))
        t += 2.0
    return segs


@pytest.mark.parametrize("max_tokens,min_chunk,overlap",
                         [(50, 1, 0), (50, 30, 5), (8, 1, 3)])
def test_chunker_matches_jax(max_tokens, min_chunk, overlap):
    jcfg = JaxChunkingConfig(min_chunk_tokens=min_chunk,
                             overlap_tokens=overlap)
    jcfg.max_tokens = max_tokens  # below the JAX schema's floor of 50
    ref = JaxChunker(jcfg).chunk(_segments(jtypes))
    got = SpeakerTurnChunker(ChunkingConfig(
        max_tokens=max_tokens, min_chunk_tokens=min_chunk,
        overlap_tokens=overlap)).chunk(_segments(ttypes))
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        assert (g.text, g.start, g.end, g.speaker, g.metadata) == (
            r.text, r.start, r.end, r.speaker, r.metadata)


def test_tokenizer_matches_jax():
    text = "Gradient descent's loss: 42 tokens, and the token's weight!"
    tok, jtok = HashWordTokenizer(4096), JaxTokenizer(4096)
    assert tok.encode(text) == jtok.encode(text)
    assert tok.decode(tok.encode(text)) == jtok.decode(jtok.encode(text))
    seqs = [tok.encode(text), tok.encode("a b"), []]
    for got, ref in zip(pad_batch(seqs, 6, -1), jax_pad_batch(seqs, 6, -1)):
        np.testing.assert_array_equal(got, ref)


def test_charvoice_and_wav_io_match_jax(tmp_path):
    text = "the model learns 42 words, fast!"
    got = tvoice.synth_text(text, np.random.default_rng(7), noise_level=0.005)
    ref = jvoice.synth_text(text, np.random.default_rng(7), noise_level=0.005)
    np.testing.assert_array_equal(got, ref)
    assert tio.wav_bytes(got) == jio.wav_bytes(ref)
    path = tmp_path / "a.wav"
    tio.write_wav(path, got, tvoice.SR)
    wav, sr = tio.decode_audio(path)
    jwav, jsr = jio.decode_audio(path)
    assert sr == jsr == 16_000
    np.testing.assert_array_equal(wav, jwav)
    arr, _ = tio.decode_audio(got, sample_rate=16_000)
    np.testing.assert_array_equal(arr, got)
