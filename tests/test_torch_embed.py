"""The PyTorch port's BGE-M3 embedder against the JAX package's, on the
committed trained eval-small weights (``retr_embedder_small.npz``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import EmbeddingConfig as JaxEmbeddingConfig
from audio_rag_tpu.embeddings.bge import BGEM3Embedder as JaxEmbedder
from audio_rag_tpu.models import bert as jbert
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.config import EmbeddingConfig
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.models import bert as tbert
from audio_rag_tpu_torch.weights import bgem3_params

TEXTS = [
    "gradient descent minimizes the loss function",
    "the spectrogram shows harmonic structure",
    "attention layers mix token information and the token mixes again",
    "gradient descent loss",
    # longer than the small model's 128 positions: the position table's
    # last row repeats in both packages
    " ".join(f"tok{i}" for i in range(150)),
]

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "retr_embedder_small.npz").exists(),
    reason="trained embedder asset not built")


@pytest.fixture(scope="module")
def embedded():
    jax_emb = JaxEmbedder(JaxEmbeddingConfig(model="eval-small"))
    jax_emb.load()
    try:
        ref = jax_emb.embed(TEXTS)
    finally:
        jax_emb.unload()
    port = BGEM3Embedder(EmbeddingConfig(model="eval-small"), device="cpu")
    return ref, port.embed(TEXTS), port.embed_query(TEXTS[3])


def test_dense_vectors_match_jax(embedded):
    ref, got, _ = embedded
    for r, g in zip(ref, got):
        assert g.dense.shape == r.dense.shape == (128,)
        cos = float(np.dot(r.dense, g.dense)
                    / (np.linalg.norm(r.dense) * np.linalg.norm(g.dense)))
        assert cos >= 0.9999, (g.text, cos)


def test_sparse_token_sets_match_jax(embedded):
    ref, got, query = embedded
    for r, g in zip(ref, got):
        assert g.sparse.nnz > 0
        assert set(g.sparse.indices.tolist()) == set(r.sparse.indices.tolist())
    assert set(query.sparse.indices.tolist()) == set(
        got[3].sparse.indices.tolist())


def test_bert_encoder_matches_jax_at_f32():
    tree = load_npz_asset(ASSETS_DIR / "retr_embedder_small.npz")
    dims = jbert.BERT_PRESETS["retrieval-small"]
    rng = np.random.default_rng(0)
    tokens = rng.integers(4, dims.vocab, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    tokens[mask == 0] = dims.pad_id
    ref = jbert.bert_encode(jax.tree.map(jnp.asarray, tree["bert"]), dims,
                            jnp.asarray(tokens), jnp.asarray(mask),
                            jnp.float32)
    params = bgem3_params(tree, tbert.BERT_PRESETS["retrieval-small"], "cpu")
    got = tbert.bert_encode(params["bert"], tbert.BERT_PRESETS[
        "retrieval-small"], torch.from_numpy(tokens).long(),
        torch.from_numpy(mask), torch.float32)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(ref)[real],
                               atol=1e-5)
