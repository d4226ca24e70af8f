"""Deterministic lexical fake embedder (copy of
``audio_rag_tpu/embeddings/fake.py``).

Dense: the L2-normalized sum of per-word unit vectors, each drawn from
``numpy.random.default_rng(blake2s(word))`` (dim 256), so equal words embed
alike in both packages, bit for bit; sparse: word counts under the hash
tokenizer's ids. No model and no device: the vectors are numpy, as every
embedder's results are; the store uploads them.
"""

from __future__ import annotations

import hashlib

import numpy as np

from audio_rag_tpu_torch.config import EmbeddingConfig
from audio_rag_tpu_torch.core.types import EmbeddingResult, SparseVector
from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer

__all__ = ["FakeEmbedder"]


class FakeEmbedder:
    is_loaded = True
    hbm_required_gb = 0.0

    def __init__(self, config: EmbeddingConfig | None = None,
                 dim: int = 256):
        self.config = config or EmbeddingConfig()
        self.dim = dim
        self._tok = HashWordTokenizer()
        self._word_vecs: dict[str, np.ndarray] = {}

    def load(self) -> None:
        pass

    def _vec(self, word: str) -> np.ndarray:
        v = self._word_vecs.get(word)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2s(word.encode(), digest_size=4).digest(),
                "little")
            v = np.random.default_rng(seed).standard_normal(self.dim)
            v = (v / np.linalg.norm(v)).astype(np.float32)
            self._word_vecs[word] = v
        return v

    def embed(self, texts: list[str]) -> list[EmbeddingResult]:
        out = []
        for text in texts:
            words = self._tok.tokenize_words(text)
            if words:
                dense = np.sum([self._vec(w) for w in words], axis=0)
                n = np.linalg.norm(dense)
                dense = (dense / n if n > 0 else dense).astype(np.float32)
            else:
                dense = np.zeros(self.dim, np.float32)
            sparse = None
            if self.config.use_sparse:
                counts: dict[int, float] = {}
                for w in words:
                    wid = self._tok._word_id(w)
                    counts[wid] = counts.get(wid, 0.0) + 1.0
                sparse = SparseVector.from_dict(counts)
            out.append(EmbeddingResult(dense=dense, sparse=sparse, text=text))
        return out

    def embed_query(self, query: str) -> EmbeddingResult:
        return self.embed([query])[0]
