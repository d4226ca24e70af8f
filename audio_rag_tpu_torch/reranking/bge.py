"""BGE cross-encoder reranker of the port (counterpart of
``audio_rag_tpu/reranking/bge.py::BGEReranker``).

The top ``initial_k`` candidates are scored as (query, passage) pairs and
the best ``top_k`` kept, with the cross-encoder's logits in place of the
retrieval scores; with ``top_k`` or fewer candidates the results come
back as they are. The same hash tokenizer and pair layout, the same
batch and length buckets (−1 padding doubles as the mask), bf16 storage
and compute. "eval-small" loads the committed trained asset
(``retr_reranker_small.npz``); other models start from seeded weights at
their preset. Unlike the JAX reranker, a failure to score raises: it does
not fall back to the retrieval order.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.config import RerankingConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.models.bert import BERT_PRESETS, BertDims
from audio_rag_tpu_torch.models.cross_encoder import (
    cross_encoder_forward,
    init_cross_encoder,
)
from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer, pad_batch
from audio_rag_tpu_torch.weights import cross_encoder_params

__all__ = ["BGEReranker"]


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < min(n, hi):
        b <<= 1
    return min(b, hi)


def _pad_rows(ids: np.ndarray, rows: int) -> np.ndarray:
    if ids.shape[0] < rows:
        ids = np.pad(ids, ((0, rows - ids.shape[0]), (0, 0)),
                     constant_values=-1)
    return ids


class BGEReranker:
    def __init__(self, config: RerankingConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or RerankingConfig()
        self.device = resolve_device(device)
        preset = {"test": "test", "eval-small": "retrieval-small"}.get(
            self.config.model, "xlmr-base")
        self.dims: BertDims = BERT_PRESETS[preset]
        self._params = None
        self._tok = HashWordTokenizer(self.dims.vocab)
        #: compute dtype: bf16, as the JAX reranker; f32 (the stored bf16
        #: weights widen exactly) lets a check see past bf16 rounding
        self.dtype = torch.bfloat16

    @property
    def is_loaded(self) -> bool:
        return self._params is not None

    def load(self) -> None:
        if self.is_loaded:
            return
        if self.config.checkpoint_path:
            raise ConfigError(
                "reranker checkpoints (restore_params) are not ported; "
                "leave checkpoint_path unset",
                context={"checkpoint_path": self.config.checkpoint_path})
        tree = None
        if self.config.model == "eval-small":
            tree = load_npz_asset(ASSETS_DIR / "retr_reranker_small.npz")
        if tree is not None:
            self._params = cross_encoder_params(tree, self.dims, self.device,
                                                dtype=torch.bfloat16)
        else:
            self._params = init_cross_encoder(
                self.dims, seed=self.config.seed, device=self.device,
                dtype=torch.bfloat16)

    @property
    def max_len(self) -> int:
        """Longest pair row: the config's cap within the position table."""
        return min(self.config.max_length, self.dims.max_len)

    @torch.inference_mode()
    def forward_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) pair rows, −1 at padding (holes inside a row included),
        on the device → (B,) f32 logits on the device."""
        mask = (ids >= 0).long()
        tokens = torch.where(mask.bool(), ids,
                             torch.full_like(ids, self.dims.pad_id))
        return cross_encoder_forward(self._params, self.dims, tokens, mask,
                                     self.dtype)

    def _score(self, seqs: list[list[int]], rows: int) -> np.ndarray:
        if not self.is_loaded:
            self.load()
        T = _bucket(max(len(s) for s in seqs), 16, self.max_len)
        ids = _pad_rows(pad_batch(seqs, T, -1)[0], rows)
        scores = self.forward_ids(torch.from_numpy(ids).long().to(
            self.device))
        return scores.cpu().numpy()[: len(seqs)]

    def score_pairs(self, query: str, texts: list[str]) -> np.ndarray:
        """Cross-encoder scores of (query, text) pairs, one batch."""
        seqs = [self._tok.encode_pair(query, t, self.max_len) for t in texts]
        return self._score(seqs, _bucket(
            len(seqs), 1, max(self.config.initial_k, len(seqs))))

    def score_pairs_multi(self, queries: list[str],
                          texts: list[str]) -> np.ndarray:
        """Scores of (query_i, text_i) pairs, one batch: pow-2 batch
        buckets up to 256 pairs, multiples of 512 above."""
        seqs = [self._tok.encode_pair(q, t, self.max_len)
                for q, t in zip(queries, texts)]
        n = len(seqs)
        return self._score(seqs, _bucket(n, 1, 256) if n <= 256
                           else -(-n // 512) * 512)

    def rerank(self, query: str, results: list[RetrievalResult],
               top_k: int | None = None) -> list[RetrievalResult]:
        k = top_k or self.config.top_k
        if len(results) <= k:
            return results
        scores = self.score_pairs(query, [r.text for r in results])
        order = np.argsort(-scores)[:k]
        return [RetrievalResult(
            text=results[i].text, score=float(scores[i]),
            start=results[i].start, end=results[i].end,
            speaker=results[i].speaker, chunk_id=results[i].chunk_id,
            metadata=results[i].metadata) for i in map(int, order)]
