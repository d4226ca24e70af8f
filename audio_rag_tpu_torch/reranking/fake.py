"""Deterministic fake reranker (copy of
``audio_rag_tpu/reranking/fake.py``): scores by the share of the query's
words that a result holds. It scores no pairs (it has no
``score_pairs_multi``), so the query engine cannot use it."""

from __future__ import annotations

from audio_rag_tpu_torch.config import RerankingConfig
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.text.tokenizer import HashWordTokenizer

__all__ = ["FakeReranker"]


class FakeReranker:
    is_loaded = True
    hbm_required_gb = 0.0

    def __init__(self, config: RerankingConfig | None = None):
        self.config = config or RerankingConfig()
        self._tok = HashWordTokenizer()

    def load(self) -> None:
        pass

    def rerank(self, query: str, results: list[RetrievalResult],
               top_k: int | None = None) -> list[RetrievalResult]:
        k = top_k or self.config.top_k
        if len(results) <= k:
            return results
        q = set(self._tok.tokenize_words(query))
        scored = []
        for r in results:
            d = set(self._tok.tokenize_words(r.text))
            scored.append(RetrievalResult(
                text=r.text, score=len(q & d) / max(len(q), 1),
                start=r.start, end=r.end, speaker=r.speaker,
                chunk_id=r.chunk_id, metadata=r.metadata))
        scored.sort(key=lambda r: -r.score)
        return scored[:k]
