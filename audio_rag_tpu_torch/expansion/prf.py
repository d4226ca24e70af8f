"""Pseudo-relevance-feedback query expansion (counterpart of
``audio_rag_tpu/expansion/prf.py``, RM3-style): run the query once
(hybrid, ``prf_depth`` results), keep the feedback chunks that contain a
corpus-rare query term (at least two such anchors, else no expansion),
score each term the query lacks by Σ rank weight · tf · log((N+1)/(1+df))
over the anchors, with document frequencies from the store's
:meth:`~audio_rag_tpu_torch.retrieval.store.VectorStore.term_stats`, and
append up to ``prf_terms`` terms that recur in two anchors, are rare in
the corpus and score within half of the best.

Like the JAX expander, a failing first pass leaves the query as it was
(the expansion is an optional rewrite, not the query itself).
"""

from __future__ import annotations

import logging
import math

from audio_rag_tpu_torch.config import ExpansionConfig
from audio_rag_tpu_torch.text.tokenizer import norm_tokens

log = logging.getLogger(__name__)

__all__ = ["PRFExpander"]


class PRFExpander:
    """The HyDE expander's ``expand``/``expand_single`` over the
    pipeline's embedder and store instead of a generator."""

    def __init__(self, config: ExpansionConfig | None, embedder, retriever,
                 collection: str | None = None):
        self.config = config or ExpansionConfig()
        self.embedder = embedder
        self.retriever = retriever
        self.collection = collection

    def is_available(self) -> bool:
        return self.embedder is not None and self.retriever is not None

    def expand(self, query: str) -> list[str]:
        return [self.expand_single(query)]

    def expand_single(self, query: str) -> str:
        if not self.is_available():
            return query
        try:
            emb = self.embedder.embed_query(query)
            fb = self.retriever.search(
                emb, top_k=self.config.prf_depth, search_type="hybrid",
                collection=self.collection)
        except Exception as exc:
            log.warning("PRF first pass failed: %s", exc)
            return query
        if not fb:
            return query
        terms = self._rm3_terms(query, fb)
        return f"{query} {' '.join(terms)}" if terms else query

    def _rm3_terms(self, query: str, feedback: list) -> list[str]:
        qwords = set(norm_tokens(query))
        n_docs, df = self.retriever.term_stats(self.collection)
        rare_q = {w for w in qwords if 0 < df.get(w, n_docs) * 8 <= n_docs}
        anchors = [r for r in feedback if rare_q & set(norm_tokens(r.text))]
        if len(anchors) < 2:
            return []
        scores: dict[str, float] = {}
        doc_freq: dict[str, int] = {}
        for rank, r in enumerate(anchors):
            w_rank = 1.0 / (1.0 + rank)
            tf: dict[str, int] = {}
            for w in norm_tokens(r.text):
                if w not in qwords:
                    tf[w] = tf.get(w, 0) + 1
            for w, cnt in tf.items():
                idf = math.log((n_docs + 1) / (1 + df.get(w, 0)))
                scores[w] = scores.get(w, 0.0) + w_rank * cnt * idf
                doc_freq[w] = doc_freq.get(w, 0) + 1
        ranked = sorted(
            ((s, w) for w, s in scores.items()
             if doc_freq[w] >= 2 and 8 * df.get(w, 0) <= n_docs),
            key=lambda sw: (-sw[0], sw[1]))
        if not ranked:
            return []
        floor = ranked[0][0] * 0.5
        return [w for s, w in ranked[: self.config.prf_terms]
                if s > 0 and s >= floor]
