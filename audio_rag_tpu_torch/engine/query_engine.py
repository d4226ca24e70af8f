"""Batched query engine: embed → hybrid search → top-``initial_k`` →
cross-encoder → top-``top_k`` over a batch of queries (counterpart of
``audio_rag_tpu/engine/query_engine.py::QueryEngine``).

Two paths, as in the JAX engine:

* **Rerank on the device** (a loaded cross-encoder): each collection keeps
  a device-resident cache of its chunks' reranker tokens (``passage
  </s>``, −1 padded to ``fused_doc_tokens``); after the top-K search the
  candidates' rows are gathered on the device behind each query's ``<s> q
  </s></s>`` prefix (−1 holes between the two: positions are the cumsum of
  the mask) and scored in chunks of at most 256 pairs; only the final
  top-k comes back to the host. The JAX engine compiles this as one
  program; here it is a sequence of ops on one device with the same
  shapes, buckets and masks, so the same results.
* **Two steps** (no reranker, or one that is not a loaded cross-encoder):
  embed + search to the host, then every (query, candidate) pair through
  ``score_pairs_multi`` in one batch.

The JAX engine falls back from the first path to the second on any error;
this one raises.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.models.bgem3 import bgem3_forward
from audio_rag_tpu_torch.ops.similarity import (
    NEG_INF,
    _topk,
    dense_scores,
    rrf_fuse,
    rrf_prefetch,
    sparse_scores,
    topk_with_mask,
)
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.text.tokenizer import pad_batch
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["QueryEngine"]

#: most rerank pairs through the cross-encoder at once: bounds the
#: (chunk, H, T, T) f32 attention logits
_PAIR_CHUNK = 256


def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < min(n, hi):
        b <<= 1
    return min(b, hi)


def _pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _padded(seqs: list[list[int]], T: int, rows: int) -> np.ndarray:
    ids, _ = pad_batch(seqs, T, -1)
    if ids.shape[0] < rows:
        ids = np.pad(ids, ((0, rows - ids.shape[0]), (0, 0)),
                     constant_values=-1)
    return ids


def _results(coll, scores: np.ndarray,
             idx: np.ndarray) -> list[list[RetrievalResult]]:
    out = []
    for srow, irow in zip(scores, idx):
        row = []
        for s, i in zip(srow, irow):
            if s <= -1e29:
                continue
            p = coll.payloads[int(i)]
            row.append(RetrievalResult(
                text=p["text"], score=float(s), start=p["start"],
                end=p["end"], speaker=p["speaker"], chunk_id=p["id"],
                metadata=p["metadata"]))
        out.append(row)
    return out


class QueryEngine:
    """Batched queries over a loaded ``BGEM3Embedder``, a ``VectorStore``
    collection and, optionally, a reranker."""

    def __init__(self, embedder, store, reranker=None,
                 collection: str | None = None):
        self.embedder = embedder
        self.store = store
        self.reranker = reranker
        self.collection = collection
        # collection name → (uid, count, host (capacity, Ld) int32 rows,
        # device copy, longest row)
        self._rr_cache: dict[str, tuple] = {}

    # -- device steps -------------------------------------------------------
    def _scores(self, ids: torch.Tensor, dev: dict, search_type: str,
                prefetch: int) -> torch.Tensor:
        """Embed the −1-padded query rows (dense + sparse) and score the
        corpus: (B, N). The sparse query is every real position's (token,
        weight), duplicates max-pooled inside ``sparse_scores``."""
        e = self.embedder
        e.load()  # again, after an eviction
        mask = ids >= 0
        tokens = torch.where(mask, ids, torch.full_like(ids, e.dims.pad_id))
        dense, w = bgem3_forward(e._params, e.dims, tokens, mask.long())
        q_w = torch.where(mask, w, torch.zeros_like(w))
        scales = dev.get("scales")
        if search_type == "dense":
            return dense_scores(dense, dev["dense"], scales)
        s = sparse_scores(ids, q_w, dev["doc_tokens"], dev["doc_weights"])
        if search_type == "sparse":
            return s
        d = dense_scores(dense, dev["dense"], scales)
        return rrf_fuse([d, s], dev["valid_mask"],
                        rrf_k=float(self.store.config.rrf_k),
                        prefetch=prefetch, min_scores=(None, 0.0))

    def _rerank_doc_cache(self, coll) -> tuple[torch.Tensor, int]:
        """The collection's (capacity, fused_doc_tokens) reranker rows on
        the device and the longest row's length. The store only appends, so
        the rows are extended by count; a recreated collection (another
        ``uid``) is rebuilt."""
        tok = self.reranker._tok
        Ld = self.reranker.config.fused_doc_tokens
        cached = self._rr_cache.get(coll.name)
        host, start, max_len = None, 0, 1
        if cached is not None and cached[0] == coll.uid:
            if cached[1] == coll.count and \
                    cached[2].shape[0] == coll.capacity:
                return cached[3], cached[4]
            if cached[1] <= coll.count:
                start, host, max_len = cached[1], cached[2], cached[4]
                if host.shape[0] != coll.capacity:  # the corpus grew
                    grown = np.full((coll.capacity, Ld), -1, np.int32)
                    grown[: host.shape[0]] = host
                    host = grown
        if host is None:
            host = np.full((coll.capacity, Ld), -1, np.int32)
        for i in range(start, coll.count):
            ids = tok.encode(coll.payloads[i]["text"],
                             add_special=False)[: Ld - 1]
            ids.append(tok.sep_id)
            host[i, : len(ids)] = ids
            max_len = max(max_len, len(ids))
        dev = torch.from_numpy(host).to(self.store.device)
        self._rr_cache[coll.name] = (coll.uid, coll.count, host, dev,
                                     max_len)
        return dev, max_len

    # -- public API -----------------------------------------------------------
    @torch.inference_mode()
    @timed
    def query_batch(self, queries: list[str], top_k: int = 5,
                    search_type: str = "hybrid", initial_k: int = 20,
                    rerank: bool = True) -> list[list[RetrievalResult]]:
        """Each query's results, best first."""
        coll = self.store._coll(self.collection)
        if coll is None or coll.count == 0:
            return [[] for _ in queries]
        get_resource_manager().touch("embeddings")
        dev = coll.upload(self.store.device)
        # the embedder's rows: at most 64 tokens a query
        seqs = [self.embedder._tok.encode(q)[:64] for q in queries]
        T = _bucket(max(len(s) for s in seqs), 16, 64)
        ids = torch.from_numpy(_padded(
            seqs, T, _bucket(len(seqs), 1, 256))).long().to(
                self.store.device)

        do_rerank = bool(rerank and self.reranker is not None)
        if do_rerank and hasattr(self.reranker, "forward_ids"):
            self.reranker.load()
            return self._query_device_rerank(queries, ids, coll, dev,
                                             search_type, top_k, initial_k)

        fetch_k = min(initial_k if do_rerank else top_k, coll.count)
        k_run = min(_pow2(fetch_k), coll.capacity)
        scores = self._scores(ids, dev, search_type, rrf_prefetch(fetch_k))
        ts, ti = topk_with_mask(scores, dev["valid_mask"][None, :], k_run)
        n = len(queries)
        candidates = _results(coll, ts[:n, :fetch_k].cpu().numpy(),
                              ti[:n, :fetch_k].cpu().numpy())
        if not do_rerank:
            return [row[:top_k] for row in candidates]

        # every (query, candidate) pair in one cross-encoder batch
        flat_queries: list[str] = []
        flat_texts: list[str] = []
        spans: list[tuple[int, int]] = []
        for q, row in zip(queries, candidates):
            start = len(flat_texts)
            flat_queries.extend([q] * len(row))
            flat_texts.extend(r.text for r in row)
            spans.append((start, len(flat_texts)))
        if not flat_texts:
            return candidates
        if not hasattr(self.reranker, "score_pairs_multi"):
            raise ConfigError(
                f"the query engine reranks with a cross-encoder; "
                f"{type(self.reranker).__name__} scores no (query, passage) "
                "pairs (use the 'bge-reranker' backend, or rerank=False)")
        pair_scores = self.reranker.score_pairs_multi(flat_queries,
                                                      flat_texts)
        out: list[list[RetrievalResult]] = []
        for (a, b), row in zip(spans, candidates):
            ss = pair_scores[a:b]
            order = np.argsort(-ss)[:top_k]
            out.append([RetrievalResult(
                text=row[i].text, score=float(ss[i]), start=row[i].start,
                end=row[i].end, speaker=row[i].speaker,
                chunk_id=row[i].chunk_id, metadata=row[i].metadata)
                for i in map(int, order)])
        return out

    def _query_device_rerank(self, queries: list[str], ids: torch.Tensor,
                             coll, dev: dict, search_type: str, top_k: int,
                             initial_k: int) -> list[list[RetrievalResult]]:
        """embed → search → top-K → the candidates' cached reranker rows
        behind each query's prefix → cross-encoder → top-k, on the
        device."""
        rr = self.reranker
        rr_docs, doc_max = self._rerank_doc_cache(coll)
        # passage width: the pow-2 bucket of the longest cached row
        Ld = _bucket(doc_max, 16, int(rr_docs.shape[1]))
        # query prefix rows: <s> q </s></s>, −1 padded
        pq_budget = max(rr.max_len - Ld, 16)
        rq_seqs = [rr._tok.encode(q)[: pq_budget - 1] + [rr._tok.sep_id]
                   for q in queries]
        Pq = _bucket(max(len(s) for s in rq_seqs), 16, pq_budget)
        B = ids.shape[0]
        rq = torch.from_numpy(_padded(rq_seqs, Pq, B)).long().to(
            ids.device)

        n_cand = min(initial_k, coll.count)
        # the candidate pool: exactly initial_k once the corpus holds that
        # many, else the pow-2 bucket of the count (masked to n_cand)
        K = (initial_k if coll.count >= initial_k
             else min(_pow2(n_cand), coll.capacity))
        k_out = min(_pow2(min(top_k, coll.count)), K)

        scores = self._scores(ids, dev, search_type, rrf_prefetch(n_cand))
        cs, ci = topk_with_mask(scores, dev["valid_mask"][None, :], K)
        docs = rr_docs[:, :Ld][ci].long()  # (B, K, Ld)
        pair = torch.cat([rq[:, None, :].expand(B, K, Pq), docs], dim=-1)
        pair = pair.reshape(B * K, Pq + Ld)
        n_pairs = B * K
        chunk = n_pairs
        while chunk > _PAIR_CHUNK or n_pairs % chunk:
            chunk -= 1
        logits = torch.cat([rr.forward_ids(pair[i: i + chunk])
                            for i in range(0, n_pairs, chunk)])
        logits = logits.reshape(B, K)
        in_pool = (torch.arange(K, device=ids.device)[None, :] < n_cand) & (
            cs > NEG_INF / 2)
        logits = torch.where(in_pool, logits,
                             torch.full_like(logits, NEG_INF))
        fs, fi = _topk(logits, k_out)
        orig = torch.take_along_dim(ci, fi, dim=1)
        n = len(queries)
        return _results(coll, fs[:n, :top_k].cpu().numpy(),
                        orig[:n, :top_k].cpu().numpy())
