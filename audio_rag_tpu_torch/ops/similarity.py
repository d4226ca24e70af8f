"""Device-side retrieval scoring: dense inner products, sparse lexical match,
reciprocal rank fusion, top-k (counterpart of ``audio_rag_tpu/ops/similarity.py``).

Top-k is a stable descending sort, so equal scores rank by ascending row
index like ``jax.lax.top_k``; the two packages then order ties alike.

An int8 dense corpus (per-row scales) scores against a query quantized the
same way, the product taken on the integer values: they are held in f32,
where a sum of at most 1,024 products of |q|, |d| ≤ 127 stays below 2^24
and is exact, so the scores are the JAX package's int32 product's.
"""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.device import full_f32_matmul
from audio_rag_tpu_torch.models.layers import _INV127

__all__ = [
    "NEG_INF",
    "quantize_query",
    "dense_scores",
    "sparse_scores",
    "topk_with_mask",
    "rrf_fuse",
    "rrf_prefetch",
    "hybrid_search",
]

NEG_INF = -1e30


def rrf_prefetch(k: int) -> int:
    """Pow-2 bucket of the ``Prefetch(limit=2·k)`` fusion depth."""
    return 1 << (max(2 * k, 1) - 1).bit_length()


def quantize_query(queries: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Symmetric per-row int8 of (B, dim) f32 queries: (values in
    [-127, 127] held in f32, scales (B, 1)). The scale is max|q| times the
    f32 reciprocal of 127, as XLA compiles the JAX package's jitted
    ``max(q_max, 1e-9) / 127.0``; rounding is half to even."""
    q_max = torch.amax(torch.abs(queries), dim=-1, keepdim=True)
    q_scale = torch.clamp(q_max, min=1e-9) * _INV127
    return torch.clamp(torch.round(queries / q_scale), -127, 127), q_scale


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor,
                 corpus_scales: torch.Tensor | None = None) -> torch.Tensor:
    """(B, dim) · (N, dim)ᵀ → (B, N) f32 inner products; an int8 corpus
    takes its per-row ``corpus_scales`` (N,) and a quantized query."""
    if corpus.dtype == torch.int8:
        q_q, q_scale = quantize_query(queries.float())
        with full_f32_matmul():
            acc = torch.matmul(q_q, corpus.float().t())
        return acc * q_scale * corpus_scales[None, :]
    with full_f32_matmul():
        return torch.matmul(queries.float(), corpus.float().t())


def sparse_scores(q_tokens: torch.Tensor, q_weights: torch.Tensor,
                  doc_tokens: torch.Tensor,
                  doc_weights: torch.Tensor) -> torch.Tensor:
    """Lexical match Σ_t q_w[t]·d_w[t] → (B, N). Duplicate query tokens
    max-pool first; query slots are then matched one at a time against
    every doc row (no (B, N, Dnnz, Qnnz) intermediate), in the JAX scan's
    order."""
    Q = q_tokens.shape[1]
    same = q_tokens[:, :, None] == q_tokens[:, None, :]  # (B, Q, Q)
    group_max = torch.amax(
        torch.where(same, q_weights[:, None, :],
                    torch.full_like(same, NEG_INF, dtype=torch.float32)),
        dim=-1)
    pos = torch.arange(Q, device=q_tokens.device)
    first = torch.amin(torch.where(same, pos[None, None, :],
                                   torch.full_like(pos, Q)[None, None, :]),
                       dim=-1)
    q_w = torch.where((first == pos[None, :]) & (q_tokens >= 0), group_max,
                      torch.zeros_like(group_max))
    B, N = q_tokens.shape[0], doc_tokens.shape[0]
    acc = torch.zeros((B, N), dtype=torch.float32, device=doc_tokens.device)
    for j in range(Q):
        tok = q_tokens[:, j][:, None, None]  # (B, 1, 1)
        match = (doc_tokens[None] == tok) & (tok >= 0)
        hit = torch.where(match, doc_weights[None],
                          torch.zeros((), device=doc_weights.device))
        acc = acc + q_w[:, j][:, None] * hit.sum(dim=-1)
    return acc


def _topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_with_mask(scores: torch.Tensor, valid_mask: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with invalid entries pushed to NEG_INF."""
    return _topk(torch.where(valid_mask, scores,
                             torch.full_like(scores, NEG_INF)), k)


def rrf_fuse(score_lists: list[torch.Tensor], valid_mask: torch.Tensor,
             rrf_k: float = 2.0, prefetch: int = 64,
             min_scores: tuple[float | None, ...] | None = None
             ) -> torch.Tensor:
    """Reciprocal Rank Fusion Σ_lists 1/(rrf_k + rank) over each list's top
    ``prefetch`` members; a doc at or below a list's ``min_scores`` floor
    is not in that list (sparse: no term overlap ⇒ absent)."""
    B, N = score_lists[0].shape
    prefetch = min(prefetch if prefetch > 0 else 64, N)
    dev = score_lists[0].device
    fused = torch.zeros((B, N), dtype=torch.float32, device=dev)
    rank_contrib = 1.0 / (rrf_k + torch.arange(prefetch, dtype=torch.float32,
                                               device=dev))
    for li, scores in enumerate(score_lists):
        floor = min_scores[li] if min_scores is not None else None
        member = valid_mask[None, :].expand(B, N)
        if floor is not None:
            member = member & (scores > floor)
        masked = torch.where(member, scores, torch.full_like(scores, NEG_INF))
        top_s, top_i = _topk(masked, prefetch)
        contrib = torch.where(top_s > NEG_INF / 2, rank_contrib[None, :],
                              torch.zeros_like(top_s))
        fused = fused.scatter_add(1, top_i, contrib)
    return fused


@torch.inference_mode()
def hybrid_search(q_dense: torch.Tensor, q_tokens: torch.Tensor,
                  q_weights: torch.Tensor, corpus_dense: torch.Tensor,
                  doc_tokens: torch.Tensor, doc_weights: torch.Tensor,
                  valid_mask: torch.Tensor,
                  corpus_scales: torch.Tensor | None = None, top_k: int = 5,
                  search_type: str = "hybrid", rrf_k: float = 2.0,
                  prefetch: int = 0,
                  filter_cols: tuple[torch.Tensor, ...] = (),
                  filter_codes: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(filter) → score → (fuse) → top-k. Returns (scores (B, k), indices
    (B, k)); invalid slots score NEG_INF. ``filter_cols`` are (N,) int32
    columns of interned payload codes and ``filter_codes`` (F,) the wanted
    codes: a row is kept where every column equals its code."""
    if filter_cols:
        stacked = torch.stack(filter_cols)  # (F, N)
        valid_mask = valid_mask & torch.all(
            stacked == filter_codes[:, None], dim=0)
    if search_type == "dense":
        scores = dense_scores(q_dense, corpus_dense, corpus_scales)
    elif search_type == "sparse":
        scores = sparse_scores(q_tokens, q_weights, doc_tokens, doc_weights)
    elif search_type == "hybrid":
        d = dense_scores(q_dense, corpus_dense, corpus_scales)
        s = sparse_scores(q_tokens, q_weights, doc_tokens, doc_weights)
        scores = rrf_fuse([d, s], valid_mask, rrf_k=rrf_k,
                          prefetch=prefetch if prefetch > 0 else 2 * top_k,
                          min_scores=(None, 0.0))
    else:
        raise ValueError(f"unknown search_type {search_type!r}")
    return topk_with_mask(scores, valid_mask[None, :], top_k)
