"""Device-side retrieval scoring: dense inner products, sparse lexical match,
reciprocal rank fusion, top-k (counterpart of ``audio_rag_tpu/ops/similarity.py``).

Top-k is a stable descending sort, so equal scores rank by ascending row
index like ``jax.lax.top_k``; the two packages then order ties alike.
"""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.device import full_f32_matmul

__all__ = [
    "NEG_INF",
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


def dense_scores(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(B, dim) · (N, dim)ᵀ → (B, N) f32 inner products."""
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
                  valid_mask: torch.Tensor, top_k: int = 5,
                  search_type: str = "hybrid", rrf_k: float = 2.0,
                  prefetch: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """score → (fuse) → top-k. Returns (scores (B, k), indices (B, k));
    invalid slots score NEG_INF."""
    if search_type == "dense":
        scores = dense_scores(q_dense, corpus_dense)
    elif search_type == "sparse":
        scores = sparse_scores(q_tokens, q_weights, doc_tokens, doc_weights)
    elif search_type == "hybrid":
        d = dense_scores(q_dense, corpus_dense)
        s = sparse_scores(q_tokens, q_weights, doc_tokens, doc_weights)
        scores = rrf_fuse([d, s], valid_mask, rrf_k=rrf_k,
                          prefetch=prefetch if prefetch > 0 else 2 * top_k,
                          min_scores=(None, 0.0))
    else:
        raise ValueError(f"unknown search_type {search_type!r}")
    return topk_with_mask(scores, valid_mask[None, :], top_k)
