"""In-memory vector store on the device (counterpart of
``audio_rag_tpu/retrieval/tpu_store.py``).

A collection keeps host mirrors (f32 dense rows L2-normalized at add time,
fixed-width sparse (token, weight) rows padded with −1/0, payloads) and
uploads them to the device once per mutation; a search is one call of
:func:`audio_rag_tpu_torch.ops.similarity.hybrid_search` over the
device-resident arrays. Capacity grows in ``capacity_step`` rows. Payload
filters and npz persistence of the JAX store are not ported yet.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.config import RetrievalConfig
from audio_rag_tpu_torch.core.exceptions import RetrievalError
from audio_rag_tpu_torch.core.types import (
    AudioChunk,
    EmbeddingResult,
    RetrievalResult,
    SparseVector,
)
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.ops.similarity import hybrid_search, rrf_prefetch

__all__ = ["VectorStore", "Collection"]


@dataclass
class Collection:
    name: str
    dim: int
    max_doc_nnz: int
    capacity: int = 0
    count: int = 0
    dense: np.ndarray | None = None  # (capacity, dim) f32
    doc_tokens: np.ndarray | None = None  # (capacity, max_doc_nnz) i32, -1 pad
    doc_weights: np.ndarray | None = None  # (capacity, max_doc_nnz) f32
    payloads: list[dict[str, Any]] = field(default_factory=list)
    #: device copies; dropped whenever the host mirrors change
    device_arrays: dict[str, torch.Tensor] = field(default_factory=dict)

    def ensure_capacity(self, n_new: int, step: int) -> None:
        needed = self.count + n_new
        cap = max(step, -(-needed // step) * step)
        if self.dense is not None and cap <= self.capacity:
            return
        grow = cap - self.capacity
        pads = (np.zeros((grow, self.dim), np.float32),
                np.full((grow, self.max_doc_nnz), -1, np.int32),
                np.zeros((grow, self.max_doc_nnz), np.float32))
        if self.dense is None:
            self.dense, self.doc_tokens, self.doc_weights = pads
        else:
            self.dense = np.concatenate([self.dense, pads[0]])
            self.doc_tokens = np.concatenate([self.doc_tokens, pads[1]])
            self.doc_weights = np.concatenate([self.doc_weights, pads[2]])
        self.capacity = cap

    def upload(self, device: torch.device) -> dict[str, torch.Tensor]:
        if not self.device_arrays:
            mask = np.zeros(self.capacity, bool)
            mask[: self.count] = True
            self.device_arrays = {
                "dense": torch.from_numpy(self.dense).to(device),
                "doc_tokens": torch.from_numpy(self.doc_tokens).to(device),
                "doc_weights": torch.from_numpy(self.doc_weights).to(device),
                "valid_mask": torch.from_numpy(mask).to(device),
            }
        return self.device_arrays


def _pad_sparse(sv: SparseVector | None,
                width: int) -> tuple[np.ndarray, np.ndarray]:
    tok = np.full(width, -1, np.int32)
    w = np.zeros(width, np.float32)
    if sv is not None and sv.nnz:
        n = min(sv.nnz, width)
        if sv.nnz > width:  # keep the strongest terms
            keep = np.argsort(-sv.values)[:width]
            keep.sort()
            tok[:n] = sv.indices[keep]
            w[:n] = sv.values[keep]
        else:
            tok[:n] = sv.indices
            w[:n] = sv.values
    return tok, w


class VectorStore:
    """Hybrid (dense + sparse, RRF) vector store on one device."""

    def __init__(self, config: RetrievalConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or RetrievalConfig()
        self.device = resolve_device(device)
        self._collections: dict[str, Collection] = {}

    def _coll(self, name: str | None) -> Collection | None:
        return self._collections.get(name or self.config.collection_name)

    def add(self, chunks: list[AudioChunk], embeddings: list[EmbeddingResult],
            collection: str | None = None) -> int:
        if len(chunks) != len(embeddings):
            raise RetrievalError(f"chunks/embeddings mismatch: {len(chunks)} "
                                 f"vs {len(embeddings)}")
        if not chunks:
            return 0
        dim = embeddings[0].dim
        if dim == 0:
            raise RetrievalError("embeddings must include dense vectors")
        cname = collection or self.config.collection_name
        coll = self._collections.setdefault(
            cname, Collection(cname, dim, self.config.max_doc_nnz))
        if coll.dim != dim:
            raise RetrievalError(f"dim mismatch: collection {coll.dim}, "
                                 f"got {dim}", context={"collection": cname})
        coll.ensure_capacity(len(chunks), self.config.capacity_step)
        for chunk, emb in zip(chunks, embeddings):
            i = coll.count
            vec = np.asarray(emb.dense, np.float32)
            norm = float(np.linalg.norm(vec))
            coll.dense[i] = vec / norm if norm > 0 else vec
            coll.doc_tokens[i], coll.doc_weights[i] = _pad_sparse(
                emb.sparse, coll.max_doc_nnz)
            coll.payloads.append({
                "id": chunk.chunk_id or str(uuid.uuid4()),
                "text": chunk.text, "start": chunk.start, "end": chunk.end,
                "speaker": chunk.speaker, "metadata": dict(chunk.metadata),
            })
            coll.count += 1
        coll.device_arrays = {}
        return len(chunks)

    def search(self, query_embedding: EmbeddingResult, top_k: int = 5,
               search_type: str = "hybrid",
               collection: str | None = None) -> list[RetrievalResult]:
        coll = self._coll(collection)
        if coll is None or coll.count == 0:
            return []
        if search_type not in ("dense", "sparse", "hybrid"):
            raise RetrievalError(f"unknown search_type {search_type!r}")
        dev = coll.upload(self.device)
        qd = np.zeros((1, coll.dim), np.float32)
        if query_embedding.dense is not None:
            v = np.asarray(query_embedding.dense, np.float32)
            n = float(np.linalg.norm(v))
            qd[0] = v / n if n > 0 else v
        # the query's sparse terms pad to the pow-2 bucket of their nnz
        q_nnz = query_embedding.sparse.nnz if query_embedding.sparse else 0
        q_width = min(max(8, 1 << max(q_nnz - 1, 0).bit_length()),
                      self.config.max_query_nnz)
        qt, qw = _pad_sparse(query_embedding.sparse, q_width)
        k = min(top_k, coll.count)
        k_pad = 1 << (max(k, 1) - 1).bit_length()
        scores, idx = hybrid_search(
            torch.from_numpy(qd).to(self.device),
            torch.from_numpy(qt[None]).to(self.device),
            torch.from_numpy(qw[None]).to(self.device),
            dev["dense"], dev["doc_tokens"], dev["doc_weights"],
            dev["valid_mask"], top_k=min(k_pad, coll.capacity),
            search_type=search_type, rrf_k=float(self.config.rrf_k),
            prefetch=rrf_prefetch(k))
        scores = scores[0, :k].cpu().numpy()
        idx = idx[0, :k].cpu().numpy()
        thr = self.config.score_threshold if search_type == "dense" else 0.0
        out: list[RetrievalResult] = []
        for s, i in zip(scores, idx):
            if s <= -1e29 or (thr and s < thr):
                continue
            p = coll.payloads[int(i)]
            out.append(RetrievalResult(
                text=p["text"], score=float(s), start=p["start"],
                end=p["end"], speaker=p["speaker"], chunk_id=p["id"],
                metadata=p["metadata"]))
        return out

    def count(self, collection: str | None = None) -> int:
        coll = self._coll(collection)
        return 0 if coll is None else coll.count

    def delete_collection(self, collection: str | None = None) -> bool:
        cname = collection or self.config.collection_name
        return self._collections.pop(cname, None) is not None
