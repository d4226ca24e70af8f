"""Data model of the PyTorch port: the subset of
``audio_rag_tpu/core/types.py`` that the ingest → query slice uses (Word,
TranscriptSegment, AudioChunk, SparseVector, EmbeddingResult,
RetrievalResult), with the same fields, so that results of the two packages
compare directly.

* Embeddings carry ``numpy.ndarray`` (host) arrays; device placement is
  owned by the embedder / vector store, never by the data model.
* ``SparseVector`` stores parallel int32/float32 arrays rather than a dict.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

__all__ = [
    "Word",
    "TranscriptSegment",
    "AudioChunk",
    "SparseVector",
    "EmbeddingResult",
    "RetrievalResult",
]


@dataclass
class Word:
    """A single recognized word with timing and optional speaker attribution."""

    text: str
    start: float
    end: float
    probability: float = 1.0
    speaker: str | None = None


@dataclass
class TranscriptSegment:
    """A contiguous span of transcript, optionally speaker-attributed."""

    text: str
    start: float
    end: float
    speaker: str | None = None
    words: list[Word] = field(default_factory=list)
    language: str | None = None
    avg_logprob: float | None = None

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class AudioChunk:
    """A retrieval unit: a chunk of transcript with provenance metadata."""

    text: str
    start: float
    end: float
    speaker: str | None = None
    chunk_id: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)


class SparseVector:
    """Sparse lexical embedding: parallel (indices, values) arrays in
    ascending token id, duplicates merged by their maximum weight (BGE-M3's
    per-token max-pool)."""

    __slots__ = ("indices", "values")

    def __init__(
        self,
        indices: Sequence[int] | np.ndarray = (),
        values: Sequence[float] | np.ndarray = (),
    ):
        idx = np.asarray(indices, dtype=np.int32).reshape(-1)
        val = np.asarray(values, dtype=np.float32).reshape(-1)
        if idx.shape != val.shape:
            raise ValueError(
                f"indices/values length mismatch: {idx.shape} vs {val.shape}"
            )
        if idx.size:
            order = np.argsort(idx, kind="stable")
            idx, val = idx[order], val[order]
            if np.any(idx[1:] == idx[:-1]):
                uniq, inv = np.unique(idx, return_inverse=True)
                merged = np.full(uniq.shape, -np.inf, dtype=np.float32)
                np.maximum.at(merged, inv, val)
                idx, val = uniq.astype(np.int32), merged
        self.indices = idx
        self.values = val

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def __bool__(self) -> bool:
        return self.nnz > 0

    def __repr__(self) -> str:
        return f"SparseVector(nnz={self.nnz})"


@dataclass
class EmbeddingResult:
    """Output of an embedder: dense vector and optional sparse lexical weights."""

    dense: np.ndarray | None = None
    sparse: SparseVector | None = None
    text: str | None = None

    @property
    def dim(self) -> int:
        return 0 if self.dense is None else int(self.dense.shape[-1])


@dataclass
class RetrievalResult:
    """One search hit: chunk payload plus relevance score."""

    text: str
    score: float
    start: float = 0.0
    end: float = 0.0
    speaker: str | None = None
    chunk_id: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)
