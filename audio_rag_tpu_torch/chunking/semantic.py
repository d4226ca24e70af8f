"""Semantic chunker (copy of ``audio_rag_tpu/chunking/semantic.py``): a
chunk boundary opens where a segment's embedding falls below ``threshold``
cosine similarity to the running chunk's centroid (once the chunk holds
``min_chunk_tokens``), or where ``max_tokens`` would be passed.

Built without an embedder, as the pipeline builds it in both packages, it
embeds with :class:`~audio_rag_tpu_torch.embeddings.fake.FakeEmbedder`
(ROADMAP.md §3: a behaviour of the JAX package that the port copies).
"""

from __future__ import annotations

import uuid

import numpy as np

from audio_rag_tpu_torch.chunking.base import estimate_tokens
from audio_rag_tpu_torch.config import ChunkingConfig
from audio_rag_tpu_torch.core.types import AudioChunk, TranscriptSegment

__all__ = ["SemanticChunker"]


class SemanticChunker:
    def __init__(self, config: ChunkingConfig | None = None, embedder=None,
                 threshold: float = 0.55):
        self.config = config or ChunkingConfig()
        self.embedder = embedder
        self.threshold = threshold

    def _embedder(self):
        if self.embedder is None:
            from audio_rag_tpu_torch.embeddings.fake import FakeEmbedder

            self.embedder = FakeEmbedder()
        if not self.embedder.is_loaded:
            self.embedder.load()
        return self.embedder

    def chunk(self, segments: list[TranscriptSegment]) -> list[AudioChunk]:
        segments = [s for s in segments if s.text.strip()]
        if not segments:
            return []
        vecs = np.stack([
            r.dense / max(np.linalg.norm(r.dense), 1e-9)
            for r in self._embedder().embed([s.text for s in segments])])
        groups: list[list[int]] = [[0]]
        centroid = vecs[0].copy()
        tokens = estimate_tokens(segments[0].text)
        for i in range(1, len(segments)):
            t = estimate_tokens(segments[i].text)
            c = centroid / max(np.linalg.norm(centroid), 1e-9)
            sim = float(vecs[i] @ c)
            if tokens + t > self.config.max_tokens or (
                    sim < self.threshold
                    and tokens >= self.config.min_chunk_tokens):
                groups.append([i])
                centroid = vecs[i].copy()
                tokens = t
            else:
                groups[-1].append(i)
                centroid += vecs[i]
                tokens += t
        return [
            AudioChunk(
                text=" ".join(segments[i].text.strip() for i in grp),
                start=segments[grp[0]].start, end=segments[grp[-1]].end,
                speaker=segments[grp[0]].speaker, chunk_id=str(uuid.uuid4()))
            for grp in groups]
