"""Agglomerative (AHC) diarizer, the second diarization engine.

Counterpart of ``audio_rag_tpu/diarization/ahc.py``: the clustering
engine's VAD and device window embeddings, then average-linkage
clustering on cosine distance on the host, merging while the closest
pair is nearer than ``ahc_threshold`` (``num_speakers`` and the min/max
override), and an overlap-aware pass: a window whose similarity to its
second-closest centroid is within ``overlap_margin`` of its best is
emitted for both speakers.
"""

from __future__ import annotations

import time

import numpy as np

from audio_rag_tpu_torch.core.types import TranscriptSegment
from audio_rag_tpu_torch.diarization.clustering import (
    ClusteringDiarizer,
    windows_to_segments,
)
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["AHCDiarizer", "ahc_cluster"]


def ahc_cluster(emb: np.ndarray, threshold: float = 0.35,
                num_speakers: int | None = None,
                min_speakers: int | None = None,
                max_speakers: int | None = None) -> np.ndarray:
    """Average-linkage clustering of L2-normalized (N, D) embeddings on
    cosine distance → labels (N,), numbered by each cluster's first
    window."""
    n = emb.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    target = num_speakers
    lo = max(min_speakers or 1, 1)
    hi = min(max_speakers or n, n)
    dist = 1.0 - emb @ emb.T
    clusters: list[list[int]] = [[i] for i in range(n)]

    while len(clusters) > 1:
        if target is not None and len(clusters) <= target:
            break
        if len(clusters) <= lo:
            break
        best = (None, None, np.inf)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = float(dist[np.ix_(clusters[i], clusters[j])].mean())
                if d < best[2]:
                    best = (i, j, d)
        i, j, d = best
        must_merge = ((target is not None and len(clusters) > target)
                      or len(clusters) > hi)
        if not must_merge and d > threshold:
            break
        clusters[i] = clusters[i] + clusters[j]
        del clusters[j]

    labels = np.zeros(n, np.int64)
    clusters.sort(key=min)
    for lab, members in enumerate(clusters):
        labels[members] = lab
    return labels


class AHCDiarizer(ClusteringDiarizer):
    """The AHC engine: :class:`ClusteringDiarizer`'s loading, VAD and
    embeddings with its own clustering and overlap pass."""

    @timed
    def diarize(self, audio: np.ndarray | str,
                sample_rate: int | None = None,
                num_speakers: int | None = None) -> list[TranscriptSegment]:
        got = self._spans_and_embeddings(audio, sample_rate)
        if got is None:
            return []
        spans, starts, emb = got
        t0 = time.perf_counter()
        cfg = self.config
        labels = ahc_cluster(emb, threshold=cfg.ahc_threshold,
                             num_speakers=num_speakers,
                             min_speakers=cfg.min_speakers,
                             max_speakers=cfg.max_speakers)
        total_end = max(e for _, e in spans)
        segs = windows_to_segments(starts, labels, cfg.window_s,
                                   cfg.shift_s, total_end)
        k = int(labels.max()) + 1
        if k >= 2 and cfg.overlap_margin > 0:
            centroids = np.stack([emb[labels == c].mean(axis=0)
                                  for c in range(k)])
            centroids /= np.maximum(
                np.linalg.norm(centroids, axis=1, keepdims=True), 1e-9)
            sims = emb @ centroids.T  # (N, k)
            order = np.argsort(-sims, axis=1)
            rows = np.arange(len(starts))
            best = sims[rows, order[:, 0]]
            second = sims[rows, order[:, 1]]
            for i, t in enumerate(starts):
                if best[i] - second[i] < cfg.overlap_margin:
                    segs.append(TranscriptSegment(
                        text="", start=round(t, 3),
                        end=round(min(t + cfg.window_s, total_end), 3),
                        speaker=f"SPEAKER_{int(order[i, 1]):02d}"))
            segs.sort(key=lambda s: (s.start, s.speaker))
        self.timings["cluster_s"] = time.perf_counter() - t0
        return segs
