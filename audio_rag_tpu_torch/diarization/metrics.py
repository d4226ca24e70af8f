"""Diarization error rate (DER).

Own copy of ``audio_rag_tpu/diarization/metrics.py``: NIST-style DER over
10 ms frames — miss + false alarm + speaker confusion over the reference
speech time, after the one-to-one speaker mapping of most overlap, with a
forgiveness collar around the reference boundaries; overlapped speech on
either side counts per frame. The mapping is solved here by a Hungarian
assignment in numpy (the JAX package calls scipy's): every optimal mapping
has the same total overlap, and the DER depends on that total only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audio_rag_tpu_torch.core.types import TranscriptSegment

__all__ = ["DERResult", "diarization_error_rate", "max_overlap_assignment"]

_FRAME = 0.01  # 10 ms discretization


@dataclass
class DERResult:
    der: float
    miss: float
    false_alarm: float
    confusion: float
    total_speech: float

    def to_dict(self) -> dict:
        return {"der": self.der, "miss": self.miss,
                "false_alarm": self.false_alarm,
                "confusion": self.confusion,
                "total_speech": self.total_speech}


def max_overlap_assignment(overlap: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) of a one-to-one matching of most total ``overlap``
    (n_ref, n_hyp), min(n_ref, n_hyp) pairs: the Hungarian method with
    potentials on the negated matrix, O(n³)."""
    transpose = overlap.shape[0] > overlap.shape[1]
    cost = -(overlap.T if transpose else overlap).astype(np.float64)
    n, m = cost.shape  # n ≤ m
    u, v = np.zeros(n + 1), np.zeros(m + 1)
    match = np.zeros(m + 1, np.int64)  # column → row (1-based; 0 = free)
    for i in range(1, n + 1):
        match[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        way = np.zeros(m + 1, np.int64)
        while True:
            used[j0] = True
            i0 = match[j0]
            free = ~used[1:]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            cand = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(cand)) + 1
            delta = cand[j1 - 1]
            u[match[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    cols = np.nonzero(match[1:])[0]
    rows = match[1:][cols] - 1
    order = np.argsort(rows)
    rows, cols = rows[order], cols[order]
    return (cols, rows) if transpose else (rows, cols)


def _frame_sets(segments: list[TranscriptSegment], n_frames: int,
                speakers: list[str]) -> np.ndarray:
    """(n_frames, n_speakers) bool activity."""
    idx = {s: i for i, s in enumerate(speakers)}
    act = np.zeros((n_frames, len(speakers)), bool)
    for seg in segments:
        a = max(int(round(seg.start / _FRAME)), 0)
        b = min(int(round(seg.end / _FRAME)), n_frames)
        if seg.speaker in idx and b > a:
            act[a:b, idx[seg.speaker]] = True
    return act


def diarization_error_rate(reference: list[TranscriptSegment],
                           hypothesis: list[TranscriptSegment],
                           collar: float = 0.25) -> DERResult:
    """DER = (miss + false alarm + confusion) / reference speech time;
    ``collar`` seconds around every reference boundary are not scored."""
    end = max([s.end for s in reference] + [s.end for s in hypothesis]
              + [0.0])
    n = int(np.ceil(end / _FRAME)) + 1
    ref_spk = sorted({s.speaker for s in reference if s.speaker})
    hyp_spk = sorted({s.speaker for s in hypothesis if s.speaker})
    ref = _frame_sets(reference, n, ref_spk)
    hyp = _frame_sets(hypothesis, n, hyp_spk)

    scored = np.ones(n, bool)
    if collar > 0:
        c = int(round(collar / _FRAME))
        for seg in reference:
            for edge in (seg.start, seg.end):
                a = max(int(round(edge / _FRAME)) - c, 0)
                scored[a: int(round(edge / _FRAME)) + c] = False
    ref = ref[scored]
    hyp = hyp[scored]

    if ref_spk and hyp_spk:
        overlap = ref.astype(np.int64).T @ hyp.astype(np.int64)
        ri, hi = max_overlap_assignment(overlap)
        mapping = dict(zip(hi.tolist(), ri.tolist()))
    else:
        mapping = {}
    hyp_mapped = np.zeros_like(ref)
    for h_idx in range(len(hyp_spk)):
        if h_idx in mapping:
            hyp_mapped[:, mapping[h_idx]] |= hyp[:, h_idx]

    n_ref = ref.sum(axis=1).astype(np.int64)
    n_hyp = hyp.sum(axis=1).astype(np.int64)
    n_correct = (ref & hyp_mapped).sum(axis=1).astype(np.int64)
    miss = np.maximum(n_ref - n_hyp, 0).sum()
    fa = np.maximum(n_hyp - n_ref, 0).sum()
    confusion = (np.minimum(n_ref, n_hyp) - n_correct).clip(min=0).sum()
    total = n_ref.sum()
    der = float((miss + fa + confusion) / total) if total else 0.0
    return DERResult(der=round(der, 4),
                     miss=round(float(miss) * _FRAME, 3),
                     false_alarm=round(float(fa) * _FRAME, 3),
                     confusion=round(float(confusion) * _FRAME, 3),
                     total_speech=round(float(total) * _FRAME, 3))
