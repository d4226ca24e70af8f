"""Word-level timestamps from decoder cross-attention (DTW), on the host.

Own copy of ``audio_rag_tpu/asr/word_timing.py`` in its numpy form: the
head-averaged cross-attention weights of one teacher-forced decoder pass
are normalized per audio frame, smoothed by a 7-wide median filter, and a
dynamic time warp through the (token × frame) cost matrix gives each token
its frames; a word spans the frames of its tokens. The DTW and the median
filter run in the native runtime (:mod:`audio_rag_tpu_torch.native`, the
JAX package's C code: under 2 ms a 30 s window against ~60 ms in numpy);
the numpy versions below give the same numbers where it is missing. Head selection is the
JAX package's: without published alignment heads, the mean over all heads
of the upper half of the decoder layers (``decoder_forward(...,
collect_cross_weights="alignment_mean")`` reduces them on the device).
"""

from __future__ import annotations

import numpy as np

from audio_rag_tpu_torch import native
from audio_rag_tpu_torch.core.types import TranscriptSegment, Word

__all__ = ["FRAME_SECONDS", "dtw_path", "attention_to_word_times",
           "assign_word_timestamps"]

FRAME_SECONDS = 0.02  # one encoder frame after the stride-2 conv = 20 ms


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic minimal-cost path through ``cost`` (N_tokens, N_frames):
    steps ↓, → and ↘, float64 sums, (token_idx, frame_idx) of the path.

    The recurrence runs over anti-diagonals (each diagonal's cells depend
    only on the two before it), N + M vector steps instead of N·M Python
    iterations. Ties: the diagonal beats a token advance beats a frame
    advance. The native library runs the same recurrence when it loads."""
    out = native.dtw_path(cost)
    if out is not None:
        return out
    return _dtw_path_np(cost)


def _dtw_path_np(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    N, M = cost.shape
    prev2 = np.full(N + 1, np.inf)  # diagonal k-2, indexed by token row
    prev = np.full(N + 1, np.inf)   # diagonal k-1
    prev2[0] = 0.0                  # D[0, 0]
    trace = np.zeros((N + 1, M + 1), np.int8)
    for k in range(2, N + M + 1):
        i = np.arange(max(1, k - M), min(N, k - 1) + 1)
        best = prev2[i - 1]          # D[i-1, j-1]
        t = np.zeros(i.shape, np.int8)
        up = prev[i - 1]             # D[i-1, j]: token advance
        m1 = up < best
        best = np.where(m1, up, best)
        t = np.where(m1, np.int8(1), t)
        left = prev[i]               # D[i, j-1]: frame advance
        m2 = left < best
        best = np.where(m2, left, best)
        t = np.where(m2, np.int8(2), t)
        cur = np.full(N + 1, np.inf)
        cur[i] = best + cost[i - 1, k - i - 1]
        trace[i, k - i] = t
        prev2, prev = prev, cur
    i, j = N, M
    ti, fi = [], []
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(ti[::-1]), np.array(fi[::-1])


def _median_filter(x: np.ndarray, width: int = 7) -> np.ndarray:
    """Median along the last axis over ``width`` samples, edges repeated
    (an odd window's median is one of its elements: no averaging)."""
    if width <= 1 or x.shape[-1] < width:
        return x
    out = native.median_filter(x, width) if x.ndim == 2 else None
    return out if out is not None else _median_filter_np(x, width)


def _median_filter_np(x: np.ndarray, width: int) -> np.ndarray:
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(win, axis=-1)


def attention_to_word_times(
    cross_weights: np.ndarray,
    token_word_index: list[int],
    n_frames_valid: int,
    time_offset: float = 0.0,
) -> list[tuple[float, float]]:
    """(start, end) seconds of each word id from the (T_tokens, T_frames)
    head-averaged weights, or from raw (L, H, T_tokens, T_frames) weights
    (then the upper half of the layers, all heads, are averaged here).
    ``token_word_index`` gives each token's word id (−1: no word)."""
    if cross_weights.ndim == 4:
        L = cross_weights.shape[0]
        w = cross_weights[L // 2:].mean(axis=(0, 1))
    else:
        w = cross_weights
    w = w[:, :n_frames_valid]
    std = w.std(axis=0, keepdims=True) + 1e-9
    mean = w.mean(axis=0, keepdims=True)
    w = _median_filter((w - mean) / std, 7)

    ti, fi = dtw_path(-w)  # most attention = least cost

    n_words = max(token_word_index) + 1 if token_word_index else 0
    starts = np.full(n_words, np.inf)
    ends = np.zeros(n_words)
    for tok, frame in zip(ti, fi):
        wid = token_word_index[tok] if tok < len(token_word_index) else -1
        if wid < 0:
            continue
        t = frame * FRAME_SECONDS
        starts[wid] = min(starts[wid], t)
        ends[wid] = max(ends[wid], t + FRAME_SECONDS)
    out = []
    prev_end = 0.0
    for k in range(n_words):
        s = starts[k] if np.isfinite(starts[k]) else prev_end
        e = max(ends[k], s + FRAME_SECONDS)
        s = max(s, prev_end)  # monotonic
        e = max(e, s + FRAME_SECONDS)
        prev_end = e
        out.append((round(s + time_offset, 3), round(e + time_offset, 3)))
    return out


def assign_word_timestamps(segment: TranscriptSegment,
                           cross_weights: np.ndarray,
                           token_word_index: list[int],
                           n_frames_valid: int) -> None:
    """Fill ``segment.words`` in place from attention alignment."""
    times = attention_to_word_times(cross_weights, token_word_index,
                                    n_frames_valid,
                                    time_offset=segment.start)
    segment.words = [Word(text=w, start=t[0], end=t[1],
                          speaker=segment.speaker)
                     for w, t in zip(segment.text.split(), times)]
