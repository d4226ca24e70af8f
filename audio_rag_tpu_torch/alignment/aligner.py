"""Word → speaker alignment and the speaker-attributed transcript.

Own copy of ``audio_rag_tpu/alignment/aligner.py``: each word takes the
speaker of the diarization segment it overlaps most (a (words × segments)
overlap matrix in one numpy broadcast), else the nearest segment within
``tolerance_s``; words left without a speaker inherit one forward, then
backward; the transcript is rebuilt into segments split at a speaker
change or a gap of more than 1 s between words.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audio_rag_tpu_torch.core.types import TranscriptSegment, Word

__all__ = ["AlignedWord", "align_words_to_speakers", "build_speaker_transcript"]

NEAREST_TOLERANCE_S = 0.5
SEGMENT_GAP_S = 1.0


@dataclass
class AlignedWord:
    word: Word
    speaker: str | None
    overlap: float


def align_words_to_speakers(
    words: list[Word],
    diarization: list[TranscriptSegment],
    tolerance_s: float = NEAREST_TOLERANCE_S,
) -> list[Word]:
    """Attribute each word to a speaker; returns new Word objects."""
    if not words:
        return []
    if not diarization:
        return [Word(w.text, w.start, w.end, w.probability, None) for w in words]

    ws = np.array([w.start for w in words])
    we = np.array([w.end for w in words])
    ss = np.array([s.start for s in diarization])
    se = np.array([s.end for s in diarization])
    speakers = [s.speaker for s in diarization]

    # (W, S) overlap matrix in one broadcast
    overlap = np.minimum(we[:, None], se[None, :]) - np.maximum(
        ws[:, None], ss[None, :]
    )
    best = np.argmax(overlap, axis=1)
    best_overlap = overlap[np.arange(len(words)), best]

    # nearest-segment fallback for non-overlapping words
    dist = np.maximum(ss[None, :] - we[:, None], ws[:, None] - se[None, :])
    dist = np.maximum(dist, 0.0)
    nearest = np.argmin(dist, axis=1)
    nearest_dist = dist[np.arange(len(words)), nearest]

    out: list[Word] = []
    for i, w in enumerate(words):
        if best_overlap[i] > 0:
            spk = speakers[best[i]]
        elif nearest_dist[i] <= tolerance_s:
            spk = speakers[nearest[i]]
        else:
            spk = None
        out.append(Word(w.text, w.start, w.end, w.probability, spk))

    _propagate_speakers(out)
    return out


def _propagate_speakers(words: list[Word]) -> None:
    """Fill None speakers from neighbours: forward pass then backward."""
    last = None
    for w in words:
        if w.speaker is not None:
            last = w.speaker
        elif last is not None:
            w.speaker = last
    nxt = None
    for w in reversed(words):
        if w.speaker is not None:
            nxt = w.speaker
        elif nxt is not None:
            w.speaker = nxt


def build_speaker_transcript(
    words: list[Word], gap_s: float = SEGMENT_GAP_S
) -> list[TranscriptSegment]:
    """Aligned words → segments split on speaker change or >``gap_s`` gap."""
    if not words:
        return []
    segments: list[TranscriptSegment] = []
    cur: list[Word] = [words[0]]
    for prev, w in zip(words, words[1:]):
        if w.speaker != prev.speaker or (w.start - prev.end) > gap_s:
            segments.append(_make_segment(cur))
            cur = [w]
        else:
            cur.append(w)
    segments.append(_make_segment(cur))
    return segments


def _make_segment(words: list[Word]) -> TranscriptSegment:
    return TranscriptSegment(
        text=" ".join(w.text for w in words),
        start=words[0].start,
        end=words[-1].end,
        speaker=words[0].speaker,
        words=list(words),
    )
