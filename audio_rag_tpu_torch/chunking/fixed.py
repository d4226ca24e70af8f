"""Fixed-size word-window chunker (copy of
``audio_rag_tpu/chunking/fixed.py``): windows of ``max_tokens`` words
stepping by ``max_tokens − overlap_tokens``, word times interpolated over
a segment that has none, the majority speaker of each window."""

from __future__ import annotations

import uuid
from collections import Counter

from audio_rag_tpu_torch.config import ChunkingConfig
from audio_rag_tpu_torch.core.types import AudioChunk, TranscriptSegment, Word

__all__ = ["FixedSizeChunker"]


class FixedSizeChunker:
    def __init__(self, config: ChunkingConfig | None = None):
        self.config = config or ChunkingConfig()

    def chunk(self, segments: list[TranscriptSegment]) -> list[AudioChunk]:
        words = self._collect_words(segments)
        if not words:
            return []
        size = self.config.max_tokens
        step = max(1, size - self.config.overlap_tokens)
        chunks: list[AudioChunk] = []
        for i in range(0, len(words), step):
            win = words[i: i + size]
            if not win:
                break
            chunks.append(AudioChunk(
                text=" ".join(w.text for w in win), start=win[0].start,
                end=win[-1].end, speaker=self._majority_speaker(win),
                chunk_id=str(uuid.uuid4())))
            if i + size >= len(words):
                break
        return chunks

    @staticmethod
    def _collect_words(segments: list[TranscriptSegment]) -> list[Word]:
        words: list[Word] = []
        for seg in segments:
            if seg.words:
                words.extend(seg.words)
                continue
            parts = seg.text.split()
            if not parts:
                continue
            step = seg.duration / len(parts)
            words.extend(
                Word(w, round(seg.start + k * step, 3),
                     round(seg.start + (k + 1) * step, 3),
                     speaker=seg.speaker)
                for k, w in enumerate(parts))
        return words

    @staticmethod
    def _majority_speaker(words: list[Word]) -> str | None:
        counts = Counter(w.speaker for w in words if w.speaker)
        if not counts:
            return None
        return counts.most_common(1)[0][0]
