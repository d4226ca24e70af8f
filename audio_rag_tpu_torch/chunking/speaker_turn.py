"""Speaker-turn chunker (copy of ``audio_rag_tpu/chunking/speaker_turn.py``):
group consecutive same-speaker segments → split groups above
``max_tokens`` → merge adjacent groups below ``min_chunk_tokens`` →
optionally prefix each chunk with a ``[...tail of previous chunk]`` overlap.
Host-side and stateless.
"""

from __future__ import annotations

import uuid

from audio_rag_tpu_torch.chunking.base import estimate_tokens
from audio_rag_tpu_torch.config import ChunkingConfig
from audio_rag_tpu_torch.core.types import AudioChunk, TranscriptSegment

__all__ = ["SpeakerTurnChunker"]


class SpeakerTurnChunker:
    def __init__(self, config: ChunkingConfig | None = None):
        self.config = config or ChunkingConfig()

    def chunk(self, segments: list[TranscriptSegment]) -> list[AudioChunk]:
        segments = [s for s in segments if s.text.strip()]
        if not segments:
            return []
        groups = self._group_by_speaker(segments)
        groups = self._split_large(groups)
        groups = self._merge_small(groups)
        chunks = [
            AudioChunk(
                text=" ".join(s.text.strip() for s in grp),
                start=grp[0].start,
                end=grp[-1].end,
                speaker=grp[0].speaker,
                chunk_id=str(uuid.uuid4()),
            )
            for grp in groups
        ]
        if self.config.overlap_tokens > 0:
            self._add_overlap_context(chunks)
        return chunks

    def _group_by_speaker(
        self, segments: list[TranscriptSegment]
    ) -> list[list[TranscriptSegment]]:
        groups: list[list[TranscriptSegment]] = [[segments[0]]]
        for seg in segments[1:]:
            if seg.speaker == groups[-1][-1].speaker:
                groups[-1].append(seg)
            else:
                groups.append([seg])
        return groups

    def _split_large(
        self, groups: list[list[TranscriptSegment]]
    ) -> list[list[TranscriptSegment]]:
        out: list[list[TranscriptSegment]] = []
        for grp in groups:
            cur: list[TranscriptSegment] = []
            cur_tokens = 0
            for seg in grp:
                t = estimate_tokens(seg.text)
                if cur and cur_tokens + t > self.config.max_tokens:
                    out.append(cur)
                    cur, cur_tokens = [], 0
                cur.append(seg)
                cur_tokens += t
            if cur:
                out.append(cur)
        return out

    def _merge_small(
        self, groups: list[list[TranscriptSegment]]
    ) -> list[list[TranscriptSegment]]:
        if not groups:
            return groups
        out: list[list[TranscriptSegment]] = [groups[0]]
        for grp in groups[1:]:
            prev_tokens = sum(estimate_tokens(s.text) for s in out[-1])
            grp_tokens = sum(estimate_tokens(s.text) for s in grp)
            if (
                prev_tokens < self.config.min_chunk_tokens
                or grp_tokens < self.config.min_chunk_tokens
            ) and prev_tokens + grp_tokens <= self.config.max_tokens:
                out[-1].extend(grp)
            else:
                out.append(grp)
        return out

    def _add_overlap_context(self, chunks: list[AudioChunk]) -> None:
        """Prefix chunk i with the tail words of chunk i-1."""
        approx_words = self.config.overlap_tokens  # ~1 token ≈ 1 short word
        for i in range(len(chunks) - 1, 0, -1):
            tail_words = chunks[i - 1].text.split()[-approx_words:]
            if tail_words:
                chunks[i].text = (
                    f"[...{' '.join(tail_words)}] " + chunks[i].text
                )
                chunks[i].metadata["has_context_prefix"] = True
