"""Contextual chunk headers (counterpart of
``audio_rag_tpu/contextual/processor.py``): each chunk gets a
``[Context: ...]`` line ahead of its text before it is embedded, and keeps
its own text in ``metadata["original_text"]``.

Backend "llm": the generator writes one or two situating sentences per
chunk from :data:`CONTEXT_PROMPT` (the chunk, clipped head and tail to
4,000 characters, and its ±``window_size`` neighbours, 200 characters
each), at most 96 tokens at temperature 0.3, in ``generate_batch`` calls
of 16 prompts (one ``generate`` a prompt for a generator without it).
Backend "extractive": :func:`extractive_headers`, no model.

Departure from the JAX processor: a failing generator raises (the JAX one
turns every failure into a chunk without a header, and retries a batch
that ran out of device memory once after two seconds, which works around
its runtime's asynchronous frees); here nothing falls back, as on the
port's answer path.
"""

from __future__ import annotations

import math

from audio_rag_tpu_torch.config import ContextualConfig
from audio_rag_tpu_torch.core.types import AudioChunk
from audio_rag_tpu_torch.text.tokenizer import norm_tokens
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["CONTEXT_PROMPT", "ContextualProcessor", "extractive_headers"]

CONTEXT_PROMPT = (
    "You are indexing a transcript for search. Given a chunk and its "
    "surrounding context, write 1-2 sentences situating the chunk in the "
    "overall recording (topic, what is being discussed). Reply with the "
    "situating sentences only.\n\n"
    "Surrounding context:\n{context}\n\n"
    "Chunk ({speaker} at {start:.0f}s-{end:.0f}s):\n{chunk}\n\n"
    "Situating context:"
)

NEIGHBOR_TRUNCATE = 200  # characters quoted of each neighbour
CHUNK_TRUNCATE = 4000  # characters quoted of the chunk (head and tail)
HEADER_BATCH = 16  # prompts a generate_batch call


def extractive_headers(chunks: list[AudioChunk], window_size: int,
                       top_n: int = 4) -> list[str | None]:
    """Per chunk, ``"near: a, b, ..."`` of the ``top_n`` terms of its
    ±``window_size`` neighbours that it does not contain, by count times
    idf over these chunks (ties by term), or None. A term must occur at
    least twice in the window and, unless it is in one chunk only, in at
    most a quarter of the chunks."""
    texts = [norm_tokens(c.text) for c in chunks]
    n = len(texts)
    df: dict[str, int] = {}
    for words in texts:
        for w in set(words):
            df[w] = df.get(w, 0) + 1
    headers: list[str | None] = []
    for i in range(n):
        own = set(texts[i])
        tf: dict[str, int] = {}
        for j in range(max(0, i - window_size), min(n, i + window_size + 1)):
            if j == i:
                continue
            for w in texts[j]:
                if w not in own:
                    tf[w] = tf.get(w, 0) + 1
        scored = sorted(
            ((cnt * math.log((n + 1) / (1 + df[w])), w)
             for w, cnt in tf.items()
             if cnt >= 2 and (df[w] == 1 or 4 * df[w] <= n)),
            key=lambda sw: (-sw[0], sw[1]))
        terms = [w for s, w in scored[:top_n] if s > 0]
        headers.append("near: " + ", ".join(terms) if terms else None)
    return headers


def _clip_chunk_text(text: str) -> str:
    if len(text) <= CHUNK_TRUNCATE:
        return text
    head = (2 * CHUNK_TRUNCATE) // 3
    tail = CHUNK_TRUNCATE - head
    return f"{text[:head]}\n[... transcript elided ...]\n{text[-tail:]}"


class ContextualProcessor:
    def __init__(self, config: ContextualConfig | None = None,
                 generator=None):
        self.config = config or ContextualConfig()
        self.generator = generator

    def _build_prompt(self, chunk: AudioChunk,
                      neighbors: list[AudioChunk]) -> str:
        ctx = "\n".join(f"- {n.text[:NEIGHBOR_TRUNCATE]}"
                        for n in neighbors) or "(none)"
        return CONTEXT_PROMPT.format(
            context=ctx, speaker=chunk.speaker or "unknown",
            start=chunk.start, end=chunk.end,
            chunk=_clip_chunk_text(chunk.text))

    @timed
    def process_chunks(self, chunks: list[AudioChunk]) -> list[AudioChunk]:
        """``chunks`` with headers (unchanged when disabled, or with the
        llm backend and no generator)."""
        if not self.config.enabled:
            return chunks
        if self.config.backend == "extractive":
            return self._apply_headers(chunks, extractive_headers(
                chunks, self.config.window_size,
                self.config.extractive_terms))
        if self.generator is None:
            return chunks
        self.generator.load()
        w = self.config.window_size
        prompts = [self._build_prompt(c, [
            chunks[j] for j in range(max(0, i - w), min(len(chunks),
                                                          i + w + 1))
            if j != i]) for i, c in enumerate(chunks)]
        kw = {"max_tokens": 96, "temperature": 0.3}
        batch = getattr(self.generator, "generate_batch", None)
        if batch is None:
            headers = [self.generator.generate(p, **kw) for p in prompts]
        else:
            headers = [h for i in range(0, len(prompts), HEADER_BATCH)
                       for h in batch(prompts[i:i + HEADER_BATCH], **kw)]
        return self._apply_headers(chunks, headers)

    @staticmethod
    def _apply_headers(chunks: list[AudioChunk],
                       headers: list[str | None]) -> list[AudioChunk]:
        out: list[AudioChunk] = []
        for chunk, header in zip(chunks, headers):
            header = (header or "").strip() or None
            if header:
                out.append(AudioChunk(
                    text=f"[Context: {header}]\n{chunk.text}",
                    start=chunk.start, end=chunk.end, speaker=chunk.speaker,
                    chunk_id=chunk.chunk_id,
                    metadata={**chunk.metadata,
                              "original_text": chunk.text,
                              "contextualized": True}))
            else:
                out.append(chunk)
        return out
