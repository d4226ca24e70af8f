"""HyDE query expansion (counterpart of ``audio_rag_tpu/expansion/hyde.py``):
the generator writes a short passage that answers the query (temperature
0.7 + 0.1·i for hypothesis i, at most 256 tokens), and the passage is
embedded in the query's place. Without a loaded generator the query
stands. Unlike the JAX expander, a failing hypothesis raises: it is not
logged away."""

from __future__ import annotations

from audio_rag_tpu_torch.config import ExpansionConfig

__all__ = ["HyDEExpander", "HYDE_PROMPT"]

HYDE_PROMPT = (
    "Write a short passage (2-3 paragraphs) that directly answers the "
    "question below, as it might appear in a lecture transcript. Write the "
    "passage only, no preamble.\n\nQuestion: {query}\n\nPassage:"
)


class HyDEExpander:
    def __init__(self, config: ExpansionConfig | None = None,
                 generator=None):
        self.config = config or ExpansionConfig()
        self.generator = generator

    def is_available(self) -> bool:
        return (self.generator is not None
                and self.generator.check_availability())

    def expand(self, query: str) -> list[str]:
        """The non-empty hypothesis passages; [query] when there are none
        or no generator is loaded."""
        if not self.is_available():
            return [query]
        out = []
        for i in range(self.config.num_hypotheses):
            passage = self.generator.generate(
                HYDE_PROMPT.format(query=query), max_tokens=256,
                temperature=0.7 + 0.1 * i)
            if passage.strip():
                out.append(passage.strip())
        return out or [query]

    def expand_single(self, query: str) -> str:
        return self.expand(query)[0]
