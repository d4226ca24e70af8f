"""RAG prompt construction (copy of ``audio_rag_tpu/generation/prompts.py``):
the system prompt and an excerpt-cited user prompt, ``[Excerpt i]
(speaker, MM:SS-MM:SS)`` per retrieved chunk."""

from __future__ import annotations

from audio_rag_tpu_torch.core.types import RetrievalResult

__all__ = ["SYSTEM_PROMPT", "build_rag_prompt", "format_timestamp"]

SYSTEM_PROMPT = (
    "You are a helpful assistant answering questions about recorded audio "
    "content (lectures, meetings, conversations). Ground every claim in the "
    "provided excerpts and cite them as [Excerpt N]. If the excerpts do not "
    "contain the answer, say so plainly instead of guessing."
)


def format_timestamp(seconds: float) -> str:
    """``MM:SS``."""
    m, s = divmod(int(max(seconds, 0)), 60)
    return f"{m:02d}:{s:02d}"


def build_rag_prompt(query: str, results: list[RetrievalResult]) -> str:
    lines = ["Answer the question using only these transcript excerpts:", ""]
    for i, r in enumerate(results, 1):
        who = r.speaker or "unknown speaker"
        span = f"{format_timestamp(r.start)}-{format_timestamp(r.end)}"
        lines.append(f"[Excerpt {i}] ({who}, {span})")
        lines.append(r.text.strip())
        lines.append("")
    lines.append(f"Question: {query}")
    lines.append("Answer:")
    return "\n".join(lines)
