"""Deterministic fake generator (copy of
``audio_rag_tpu/generation/fake.py``): a fixed answer naming the prompt's
question and its excerpt count."""

from __future__ import annotations

import re

from audio_rag_tpu_torch.config import GenerationConfig

__all__ = ["FakeGenerator"]


class FakeGenerator:
    is_loaded = True
    hbm_required_gb = 0.0

    def __init__(self, config: GenerationConfig | None = None):
        self.config = config or GenerationConfig()

    def load(self) -> None:
        pass

    def unload(self) -> None:
        pass

    def check_availability(self) -> bool:
        return True

    def generate(self, prompt: str, system: str | None = None,
                 max_tokens: int | None = None,
                 temperature: float | None = None) -> str:
        m = re.search(r"Question:\s*(.+)", prompt)
        question = m.group(1).strip() if m else prompt[:60]
        n_excerpts = len(re.findall(r"\[Excerpt \d+\]", prompt))
        cite = " [Excerpt 1]" if n_excerpts else ""
        return (
            f"Based on {n_excerpts or 'the'} provided excerpt(s), regarding "
            f"'{question}': this is a deterministic fake answer.{cite}"
        )
