"""The generator factory (counterpart of
``audio_rag_tpu/generation/base.py``): backend "none" → None, "fake" → the
fake generator, "llm-jax" → the LLM, behind the wave scheduler or the
continuous batcher (``scheduler_mode``) when ``use_scheduler`` is on (the
default)."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import GenerationConfig
from audio_rag_tpu_torch.engine.scheduler import ScheduledGenerator
from audio_rag_tpu_torch.generation.fake import FakeGenerator
from audio_rag_tpu_torch.generation.llm import LLMGenerator

__all__ = ["create_generator"]


def create_generator(config: GenerationConfig | None = None,
                     device: str | torch.device = "cuda"):
    """The generator ``config.backend`` names (the LLM on ``device``), None
    for "none"."""
    config = config or GenerationConfig()
    if config.backend == "none":
        return None
    if config.backend == "fake":
        return FakeGenerator(config)
    gen = LLMGenerator(config, device=device)
    if config.use_scheduler:
        return ScheduledGenerator(
            gen, max_batch=config.scheduler_max_batch,
            max_wait_ms=config.scheduler_max_wait_ms,
            mode=config.scheduler_mode, n_slots=config.scheduler_slots,
            segment_tokens=config.scheduler_segment_tokens,
            context_tokens=config.scheduler_context_tokens,
            idle_segment_tokens=config.scheduler_idle_segment_tokens)
    return gen
