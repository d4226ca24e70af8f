"""The generator factory (counterpart of
``audio_rag_tpu/generation/base.py``): backend "none" → None, "fake" → the
fake generator, "llm-jax" → the LLM, behind the wave scheduler when
``use_scheduler`` is on (the default). The continuous batcher is not
ported: asking for it raises."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import GenerationConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
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
    if config.use_scheduler and config.scheduler_mode == "continuous":
        raise ConfigError(
            "scheduler_mode='continuous' (the continuous batcher) is not "
            "ported (ROADMAP.md §1 item 7); use 'wave'",
            context={"scheduler_mode": config.scheduler_mode})
    gen = LLMGenerator(config, device=device)
    if config.use_scheduler:
        return ScheduledGenerator(gen, max_batch=config.scheduler_max_batch,
                                  max_wait_ms=config.scheduler_max_wait_ms)
    return gen
