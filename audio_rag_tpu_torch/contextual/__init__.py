"""Contextual chunk headers of the port."""

from audio_rag_tpu_torch.contextual.processor import (
    CONTEXT_PROMPT,
    ContextualProcessor,
    extractive_headers,
)

__all__ = ["CONTEXT_PROMPT", "ContextualProcessor", "extractive_headers"]
