"""Answer generation of the port: the LLM generator, the fake one, the
factory and the RAG prompts."""

from audio_rag_tpu_torch.generation.base import create_generator
from audio_rag_tpu_torch.generation.fake import FakeGenerator
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from audio_rag_tpu_torch.generation.prompts import (
    SYSTEM_PROMPT,
    build_rag_prompt,
    format_timestamp,
)

__all__ = ["create_generator", "FakeGenerator", "LLMGenerator",
           "SYSTEM_PROMPT", "build_rag_prompt", "format_timestamp"]
