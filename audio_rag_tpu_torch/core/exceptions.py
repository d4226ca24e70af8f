"""Error taxonomy of the PyTorch port: the subset of
``audio_rag_tpu/core/exceptions.py`` that the ingest → query slice raises.
Names match the JAX package so callers catch the same types."""

from __future__ import annotations

from typing import Any

__all__ = [
    "AudioRAGError",
    "ConfigError",
    "ModelNotLoadedError",
    "AudioProcessingError",
    "TranscriptionError",
    "RetrievalError",
    "GenerationError",
    "TTSError",
]


class AudioRAGError(Exception):
    """Base class for all framework errors, with a structured ``context``."""

    def __init__(self, message: str, *, context: dict[str, Any] | None = None):
        super().__init__(message)
        self.message = message
        self.context = context or {}


class ConfigError(AudioRAGError):
    """Invalid configuration (including a device that is not present)."""


class ModelNotLoadedError(AudioRAGError):
    """A backend was used before ``load()``."""


class AudioProcessingError(AudioRAGError):
    """Audio decode/validation failure."""


class TranscriptionError(AudioRAGError):
    """ASR failure."""


class RetrievalError(AudioRAGError):
    """Vector store / search failure."""


class GenerationError(AudioRAGError):
    """LLM answer-synthesis failure."""


class TTSError(AudioRAGError):
    """Text-to-speech failure."""
