"""The TTS factory and the backends' common lifecycle (counterpart of
``audio_rag_tpu/tts/base.py`` and the JAX ``BaseTTS``): ``create_tts``
builds the backend ``config.backend`` names from ``TTS_BACKENDS`` ("none"
gives None); a backend loads with ``load()`` (which raises ``TTSError``
where its engine is missing), and ``synthesize(text, output_path)`` returns
WAV (or the engine's) bytes."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import TTSConfig
from audio_rag_tpu_torch.core.exceptions import (
    ConfigError,
    ModelNotLoadedError,
)

__all__ = ["BaseTTS", "TTS_BACKENDS", "register_tts", "create_tts"]

#: backend name → class; each module registers itself on import
TTS_BACKENDS: dict[str, type] = {}


def register_tts(name: str):
    def deco(cls):
        TTS_BACKENDS[name] = cls
        return cls
    return deco


class BaseTTS:
    """Text → waveform bytes, with load/unload/is_loaded."""

    def __init__(self, config: TTSConfig | None = None):
        self.config = config or TTSConfig()
        self._loaded = False

    @property
    def is_loaded(self) -> bool:
        return self._loaded

    def load(self) -> None:
        self._load()
        self._loaded = True

    def unload(self) -> None:
        self._loaded = False

    def _load(self) -> None:
        pass

    def require_loaded(self) -> None:
        if not self._loaded:
            raise ModelNotLoadedError(
                f"{type(self).__name__} used before load()",
                context={"backend": type(self).__name__})

    def synthesize(self, text: str, output_path: str | None = None) -> bytes:
        raise NotImplementedError


def create_tts(config: TTSConfig | None = None,
               device: str | torch.device = "cuda") -> BaseTTS | None:
    """The backend ``config.backend`` names, not loaded; None for "none".
    The neural backend runs on ``device``."""
    config = config or TTSConfig()
    if config.backend == "none":
        return None
    if config.backend not in TTS_BACKENDS:
        raise ConfigError(f"tts backend {config.backend!r} is not "
                          "registered", context={"backend": config.backend})
    cls = TTS_BACKENDS[config.backend]
    if getattr(cls, "uses_device", False):
        return cls(config, device=device)
    return cls(config)
