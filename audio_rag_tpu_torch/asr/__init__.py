"""ASR backends of the port, by the config's backend name through
:func:`create_asr`."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import ASRConfig

__all__ = ["create_asr"]


def create_asr(config: ASRConfig | None = None,
               device: str | torch.device = "cuda"):
    """The backend ``config.backend`` names, as the JAX registry maps it:
    "whisper-jax" and "streaming-whisper" → :class:`WhisperASR` on
    ``device``, "fake" → :class:`FakeASR`."""
    config = config or ASRConfig()
    if config.backend == "fake":
        from audio_rag_tpu_torch.asr.fake import FakeASR

        return FakeASR(config)
    from audio_rag_tpu_torch.asr.whisper import WhisperASR

    return WhisperASR(config, device=device)
