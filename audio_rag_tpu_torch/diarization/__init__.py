"""Speaker diarization of the port: the clustering (spectral) and AHC
engines and the fake round-robin diarizer, by backend name through
:func:`create_diarizer`."""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.config import DiarizationConfig
from audio_rag_tpu_torch.diarization.ahc import AHCDiarizer
from audio_rag_tpu_torch.diarization.clustering import ClusteringDiarizer
from audio_rag_tpu_torch.diarization.fake import FakeDiarizer

__all__ = ["create_diarizer", "ClusteringDiarizer", "AHCDiarizer",
           "FakeDiarizer"]

_ENGINES = {"clustering": ClusteringDiarizer, "ahc": AHCDiarizer,
            "fake": FakeDiarizer}


def create_diarizer(config: DiarizationConfig | None = None,
                    device: str | torch.device = "cuda"):
    """The diarizer that ``config.backend`` names (the config refuses any
    other name), on ``device``."""
    config = config or DiarizationConfig()
    return _ENGINES[config.backend](config, device=device)
