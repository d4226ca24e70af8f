"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default. A CUDA request on a machine
without a usable card raises: the port never runs on the CPU unless the
caller asks for it.
"""

from __future__ import annotations

import torch

from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` → ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU",
            context={"device": str(device)},
        )
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"unsupported device {str(device)!r}",
                          context={"device": str(device)})
    return dev
