"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default. A CUDA request on a machine
without a usable card raises: the port never runs on the CPU unless the
caller asks for it.

The port sets no process-wide ``torch.backends`` switch. Where it relies on
f32 precision it scopes that to the call: :func:`full_f32_matmul` for f32
matmuls, :func:`full_f32_conv` for f32 convolutions, :func:`full_f32` for
a whole region (a training step's forward and backward).
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = ["full_f32", "full_f32_conv", "full_f32_matmul", "resolve_device"]


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


def full_f32_matmul() -> contextlib.AbstractContextManager:
    """f32 matmuls without TF32 inside, whatever the caller's switch says.
    At PyTorch's default ("highest") nothing is touched, and the scope
    costs no more than a null context."""
    if torch.get_float32_matmul_precision() == "highest":
        return contextlib.nullcontext()
    return _f32_matmul_precision("highest")


@contextlib.contextmanager
def _f32_matmul_precision(precision: str) -> Iterator[None]:
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def full_f32_conv(x: torch.Tensor) -> contextlib.AbstractContextManager:
    """cuDNN without TF32 for a convolution of ``x`` (PyTorch's default
    lets f32 convolutions take TF32, about three decimal digits); the
    other cuDNN switches stay as the caller set them. A CPU tensor needs
    no scope."""
    if not x.is_cuda:
        return contextlib.nullcontext()
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@contextlib.contextmanager
def full_f32(device: str | torch.device) -> Iterator[None]:
    """:func:`full_f32_matmul` and, on CUDA, cuDNN without TF32, over a
    whole region. A training step needs it around its forward and its
    backward: autograd runs a convolution's backward after the forward's
    :func:`full_f32_conv` scope has closed, where PyTorch's default would
    let the f32 gradient take TF32."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(full_f32_matmul())
        if torch.device(device).type == "cuda":
            cudnn = torch.backends.cudnn
            stack.enter_context(cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic, allow_tf32=False))
        yield
