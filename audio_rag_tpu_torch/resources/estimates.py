"""Each device backend's ``hbm_required_gb``: the port's own estimate,
known before the backend loads. It is the bytes of the parameters in the
port's layout (the shapes of :mod:`audio_rag_tpu_torch.weights`' specs
times the storage dtype's size) plus the quantized decode copies
(:func:`~audio_rag_tpu_torch.models.whisper.q8_param_bytes`,
:func:`~audio_rag_tpu_torch.models.llm.q8_param_bytes`), in GB (1e9
bytes). Activations, caches and the allocator's slack are not counted:
the figure is what the manager books, as the JAX package's static
estimates are, and the card's own counters say what a load allocated.
"""

from __future__ import annotations

import math

import torch

from audio_rag_tpu_torch.models.bert import BertDims
from audio_rag_tpu_torch.models.llm import LLMDims
from audio_rag_tpu_torch.models.llm import q8_param_bytes as llm_q8_bytes
from audio_rag_tpu_torch.models.speaker import SpeakerDims
from audio_rag_tpu_torch.models.whisper import WhisperDims
from audio_rag_tpu_torch.models.whisper import q8_param_bytes as asr_q8_bytes
from audio_rag_tpu_torch.weights import (
    bgem3_spec,
    cross_encoder_spec,
    llm_spec,
    speaker_spec,
    whisper_spec,
)

__all__ = ["spec_bytes", "whisper_gb", "llm_gb", "bgem3_gb", "e5_gb",
           "cross_encoder_gb", "speaker_gb"]


def spec_bytes(spec: dict[str, tuple[int, ...]], dtype: torch.dtype) -> int:
    """Bytes of a layout's leaves stored in ``dtype``."""
    item = torch.empty((), dtype=dtype).element_size()
    return item * sum(math.prod(shape) for shape in spec.values())


def whisper_gb(dims: WhisperDims, dtype: torch.dtype, decoder_bits: int = 0,
               lm_head_bits: int | None = None) -> float:
    """Whisper in ``dtype`` plus its quantized decoder copies."""
    n = spec_bytes(whisper_spec(dims), dtype)
    if decoder_bits:
        n += asr_q8_bytes(dims, decoder_bits, lm_head_bits)
    return n / 1e9


def llm_gb(dims: LLMDims, dtype: torch.dtype, bits: int = 0,
           lm_head_bits: int | None = None) -> float:
    """The LLM in ``dtype`` plus its quantized decode-step copies."""
    n = spec_bytes(llm_spec(dims), dtype)
    if bits:
        n += llm_q8_bytes(dims, bits, lm_head_bits)
    return n / 1e9


def bgem3_gb(dims: BertDims, dtype: torch.dtype = torch.bfloat16) -> float:
    return spec_bytes(bgem3_spec(dims), dtype) / 1e9


def e5_gb(dims: BertDims, dtype: torch.dtype = torch.bfloat16) -> float:
    spec = {k: v for k, v in bgem3_spec(dims).items()
            if k.startswith("bert/")}
    return spec_bytes(spec, dtype) / 1e9


def cross_encoder_gb(dims: BertDims, n_out: int = 1,
                     dtype: torch.dtype = torch.bfloat16) -> float:
    return spec_bytes(cross_encoder_spec(dims, n_out), dtype) / 1e9


def speaker_gb(dims: SpeakerDims) -> float:
    """The speaker encoder, stored in f32."""
    return spec_bytes(speaker_spec(dims), torch.float32) / 1e9
