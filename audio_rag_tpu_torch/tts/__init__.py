"""Speech output of the port (counterpart of ``audio_rag_tpu/tts``): the
null tone, the neural TTS ("jax") and the external engines (piper,
edge-tts), built by :func:`create_tts`."""

from audio_rag_tpu_torch.tts import external as _external  # noqa: F401
from audio_rag_tpu_torch.tts import neural as _neural  # noqa: F401
from audio_rag_tpu_torch.tts import null as _null  # noqa: F401
from audio_rag_tpu_torch.tts.base import TTS_BACKENDS, BaseTTS, create_tts

__all__ = ["TTS_BACKENDS", "BaseTTS", "create_tts"]
