"""The API's v1 routes (counterpart of ``audio_rag_tpu/api/v1``)."""

from audio_rag_tpu_torch.api.v1.router import register_v1_routes

__all__ = ["register_v1_routes"]
