"""v1 route registration, in the JAX package's order (counterpart of
``audio_rag_tpu/api/v1/router.py``)."""

from __future__ import annotations

from audio_rag_tpu_torch.api.http import App
from audio_rag_tpu_torch.api.v1.collections import register_collection_routes
from audio_rag_tpu_torch.api.v1.ingest import register_ingest_routes
from audio_rag_tpu_torch.api.v1.jobs import register_job_routes
from audio_rag_tpu_torch.api.v1.query import register_query_routes
from audio_rag_tpu_torch.api.v1.streaming import register_streaming_routes

__all__ = ["register_v1_routes"]


def register_v1_routes(app: App) -> None:
    register_query_routes(app)
    register_ingest_routes(app)
    register_job_routes(app)
    register_collection_routes(app)
    register_streaming_routes(app)
