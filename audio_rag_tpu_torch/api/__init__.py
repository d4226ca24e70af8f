"""The port's HTTP/WebSocket API (counterpart of ``audio_rag_tpu/api``):
a first-party asyncio server (:mod:`~audio_rag_tpu_torch.api.http`), the
v1 ingest, jobs, query, collections and live-transcription routes, health
probes and Prometheus metrics, built by :func:`create_app`; served by
``python -m audio_rag_tpu_torch.api``."""

from audio_rag_tpu_torch.api.app import create_app

__all__ = ["create_app"]
