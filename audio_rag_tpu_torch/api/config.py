"""API configuration (counterpart of ``audio_rag_tpu/api/config.py``; its
pydantic settings become dataclasses with the same fields and defaults):
tier-based rate limits (free/basic/premium × query/ingest/status), upload
limits (500 MB, 8 extensions), the query coalescer's switch and linger,
the metrics gate, and a development API-key table mapping keys to
{tenant_id, tier}. A deployment replaces the keys through
``AUDIO_RAG_API_KEYS`` (JSON) and the port through ``AUDIO_RAG_API_PORT``;
``AUDIO_RAG_METRICS_AUTH=1`` closes ``/metrics`` to callers without a key.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

__all__ = ["RateLimitTier", "APIConfig", "DEV_API_KEYS", "DEFAULT_TIERS"]


@dataclass
class RateLimitTier:
    query_per_minute: int = 30
    ingest_per_hour: int = 10
    status_per_minute: int = 120


DEFAULT_TIERS: dict[str, RateLimitTier] = {
    "free": RateLimitTier(query_per_minute=30, ingest_per_hour=10,
                          status_per_minute=120),
    "basic": RateLimitTier(query_per_minute=120, ingest_per_hour=50,
                           status_per_minute=600),
    "premium": RateLimitTier(query_per_minute=600, ingest_per_hour=500,
                             status_per_minute=3000),
}

#: development keys; a deployment replaces them
DEV_API_KEYS: dict[str, dict[str, str]] = {
    "dev-key-free": {"tenant_id": "dev_tenant_free", "tier": "free"},
    "dev-key-basic": {"tenant_id": "dev_tenant_basic", "tier": "basic"},
    "dev-key-premium": {"tenant_id": "dev_tenant_premium", "tier": "premium"},
}


@dataclass
class APIConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    cors_origins: list[str] = field(default_factory=lambda: ["*"])
    max_upload_bytes: int = 500 * 1024 * 1024
    allowed_upload_extensions: list[str] = field(
        default_factory=lambda: [
            ".wav", ".mp3", ".m4a", ".flac", ".ogg", ".opus", ".webm", ".mp4",
        ]
    )
    max_audio_duration_minutes: int = 480
    request_timeout_s: float = 120.0
    tiers: dict[str, RateLimitTier] = field(
        default_factory=lambda: dict(DEFAULT_TIERS))
    api_keys: dict[str, dict[str, str]] = field(
        default_factory=lambda: dict(DEV_API_KEYS))
    upload_dir: str = "./data/uploads"
    queue_db_path: str = "./data/queue.db"
    #: run an in-process worker thread instead of a separate worker process
    inline_worker: bool = False
    #: coalesce concurrent search-only queries into one batched query
    #: (``engine/query_coalescer.py``); each query's results are its own
    coalesce_queries: bool = True
    #: the coalescer's drain window (ms) after each arrival: clients woken
    #: together by one batch's end resubmit one at a time, and a few ms
    #: gather them into the next batch
    coalesce_linger_ms: float = 4.0
    #: require an API key on GET /metrics (open by default: an in-cluster
    #: scraper carries no tenant key; the endpoint shows queue depths and
    #: resident model names, so a deployment exposed beyond its cluster
    #: sets AUDIO_RAG_METRICS_AUTH=1)
    metrics_require_auth: bool = False

    @classmethod
    def from_env(cls) -> "APIConfig":
        cfg = cls()
        raw = os.environ.get("AUDIO_RAG_API_KEYS")
        if raw:
            try:
                cfg.api_keys = json.loads(raw)
            except json.JSONDecodeError:
                pass
        if os.environ.get("AUDIO_RAG_API_PORT"):
            cfg.port = int(os.environ["AUDIO_RAG_API_PORT"])
        if os.environ.get("AUDIO_RAG_METRICS_AUTH"):
            cfg.metrics_require_auth = os.environ[
                "AUDIO_RAG_METRICS_AUTH"] not in ("0", "false", "")
        return cfg
