"""Authentication, request context and rate limits (counterpart of
``audio_rag_tpu/api/deps.py``): ``X-API-Key`` auth (401 without a key, 403
for an unknown one), the per-request context (request id, tenant, tier), a
sliding-window limit per (tenant, operation) over the job store's
``rate_limit_count`` with the ``x-ratelimit-*`` headers and 429 with
``retry-after``, failing open when the store errors, and the job queue,
503 when it is unhealthy.
"""

from __future__ import annotations

import logging
import time
import uuid
from dataclasses import dataclass

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.http import HTTPError, Request
from audio_rag_tpu_torch.jobqueue.queue import AudioRAGQueue

log = logging.getLogger(__name__)

__all__ = ["RequestContext", "authenticate", "check_rate_limit", "get_queue"]

WINDOWS = {
    "query": ("query_per_minute", 60.0),
    "ingest": ("ingest_per_hour", 3600.0),
    "status": ("status_per_minute", 60.0),
}


@dataclass
class RequestContext:
    request_id: str
    tenant_id: str
    tier: str
    api_key: str


def authenticate(request: Request, config: APIConfig) -> RequestContext:
    api_key = request.header("x-api-key")
    if not api_key:
        raise HTTPError(401, "missing X-API-Key header")
    info = config.api_keys.get(api_key)
    if info is None:
        raise HTTPError(403, "invalid API key")
    ctx = RequestContext(
        request_id=request.header("x-request-id") or str(uuid.uuid4()),
        tenant_id=info["tenant_id"],
        tier=info.get("tier", "free"),
        api_key=api_key,
    )
    request.context["ctx"] = ctx
    return ctx


def check_rate_limit(
    request: Request, config: APIConfig, operation: str, store
) -> None:
    """Sliding-window limit per (tenant, operation); the limit headers go
    to ``request.context["rate_headers"]`` for the middleware. A store
    that fails lets the request through: an unavailable limiter must not
    take the API down."""
    ctx: RequestContext = request.context["ctx"]
    attr, window_s = WINDOWS[operation]
    tier = config.tiers.get(ctx.tier) or next(iter(config.tiers.values()))
    limit = getattr(tier, attr)
    try:
        count = store.rate_limit_count(
            f"{ctx.tenant_id}:{operation}", window_s
        )
    except Exception as exc:
        log.warning("rate limiter unavailable (%s); failing open", exc)
        return
    remaining = max(0, limit - count)
    request.context["rate_headers"] = {
        "x-ratelimit-limit": str(limit),
        "x-ratelimit-remaining": str(remaining),
        "x-ratelimit-reset": str(int(time.time() + window_s)),
    }
    if count > limit:
        raise HTTPError(
            429,
            f"rate limit exceeded for {operation} "
            f"({limit} per {int(window_s)}s)",
            headers={
                **request.context["rate_headers"],
                "retry-after": str(int(window_s)),
            },
        )


def get_queue(app_state: dict) -> AudioRAGQueue:
    queue: AudioRAGQueue | None = app_state.get("queue")
    if queue is None or not queue.health():
        raise HTTPError(503, "job queue unavailable")
    return queue
