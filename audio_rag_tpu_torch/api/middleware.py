"""Cross-cutting middleware and the exception map (counterpart of
``audio_rag_tpu/api/middleware.py``): the request id (``x-request-id``,
echoed or made), ``x-response-time-ms``, the rate-limit headers, CORS and
the preflight, a log line a request at a level by its status, and the
job queue's errors as JSON: duplicate 409, not found 404, already
terminal 409, queue full 503, queue unavailable 503, validation 422. A
request body that fails its schema (:class:`~audio_rag_tpu_torch.api.
schemas.ValidationError`) answers 422 with ``{"error":
"validation_error", "detail": [{"loc", "msg"}, ...]}``.
"""

from __future__ import annotations

import logging
import time
import uuid

from audio_rag_tpu_torch.api.http import App, Request, Response
from audio_rag_tpu_torch.api.schemas import ValidationError as SchemaError
from audio_rag_tpu_torch.jobqueue.exceptions import (
    DuplicateJobError,
    JobAlreadyTerminalError,
    JobNotFoundError,
    QueueConnectionError,
    QueueFullError,
    ValidationError,
)

log = logging.getLogger(__name__)

__all__ = ["setup_middleware"]

_CORS_HEADERS = "content-type, x-api-key, x-request-id"
_CORS_METHODS = "GET, POST, DELETE, OPTIONS"


def setup_middleware(app: App, cors_origins: list[str] | None = None) -> None:
    origins = cors_origins or ["*"]

    @app.middleware
    async def request_id_and_timing(request: Request, call_next):
        rid = request.header("x-request-id") or str(uuid.uuid4())
        request.context["request_id"] = rid
        t0 = time.perf_counter()
        response = await call_next(request)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        response.headers["x-request-id"] = rid
        response.headers["x-response-time-ms"] = f"{dt_ms:.1f}"
        for k, v in request.context.get("rate_headers", {}).items():
            response.headers.setdefault(k, v)
        origin = request.header("origin")
        if origin and ("*" in origins or origin in origins):
            response.headers["access-control-allow-origin"] = (
                origin if "*" not in origins else "*"
            )
            response.headers["access-control-allow-headers"] = _CORS_HEADERS
            response.headers["access-control-allow-methods"] = _CORS_METHODS
        level = (
            log.warning if response.status >= 500
            else log.info if response.status >= 400 else log.debug
        )
        level("%s %s -> %d (%.1f ms) rid=%s", request.method, request.path,
              response.status, dt_ms, rid)
        return response

    @app.middleware
    async def preflight(request: Request, call_next):
        if request.method == "OPTIONS":
            return Response(b"", 204, headers={
                "access-control-allow-origin": "*",
                "access-control-allow-headers": _CORS_HEADERS,
                "access-control-allow-methods": _CORS_METHODS,
            })
        return await call_next(request)

    # -- exception map -------------------------------------------------------
    @app.exception_handler(DuplicateJobError)
    async def dup(request: Request, exc: DuplicateJobError):
        return Response.json(
            {"error": "duplicate_job", "detail": exc.message,
             "existing_job_id": exc.existing_job_id}, 409
        )

    @app.exception_handler(JobNotFoundError)
    async def nf(request: Request, exc: JobNotFoundError):
        return Response.json(
            {"error": "job_not_found", "detail": exc.message}, 404
        )

    @app.exception_handler(JobAlreadyTerminalError)
    async def term(request: Request, exc: JobAlreadyTerminalError):
        return Response.json(
            {"error": "job_already_terminal", "detail": exc.message}, 409
        )

    @app.exception_handler(QueueFullError)
    async def full(request: Request, exc: QueueFullError):
        return Response.json(
            {"error": "queue_full", "detail": exc.message,
             "recoverable": True}, 503,
        )

    @app.exception_handler(QueueConnectionError)
    async def conn(request: Request, exc: QueueConnectionError):
        return Response.json(
            {"error": "queue_unavailable", "detail": exc.message}, 503
        )

    @app.exception_handler(ValidationError)
    async def val(request: Request, exc: ValidationError):
        return Response.json(
            {"error": "validation_error", "detail": exc.message,
             "context": exc.context}, 422
        )

    @app.exception_handler(SchemaError)
    async def schema(request: Request, exc: SchemaError):
        return Response.json(
            {"error": "validation_error",
             "detail": [
                 {"loc": list(e["loc"]), "msg": e["msg"]}
                 for e in exc.errors()
             ]}, 422
        )
