"""Ingestion endpoint (counterpart of ``audio_rag_tpu/api/v1/ingest.py``):
a multipart upload (spooled to disk by the HTTP layer), the extension
(422), empty-file (422) and size (413) checks, the ``metadata`` and
``config`` fields as JSON (422 otherwise), the ``priority`` name, an
:class:`~audio_rag_tpu_torch.jobqueue.job.IngestJob` through the queue
with validation, and a 202 whose wait estimate is the queue's depth ×
240 s.
"""

from __future__ import annotations

import json
from pathlib import Path

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.deps import (
    authenticate,
    check_rate_limit,
    get_queue,
)
from audio_rag_tpu_torch.api.http import App, HTTPError, Request, Response
from audio_rag_tpu_torch.api.schemas import IngestResponse
from audio_rag_tpu_torch.jobqueue.job import IngestJob, Priority

__all__ = ["register_ingest_routes"]

EST_SECONDS_PER_JOB = 240.0


def register_ingest_routes(app: App) -> None:
    config: APIConfig = app.state["config"]

    @app.post("/api/v1/ingest")
    async def ingest(request: Request) -> Response:
        ctx = authenticate(request, config)
        check_rate_limit(request, config, "ingest", app.state["store"])
        queue = get_queue(app.state)

        if not request.files:
            raise HTTPError(422, "multipart file field 'file' required")
        upload = request.files[0]
        ext = Path(upload.filename).suffix.lower()
        if ext not in config.allowed_upload_extensions:
            upload.path.unlink(missing_ok=True)
            raise HTTPError(
                422,
                f"unsupported extension {ext!r} "
                f"(allowed: {config.allowed_upload_extensions})",
            )
        if upload.size == 0:
            upload.path.unlink(missing_ok=True)
            raise HTTPError(422, "uploaded file is empty")
        if upload.size > config.max_upload_bytes:
            upload.path.unlink(missing_ok=True)
            raise HTTPError(413, "file exceeds upload limit")

        metadata = {}
        if request.form.get("metadata"):
            try:
                metadata = json.loads(request.form["metadata"])
            except json.JSONDecodeError:
                raise HTTPError(422, "metadata must be valid JSON") from None
        config_overrides = {}
        if request.form.get("config"):
            # per-job pipeline overrides, e.g. {"chunking.max_tokens": 128}
            try:
                config_overrides = json.loads(request.form["config"])
            except json.JSONDecodeError:
                raise HTTPError(422, "config must be valid JSON") from None
        priority_name = request.form.get("priority", "normal")
        try:
            priority = Priority.from_name(priority_name)
        except KeyError:
            raise HTTPError(
                422, f"invalid priority {priority_name!r}"
            ) from None

        job = IngestJob(
            tenant_id=ctx.tenant_id,
            audio_path=str(upload.path),
            priority=priority,
            collection=request.form.get("collection"),
            metadata={"filename": upload.filename, **metadata},
            config_overrides=config_overrides,
        )
        job_id = queue.enqueue(job, validate=True)
        qname = queue.config.queue_for_priority(priority.name).name
        depth = queue.store.queue_depth(qname)
        payload = IngestResponse(
            job_id=job_id,
            status="queued",
            queue=qname,
            estimated_wait_s=depth * EST_SECONDS_PER_JOB,
            collection=job.collection,
            request_id=request.context.get("request_id"),
        )
        return Response.json(payload.to_dict(), 202)
