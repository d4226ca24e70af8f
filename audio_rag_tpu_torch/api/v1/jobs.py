"""Job endpoints (counterpart of ``audio_rag_tpu/api/v1/jobs.py``):
``GET /api/v1/jobs/{id}`` (progress from the stage, the result once
terminal), ``DELETE /api/v1/jobs/{id}`` (cancel), ``GET /api/v1/jobs``
(the caller tenant's jobs, paginated, limit at most 100) and
``GET /api/v1/queue/stats``.
"""

from __future__ import annotations

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.deps import (
    authenticate,
    check_rate_limit,
    get_queue,
)
from audio_rag_tpu_torch.api.http import App, HTTPError, Request, Response
from audio_rag_tpu_torch.api.schemas import (
    JobCancelResponse,
    JobStatusResponse,
    QueueStatsResponse,
)

__all__ = ["register_job_routes"]


def register_job_routes(app: App) -> None:
    config: APIConfig = app.state["config"]

    @app.get("/api/v1/jobs/{job_id}")
    async def job_status(request: Request) -> Response:
        authenticate(request, config)
        check_rate_limit(request, config, "status", app.state["store"])
        queue = get_queue(app.state)
        job_id = request.path_params["job_id"]
        st = queue.get_status(job_id)
        result = queue.get_result(job_id)
        payload = JobStatusResponse(
            **st,
            result=None if result is None else {
                "num_chunks": result.num_chunks,
                "num_segments": result.num_segments,
                "num_speakers": result.num_speakers,
                "duration_s": result.duration_s,
                "elapsed_s": result.elapsed_s,
                "metrics": result.metrics,
            },
        )
        return Response.json(payload.to_dict())

    @app.delete("/api/v1/jobs/{job_id}")
    async def cancel_job(request: Request) -> Response:
        authenticate(request, config)
        queue = get_queue(app.state)
        job_id = request.path_params["job_id"]
        ok = queue.cancel(job_id)
        return Response.json(
            JobCancelResponse(job_id=job_id, cancelled=ok).to_dict()
        )

    @app.get("/api/v1/jobs")
    async def list_jobs(request: Request) -> Response:
        ctx = authenticate(request, config)
        check_rate_limit(request, config, "status", app.state["store"])
        queue = get_queue(app.state)
        try:
            limit = min(int(request.query.get("limit", "20")), 100)
            offset = max(int(request.query.get("offset", "0")), 0)
        except ValueError:
            raise HTTPError(422, "limit/offset must be integers") from None
        status_filter = request.query.get("status")
        rows, total = queue.store.list_jobs(
            tenant_id=ctx.tenant_id, status=status_filter,
            limit=limit, offset=offset,
        )
        return Response.json({
            "jobs": rows,
            "total": total,
            "limit": limit,
            "offset": offset,
        })

    @app.get("/api/v1/queue/stats")
    async def queue_stats(request: Request) -> Response:
        authenticate(request, config)
        queue = get_queue(app.state)
        stats = queue.get_queue_stats()
        return Response.json(QueueStatsResponse(**stats).to_dict())
