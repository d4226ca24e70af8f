"""Kubernetes-style health probes (counterpart of
``audio_rag_tpu/api/health.py``): ``/health/live`` is 200 while the
process runs; ``/health/ready`` checks the job queue and the vector store
(2 s each) and answers 503 when one fails; ``/health/startup`` is 200 once
the app is initialized.
"""

from __future__ import annotations

import asyncio

from audio_rag_tpu_torch.api.http import App, Request, Response

__all__ = ["register_health_routes"]


def register_health_routes(app: App) -> None:
    @app.get("/health/live")
    async def liveness(request: Request) -> Response:
        return Response.json({"status": "alive"})

    @app.get("/health/ready")
    async def readiness(request: Request) -> Response:
        checks: dict[str, bool] = {}

        async def check_queue() -> bool:
            queue = app.state.get("queue")
            return bool(queue and queue.health())

        async def check_store() -> bool:
            retriever = app.state.get("retriever")
            if retriever is None:
                return True
            try:
                retriever.count()
                return True
            except Exception:
                return False

        try:
            checks["queue"] = await asyncio.wait_for(check_queue(), 2.0)
            checks["vector_store"] = await asyncio.wait_for(check_store(), 2.0)
        except asyncio.TimeoutError:
            checks.setdefault("queue", False)
            checks.setdefault("vector_store", False)

        ok = all(checks.values())
        return Response.json(
            {"status": "ready" if ok else "not_ready", "checks": checks},
            200 if ok else 503,
        )

    @app.get("/health/startup")
    async def startup(request: Request) -> Response:
        if app.state.get("initialized"):
            return Response.json({"status": "started"})
        return Response.json({"status": "starting"}, 503)
