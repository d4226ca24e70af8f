"""The API's app factory and ``python -m audio_rag_tpu_torch.api``
(counterpart of ``audio_rag_tpu/api/app.py``).

:func:`create_app` wires the job queue (SQLite at ``queue_db_path``
unless one is passed), the pipeline (``rag``; its store serves the
collection routes and the readiness probe), one single-thread device
executor (so that concurrent requests' device work runs one at a time,
off the event loop), the middleware, the health probes, the v1 routes,
``/metrics``, the web UI under ``frontend/`` and ``/api``. Served by
:meth:`~audio_rag_tpu_torch.api.http.App.serve`, its startup starts the
idle reaper (``evict_idle(resources.unload_after_idle_seconds)`` every
``max(idle / 4, 10)`` s), and its shutdown stops the coalescer, the mux
and the inline worker (``inline_worker``: a
:class:`~audio_rag_tpu_torch.jobqueue.worker.GPUWorker` draining the queue
into ``rag`` on a daemon thread, for a single-node deployment).

``main()`` builds the pipeline from the port's layered config (``--config``,
``--env``); it runs on the card unless the config says ``device: cpu``
(``AUDIO_RAG__DEVICE=cpu``), and raises without a card otherwise.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import pathlib
import threading

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.health import register_health_routes
from audio_rag_tpu_torch.api.http import App, HTTPError, Request, Response
from audio_rag_tpu_torch.api.metrics import register_metrics_route
from audio_rag_tpu_torch.api.middleware import setup_middleware
from audio_rag_tpu_torch.api.v1.router import register_v1_routes
from audio_rag_tpu_torch.jobqueue.config import QueueConfig, StorageConfig
from audio_rag_tpu_torch.jobqueue.queue import AudioRAGQueue
from audio_rag_tpu_torch.jobqueue.store import JobStore

log = logging.getLogger(__name__)

__all__ = ["create_app", "main"]


def create_app(
    config: APIConfig | None = None,
    rag=None,
    queue: AudioRAGQueue | None = None,
) -> App:
    """Build the app; ``rag`` and ``queue`` may be given (tests do)."""
    config = config or APIConfig.from_env()
    app = App(max_body_bytes=config.max_upload_bytes + (1 << 20),
              upload_dir=config.upload_dir)
    app.state["config"] = config

    if queue is None:
        store = JobStore(config.queue_db_path)
        qcfg = QueueConfig(
            storage=StorageConfig(db_path=config.queue_db_path)
        )
        queue = AudioRAGQueue(qcfg, store=store)
    app.state["queue"] = queue
    app.state["store"] = queue.store

    app.state["rag"] = rag
    app.state["rag_config"] = rag.config if rag is not None else None
    app.state["retriever"] = rag.store if rag is not None else None
    app.state["executor"] = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="device"
    )
    app.state["initialized"] = True

    setup_middleware(app, config.cors_origins)
    register_health_routes(app)
    register_v1_routes(app)
    register_metrics_route(app)

    @app.on_startup
    async def start_idle_reaper():
        from audio_rag_tpu_torch.resources.manager import get_resource_manager

        rag_cfg = app.state.get("rag_config")
        idle_s = (
            rag_cfg.resources.unload_after_idle_seconds
            if rag_cfg is not None else 0
        )
        if idle_s <= 0:
            return

        async def reap():
            while True:
                await asyncio.sleep(max(idle_s / 4, 10))
                try:
                    get_resource_manager().evict_idle(idle_s)
                except Exception as exc:
                    log.warning("idle eviction failed: %s", exc)

        app.state["idle_reaper"] = asyncio.create_task(reap())

    _register_frontend(app)

    @app.get("/api")
    async def root(request: Request) -> Response:
        return Response.json({
            "service": "audio-rag-tpu",
            "docs": "/api/v1",
            "health": "/health/ready",
        })

    if config.inline_worker and rag is not None:
        _start_inline_worker(app, queue, rag)
    return app


_MIME = {
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript",
    ".css": "text/css",
    ".svg": "image/svg+xml",
    ".png": "image/png",
}


def _register_frontend(app: App) -> None:
    """Serve the dependency-free web UI (``frontend/``) at ``/``."""
    root = pathlib.Path(__file__).resolve().parents[2] / "frontend"
    if not root.is_dir():
        @app.get("/")
        async def no_ui(request: Request) -> Response:
            return Response.json({"service": "audio-rag-tpu",
                                  "docs": "/api/v1"})
        return

    async def serve_file(request: Request) -> Response:
        name = request.path_params.get("name") or "index.html"
        target = (root / name).resolve()
        # containment in the directory itself (a prefix check would also
        # admit a sibling such as frontend-x)
        if not target.is_relative_to(root) or not target.is_file():
            raise HTTPError(404, "not found")
        return Response(
            target.read_bytes(),
            content_type=_MIME.get(target.suffix, "application/octet-stream"),
        )

    app.get("/")(serve_file)
    app.get("/ui/{name}")(serve_file)
    # the top-level asset paths index.html names
    app.get("/app.js")(serve_file_named(serve_file, "app.js"))
    app.get("/styles.css")(serve_file_named(serve_file, "styles.css"))


def serve_file_named(handler, name: str):
    async def inner(request: Request) -> Response:
        request.path_params["name"] = name
        return await handler(request)

    return inner


def _start_inline_worker(app: App, queue: AudioRAGQueue, rag) -> None:
    """Single-node mode: drain jobs on a daemon thread in this process."""
    from audio_rag_tpu_torch.jobqueue.worker import GPUWorker

    worker = GPUWorker(
        queue.config, store=queue.store, rag_factory=lambda: rag
    )
    thread = threading.Thread(
        target=worker.start, name="inline-worker", daemon=True
    )
    thread.start()
    app.state["inline_worker"] = worker

    @app.on_shutdown
    async def stop_worker():
        worker.stop()


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(
        description="audio_rag_tpu_torch API server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--config", default=None, help="AudioRAG config file")
    parser.add_argument("--env", default=None)
    parser.add_argument("--inline-worker", action="store_true")
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO)
    from audio_rag_tpu_torch.config import load_config
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(load_config(args.config, args.env))
    api_cfg = APIConfig.from_env()
    api_cfg.host, api_cfg.port = args.host, args.port
    api_cfg.inline_worker = args.inline_worker
    app = create_app(api_cfg, rag=rag)
    app.run(api_cfg.host, api_cfg.port)
