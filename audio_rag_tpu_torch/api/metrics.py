"""Prometheus-style metrics: an in-process registry and ``GET /metrics``
(counterpart of ``audio_rag_tpu/api/metrics.py``), the text exposition
format 0.0.4 over the stats the port already keeps:

* per-route request counts and latency (fed by a middleware; the labels
  carry the ROUTE TEMPLATE, e.g. ``/api/v1/jobs/{job_id}``, so their
  cardinality is the route table's, not the job ids');
* job-queue depths per priority and counts per state, live workers;
* the device-memory manager's budget, bookings and evictions;
* the engine's booked device memory (the engine of the app's pipeline
  device);
* the pipeline's ``@timed`` stage aggregates.

Departures: no ``audio_rag_compiled_programs`` gauge (the port's engine
keeps no compiled programs), and a gauge whose source fails is logged as
a warning and left out (the JAX module drops it silently).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

from audio_rag_tpu_torch.api.http import App, Request, Response

log = logging.getLogger(__name__)

__all__ = ["Metrics", "get_metrics", "register_metrics_route",
           "metrics_middleware"]

_ESCAPE = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).translate(_ESCAPE)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Metrics:
    """Counters and sum/count summaries with label sets (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, dict[tuple, float]] = defaultdict(dict)
        self._help: dict[str, str] = {}
        self.started_at = time.time()

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    def inc(self, name: str, labels: dict[str, str] | None = None,
            value: float = 1.0) -> None:
        key = tuple(sorted((labels or {}).items()))
        with self._lock:
            cur = self._counters[name].get(key, 0.0)
            self._counters[name][key] = cur + value

    def observe(self, name: str, value: float,
                labels: dict[str, str] | None = None) -> None:
        """Summary: maintains ``name_count`` and ``name_sum`` series."""
        self.inc(name + "_count", labels, 1.0)
        self.inc(name + "_sum", labels, value)

    def render(self, extra_gauges: list[tuple[str, dict, float]] = ()) -> str:
        lines: list[str] = []
        with self._lock:
            snapshot = {
                n: dict(series) for n, series in self._counters.items()
            }
        for name in sorted(snapshot):
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
                lines.append(f"# TYPE {name} counter")
            for key, val in sorted(snapshot[name].items()):
                lines.append(f"{name}{_fmt_labels(dict(key))} {val:g}")
        for name, labels, val in extra_gauges:
            lines.append(f"{name}{_fmt_labels(labels)} {val:g}")
        lines.append(
            f"audio_rag_uptime_seconds {time.time() - self.started_at:g}")
        return "\n".join(lines) + "\n"


_metrics = Metrics()
_metrics.describe("audio_rag_requests_total",
                  "HTTP requests by route template, method and status")
_metrics.describe("audio_rag_request_seconds_sum",
                  "Cumulative request latency (seconds) by route")


def get_metrics() -> Metrics:
    return _metrics


def metrics_middleware(app: App) -> None:
    """Install the request counter and latency middleware."""

    @app.middleware
    async def _record(request: Request, call_next):
        t0 = time.perf_counter()
        response = await call_next(request)
        route = request.context.get("route", "<unmatched>")
        labels = {"route": route, "method": request.method,
                  "status": str(response.status)}
        _metrics.inc("audio_rag_requests_total", labels)
        _metrics.observe("audio_rag_request_seconds",
                         time.perf_counter() - t0,
                         {"route": route, "method": request.method})
        return response


def _queue_gauges(app: App, out: list) -> None:
    queue = app.state.get("queue")
    if queue is None:
        return
    stats = queue.get_queue_stats()
    for qname, q in (stats.get("queues") or {}).items():
        out.append(("audio_rag_queue_depth", {"queue": str(qname)},
                    float(q.get("depth", 0))))
        for state in ("queued", "running", "completed", "failed",
                      "cancelled"):
            if state in q:
                out.append(("audio_rag_jobs",
                            {"queue": str(qname), "state": state},
                            float(q[state])))
    out.append(("audio_rag_workers_live", {},
                float(len(stats.get("workers") or []))))


def _resource_gauges(app: App, out: list) -> None:
    from audio_rag_tpu_torch.resources.manager import get_resource_manager

    st = get_resource_manager().status()
    out.append(("audio_rag_hbm_used_gb", {}, float(st.get("used_gb", 0.0))))
    out.append(("audio_rag_hbm_budget_gb", {},
                float(st.get("budget_gb", 0.0))))
    out.append(("audio_rag_models_resident", {},
                float(len(st.get("models") or {}))))
    out.append(("audio_rag_model_evictions_total", {},
                float(st.get("evictions", 0))))


def _engine_gauges(app: App, out: list) -> None:
    from audio_rag_tpu_torch.engine.engine import get_engine

    rag = app.state.get("rag")
    if rag is None:
        return
    st = get_engine(rag.device).status()
    out.append(("audio_rag_engine_hbm_gb", {},
                float(st.get("hbm_used_gb", 0.0))))


def _stage_gauges(app: App, out: list) -> None:
    from audio_rag_tpu_torch.utils.decorators import get_stage_timings

    for stage, agg in get_stage_timings().items():
        out.append(("audio_rag_stage_seconds_sum",
                    {"stage": stage}, float(agg.get("total_s", 0.0))))
        out.append(("audio_rag_stage_calls",
                    {"stage": stage}, float(agg.get("count", 0))))


_GAUGES = (("queue", _queue_gauges), ("resources", _resource_gauges),
           ("engine", _engine_gauges), ("stage", _stage_gauges))


def _gauges(app: App) -> list[tuple[str, dict, float]]:
    """Point-in-time gauges from the live subsystems; a failing source is
    logged and its gauges left out."""
    out: list[tuple[str, dict, float]] = []
    for name, add in _GAUGES:
        part: list[tuple[str, dict, float]] = []
        try:
            add(app, part)
        except Exception as exc:  # the other gauges still render
            log.warning("metrics: the %s gauges failed: %r", name, exc,
                        exc_info=True)
            continue
        out.extend(part)
    return out


def register_metrics_route(app: App) -> None:
    metrics_middleware(app)

    @app.get("/metrics")
    async def metrics(request: Request) -> Response:
        config = app.state.get("config")
        if config is not None and getattr(
                config, "metrics_require_auth", False):
            from audio_rag_tpu_torch.api.deps import authenticate

            authenticate(request, config)
        body = _metrics.render(_gauges(app)).encode()
        return Response(body, 200, headers={
            "content-type": "text/plain; version=0.0.4; charset=utf-8",
        })
