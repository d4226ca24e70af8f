"""Stage spans and device profiling (counterpart of
``audio_rag_tpu/utils/tracing.py``).

``span(name)`` times a pipeline stage into a process-wide table (count,
total, mean and max seconds); spans nest per thread (each thread keeps its
own stack: the streaming mux and the schedulers run on their own workers),
and a span opened inside another is aggregated under it. Each span also
wraps its stage in ``torch.profiler.record_function(name)``, so a trace
taken with :func:`start_profile` attributes the card's kernels to the
stage that launched them. :func:`get_trace_summary` feeds
``AudioRAG.status()``.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import torch

log = logging.getLogger(__name__)

__all__ = ["span", "get_trace_summary", "reset_traces", "start_profile",
           "stop_profile"]


@dataclass
class _SpanStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    children: dict[str, "_SpanStats"] = field(default_factory=dict)


_lock = threading.Lock()
_stats: dict[str, _SpanStats] = {}
_active = threading.local()
_profiler = None
_profile_dir: Path | None = None


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named, nested, aggregated timing span over the ``with`` body."""
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    parent = stack[-1] if stack else None
    with _lock:
        table = parent.children if parent is not None else _stats
        st = table.setdefault(name, _SpanStats())
    stack.append(st)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _lock:
            st.count += 1
            st.total_s += dt
            st.max_s = max(st.max_s, dt)


def _to_dict(table: dict[str, _SpanStats]) -> dict[str, Any]:
    return {
        name: {
            "count": s.count,
            "total_s": round(s.total_s, 4),
            "mean_s": round(s.total_s / max(s.count, 1), 4),
            "max_s": round(s.max_s, 4),
            **({"children": _to_dict(s.children)} if s.children else {}),
        }
        for name, s in table.items()
    }


def get_trace_summary() -> dict[str, Any]:
    with _lock:
        return _to_dict(_stats)


def reset_traces() -> None:
    with _lock:
        _stats.clear()


def start_profile(log_dir: str | Path) -> bool:
    """Start a ``torch.profiler`` trace of the host and the card (when
    there is one); :func:`stop_profile` writes it to ``log_dir`` as a
    Chrome trace. False when a trace is already running."""
    global _profiler, _profile_dir
    if _profiler is not None:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _profiler, _profile_dir = prof, Path(log_dir)
    log.info("profiling started -> %s", log_dir)
    return True


def stop_profile() -> Path | None:
    """Stop the trace and write ``trace.json`` into the directory given to
    :func:`start_profile`; None when no trace was running."""
    global _profiler, _profile_dir
    if _profiler is None:
        return None
    prof, out_dir = _profiler, _profile_dir
    _profiler = _profile_dir = None
    prof.__exit__(None, None, None)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path
