"""Stage timing (counterpart of ``audio_rag_tpu/utils/decorators.py``'s
``timed``): each call of a decorated function adds its wall time to a
process-wide registry under a lock, keyed by the function's
``__qualname__`` (``IngestionPipeline.ingest``, ``WhisperASR.transcribe``,
...); ``AudioRAG.status()`` reports it."""

from __future__ import annotations

import functools
import logging
import threading
import time
from collections import defaultdict
from typing import Any, Callable, TypeVar

T = TypeVar("T")
log = logging.getLogger(__name__)

__all__ = ["timed", "get_stage_timings", "reset_stage_timings"]

_timings_lock = threading.Lock()
_timings: dict[str, list[float]] = defaultdict(list)


def get_stage_timings() -> dict[str, dict[str, float]]:
    """Per function: calls, total, mean and last wall seconds."""
    with _timings_lock:
        return {name: {"count": len(samples), "total_s": sum(samples),
                       "mean_s": sum(samples) / len(samples),
                       "last_s": samples[-1]}
                for name, samples in _timings.items()}


def reset_stage_timings() -> None:
    with _timings_lock:
        _timings.clear()


def timed(fn: Callable[..., T]) -> Callable[..., T]:
    """Record the wall time of each call of ``fn`` (raising ones too)."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> T:
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            with _timings_lock:
                _timings[fn.__qualname__].append(dt)
            log.debug("%s took %.3fs", fn.__qualname__, dt)

    return wrapper
