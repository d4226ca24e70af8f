"""Device-memory budget of the port (counterpart of
``audio_rag_tpu/resources/manager.py``): one process-wide
:class:`ResourceManager` books every loaded backend's estimate
(``hbm_required_gb``) and, when a load would overrun ``max_hbm_gb``,
unloads the least recently used backend that is neither pinned nor the one
being loaded. The public surface and its semantics are the JAX package's:
``register_model``, ``pin`` (which also binds future registrations),
``touch``, ``unregister``, ``used_gb``, ``can_fit``, ``ensure_hbm`` (alias
``ensure_vram``), ``evict_idle``, ``unload_all`` (which goes on past a
failing unload), ``status``, ``eviction_count``, ``pinned_names``.

The budget is the profile's (``resources.max_hbm_gb``), not the card's
memory: on an 80 GB card a 14 GB profile still evicts. ``status()["device"]``
reads the card's own counters (PyTorch's allocated and reserved bytes, the
card's total memory). After an eviction the manager synchronizes the
engine's device before the caller allocates, as the JAX manager does; an
eviction or a sync that fails raises.

``events`` keeps, per load and eviction, its seconds and the change in the
card's allocated bytes (``None`` on the CPU), for the smoke test's swap
figures; it is observability only and no decision reads it.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from audio_rag_tpu_torch.core.exceptions import ResourceError

log = logging.getLogger(__name__)

__all__ = ["ModelInfo", "ResourceManager", "get_resource_manager",
           "set_resource_manager"]


@dataclass
class ModelInfo:
    name: str
    hbm_gb: float
    instance: Any  # object exposing .unload()
    last_used: float = field(default_factory=time.monotonic)
    pinned: bool = False


def _allocated() -> int | None:
    """The card's allocated bytes (current device), None without a card."""
    return torch.cuda.memory_allocated() if torch.cuda.is_available() else None


class ResourceManager:
    """LRU budget over registered backends' device-memory estimates."""

    def __init__(self, max_hbm_gb: float = 14.0):
        self.max_hbm_gb = max_hbm_gb
        self._models: dict[str, ModelInfo] = {}
        self._lock = threading.RLock()
        #: registrations with these names are born pinned (never evicted)
        self.pinned_names: set[str] = set()
        #: evictions performed since the manager was built
        self.eviction_count = 0
        #: {"kind": "load" | "evict", "name", "gb", "seconds",
        #: "allocated_delta"} per load and eviction, in order (an eviction
        #: also has "engine_delta", the change of the engine's bytes)
        self.events: list[dict[str, Any]] = []
        self._load_started: dict[str, tuple[float, int | None]] = {}

    # -- the JAX package's surface ----------------------------------------
    def register_model(self, name: str, hbm_gb: float, instance: Any) -> None:
        with self._lock:
            self._models[name] = ModelInfo(
                name, hbm_gb, instance, pinned=name in self.pinned_names)
            started = self._load_started.pop(name, None)
            if started is not None:
                t0, a0 = started
                a1 = _allocated()
                self.events.append({
                    "kind": "load", "name": name, "gb": hbm_gb,
                    "seconds": time.perf_counter() - t0,
                    "allocated_delta": None if a0 is None else a1 - a0})

    def pin(self, name: str, pinned: bool = True) -> None:
        """Exempt (or re-admit) ``name`` from LRU eviction, now and for
        its future registrations."""
        with self._lock:
            if pinned:
                self.pinned_names.add(name)
            else:
                self.pinned_names.discard(name)
            if name in self._models:
                self._models[name].pinned = pinned

    def touch(self, name: str) -> None:
        with self._lock:
            if name in self._models:
                self._models[name].last_used = time.monotonic()

    def unregister(self, name: str) -> None:
        with self._lock:
            self._models.pop(name, None)

    def used_gb(self) -> float:
        with self._lock:
            return sum(m.hbm_gb for m in self._models.values())

    def can_fit(self, required_gb: float) -> bool:
        return required_gb <= self.max_hbm_gb

    def _evict(self, victim: ModelInfo) -> None:
        """Unload ``victim`` (the lock held) and log the event; its entry
        goes even when the unload raises, and the error propagates."""
        from audio_rag_tpu_torch.engine.engine import peek_engine

        engine = peek_engine()
        e0 = engine.used_bytes() if engine is not None else 0
        a0 = _allocated()
        t0 = time.perf_counter()
        try:
            victim.instance.unload()
        finally:
            self._models.pop(victim.name, None)
        a1 = _allocated()
        self.events.append({
            "kind": "evict", "name": victim.name, "gb": victim.hbm_gb,
            "seconds": time.perf_counter() - t0,
            "allocated_delta": None if a0 is None else a1 - a0,
            # the bytes the engine stopped recording (the victim's)
            "engine_delta": (engine.used_bytes() if engine is not None
                             else 0) - e0})

    def ensure_hbm(self, required_gb: float,
                   for_model: str | None = None) -> None:
        """Evict least-recently-used backends until ``required_gb`` fits;
        raises :class:`ResourceError` when the budget can never hold it or
        only pinned models (and ``for_model``) are left."""
        if required_gb > self.max_hbm_gb:
            raise ResourceError(
                f"model needs {required_gb:.1f} GB but budget is "
                f"{self.max_hbm_gb:.1f} GB",
                context={"required_gb": required_gb,
                         "budget_gb": self.max_hbm_gb})
        with self._lock:
            evicted_any = False
            while self.used_gb() + required_gb > self.max_hbm_gb:
                victims = [m for m in self._models.values()
                           if m.name != for_model and not m.pinned]
                if not victims:
                    raise ResourceError(
                        "cannot free enough HBM (only pinned models "
                        "remain)" if self._models else
                        "cannot free enough HBM",
                        context={"required_gb": required_gb,
                                 "used_gb": self.used_gb(),
                                 "pinned": sorted(self.pinned_names)})
                victim = min(victims, key=lambda m: m.last_used)
                log.info("evicting %s (%.1f GB) to fit %.1f GB",
                         victim.name, victim.hbm_gb, required_gb)
                self.eviction_count += 1
                self._evict(victim)
                evicted_any = True
            if evicted_any:
                # let the card finish with the freed blocks' last readers
                # before the caller fills them
                from audio_rag_tpu_torch.engine.engine import peek_engine

                engine = peek_engine()
                if engine is not None:
                    engine.sync()
            if for_model is not None:
                self._load_started[for_model] = (time.perf_counter(),
                                                 _allocated())

    ensure_vram = ensure_hbm

    def evict_idle(self, max_idle_s: float) -> list[str]:
        """Unload the unpinned models unused for more than ``max_idle_s``
        seconds."""
        if max_idle_s <= 0:
            return []
        now = time.monotonic()
        evicted: list[str] = []
        with self._lock:
            for m in list(self._models.values()):
                if m.pinned or now - m.last_used <= max_idle_s:
                    continue
                log.info("idle-evicting %s (%.0fs idle)",
                         m.name, now - m.last_used)
                try:
                    self._evict(m)
                finally:
                    evicted.append(m.name)
        return evicted

    def unload_all(self) -> None:
        with self._lock:
            for m in list(self._models.values()):
                try:
                    m.instance.unload()
                except Exception as exc:  # keep unloading the rest
                    log.warning("unload of %s failed: %s", m.name, exc)
            self._models.clear()

    def status(self) -> dict[str, Any]:
        with self._lock:
            info: dict[str, Any] = {
                "budget_gb": self.max_hbm_gb,
                "used_gb": round(self.used_gb(), 3),
                "models": {m.name: {"gb": m.hbm_gb, "pinned": m.pinned}
                           for m in self._models.values()},
                "evictions": self.eviction_count,
            }
        if torch.cuda.is_available():
            info["device"] = {
                "bytes_in_use": torch.cuda.memory_allocated(),
                "bytes_reserved": torch.cuda.memory_reserved(),
                "bytes_limit": torch.cuda.get_device_properties(
                    torch.cuda.current_device()).total_memory,
            }
        return info


_lock = threading.Lock()
_manager: ResourceManager | None = None


def get_resource_manager(max_hbm_gb: float | None = None) -> ResourceManager:
    """The process-wide manager, built at the first call (budget
    ``max_hbm_gb`` or 14 GB); a later ``max_hbm_gb`` resets its budget."""
    global _manager
    with _lock:
        if _manager is None:
            _manager = ResourceManager(max_hbm_gb or 14.0)
        elif max_hbm_gb is not None:
            _manager.max_hbm_gb = max_hbm_gb
        return _manager


def set_resource_manager(manager: ResourceManager | None) -> None:
    global _manager
    with _lock:
        _manager = manager
