"""The port's engine ledger (counterpart of the parameter-hosting half of
``audio_rag_tpu/engine/engine.py``): one process-wide
:class:`InferenceEngine` on one device records each loaded backend's
tensors and their bytes (``put_params``), hands them back
(``get_params``), forgets them when the backend unloads (``drop_params``)
and reports the device and each model's GB (``status``). The port's
backends draw or load their weights on their device already, so
``put_params`` records them as they are.

Not ported: the JAX engine's compiled-program cache (``program``,
``drop_programs``); eager PyTorch has no jitted programs to keep.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

import torch

from audio_rag_tpu_torch.device import resolve_device

__all__ = ["InferenceEngine", "bf16_storage", "get_engine", "peek_engine",
           "set_engine"]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _tree_bytes(tree: Any) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples (a
    tensor reached twice counts once)."""
    seen: set[int] = set()
    total = 0
    for x in _leaves(tree):
        if id(x) not in seen:
            seen.add(id(x))
            total += x.numel() * x.element_size()
    return total


def bf16_storage(params: Any) -> Any:
    """A state's f32 tensors cast to bf16 (other tensors as they are)."""
    return _map(lambda x: x.to(torch.bfloat16)
                if x.dtype == torch.float32 else x, params)


@dataclass
class _ModelEntry:
    params: Any
    bytes: int


@dataclass
class InferenceEngine:
    """One device and the tensors of the models loaded on it."""

    device: torch.device = field(
        default_factory=lambda: torch.device("cuda"))
    models: dict[str, _ModelEntry] = field(default_factory=dict)
    _lock: threading.RLock = field(default_factory=threading.RLock)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def put_params(self, name: str, state: Any) -> Any:
        """Record ``state`` under ``name`` with its bytes; returns it."""
        with self._lock:
            self.models[name] = _ModelEntry(state, _tree_bytes(state))
        return state

    def get_params(self, name: str) -> Any:
        return self.models[name].params

    def drop_params(self, name: str) -> None:
        """Forget ``name``'s tensors (the engine's reference is the last
        one it holds)."""
        with self._lock:
            self.models.pop(name, None)

    def used_bytes(self) -> int:
        with self._lock:
            return sum(m.bytes for m in self.models.values())

    def hbm_used_gb(self) -> float:
        return self.used_bytes() / 1e9

    def sync(self) -> None:
        """Wait for the card's queued work, so that memory an eviction
        freed is no longer read when the caller fills it."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def status(self) -> dict[str, Any]:
        dev = self.device
        cuda = dev.type == "cuda"
        with self._lock:
            models = {n: {"gb": round(m.bytes / 1e9, 3)}
                      for n, m in self.models.items()}
        return {
            "device": {
                "type": dev.type,
                "name": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": torch.cuda.device_count() if cuda else 1,
            },
            "models": models,
            "hbm_used_gb": round(self.hbm_used_gb(), 3),
        }


_engine_lock = threading.Lock()
_engine: InferenceEngine | None = None


def get_engine(device: str | torch.device | None = None) -> InferenceEngine:
    """The process-wide engine, built at the first call on ``device``
    (default "cuda", which raises without a card)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = InferenceEngine(torch.device(device or "cuda"))
        return _engine


def peek_engine() -> InferenceEngine | None:
    """The process-wide engine if one was built, else None."""
    return _engine


def set_engine(engine: InferenceEngine | None) -> None:
    global _engine
    with _engine_lock:
        _engine = engine
