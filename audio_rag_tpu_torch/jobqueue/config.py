"""Queue configuration (counterpart of ``audio_rag_tpu/jobqueue/config.py``):
the per-priority queues (timeout, max depth), the worker (heartbeats,
preload, batch claims), the SQLite storage and its TTLs, as dataclasses
with the JAX models' fields, defaults and bounds. Construction checks the
bounds and raises ``ConfigError``; :meth:`QueueConfig.from_dict` builds the
tree from a mapping such as ``configs/queue.yaml`` read by the port's YAML
reader (:func:`load_queue_config`), dropping undeclared keys and coercing
values as pydantic does. ``WorkerConfig.max_hbm_gb`` is held and
read by nothing, as in the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any

from audio_rag_tpu_torch.config.loader import _coerce
from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = ["QueueDefinition", "WorkerConfig", "StorageConfig", "QueueConfig",
           "load_queue_config"]


def _check(cfg, bounds: dict[str, tuple[float | None, float | None, bool]]
           ) -> None:
    """``bounds``: field → (lower, upper, lower is strict)."""
    for name, (lo, hi, strict) in bounds.items():
        v = getattr(cfg, name)
        if (lo is not None and (v <= lo if strict else v < lo)) or (
                hi is not None and v > hi):
            raise ConfigError(
                f"{type(cfg).__name__}.{name} = {v!r} is out of bounds "
                f"({'>' if strict else '≥'} {lo}"
                + (f", ≤ {hi})" if hi is not None else ")"),
                context={"field": name, "value": v})


def _build(cls, data: Any, path: str):
    """``cls`` from a mapping: undeclared keys dropped and values coerced
    as pydantic does (the port's config loader's rules)."""
    if not isinstance(data, Mapping):
        raise ConfigError(f"{path} must be a mapping; got {data!r}",
                          context={"field": path})
    known = {f.name: f.type for f in fields(cls)}
    return cls(**{k: _coerce(f"{path}.{k}", known[k], v)
                  for k, v in data.items() if k in known})


@dataclass
class QueueDefinition:
    name: str
    timeout_s: int = 1800
    max_depth: int = 100

    def __post_init__(self) -> None:
        _check(self, {"timeout_s": (1, None, False),
                      "max_depth": (1, None, False)})


@dataclass
class WorkerConfig:
    max_hbm_gb: float = 10.0
    heartbeat_interval_s: int = 30
    heartbeat_ttl_s: int = 300
    preload_models: bool = True
    poll_interval_s: float = 0.5
    #: claim up to this many compatible queued jobs at once and ingest
    #: them stage-grouped (``ingest_batch``): the ASR↔LLM swap of the
    #: contextual stage is paid once per claimed batch. At > 1 progress
    #: and checkpoints coarsen to the batch (a crash requeues the whole
    #: batch from scratch) and cancellation is observed between batches
    batch_claim: int = 1

    def __post_init__(self) -> None:
        _check(self, {"max_hbm_gb": (1.0, None, False),
                      "heartbeat_interval_s": (1, None, False),
                      "heartbeat_ttl_s": (1, None, False),
                      "poll_interval_s": (0, None, True),
                      "batch_claim": (1, 16, False)})


@dataclass
class StorageConfig:
    #: SQLite database path; ":memory:" for tests
    db_path: str = "./data/queue.db"
    idempotency_ttl_s: int = 86400
    result_ttl_s: int = 86400
    checkpoint_ttl_s: int = 86400

    def __post_init__(self) -> None:
        _check(self, {name: (1, None, False) for name in (
            "idempotency_ttl_s", "result_ttl_s", "checkpoint_ttl_s")})


def _default_queues() -> list[QueueDefinition]:
    return [QueueDefinition(name="high", timeout_s=3600, max_depth=50),
            QueueDefinition(name="normal", timeout_s=1800, max_depth=100),
            QueueDefinition(name="low", timeout_s=3600, max_depth=200)]


@dataclass
class QueueConfig:
    queues: list[QueueDefinition] = field(default_factory=_default_queues)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any] | None) -> "QueueConfig":
        """The tree from a mapping (each section optional; undeclared keys
        dropped, values coerced), as the JAX package's
        ``QueueConfig(**mapping)``."""
        data = data or {}
        kw: dict[str, Any] = {}
        if "queues" in data:
            if not isinstance(data["queues"], (list, tuple)):
                raise ConfigError("queues must be a list of mappings",
                                  context={"field": "queues"})
            kw["queues"] = [_build(QueueDefinition, q, f"queues.{i}")
                            for i, q in enumerate(data["queues"])]
        for name, sub in (("worker", WorkerConfig),
                          ("storage", StorageConfig)):
            if name in data:
                kw[name] = _build(sub, data[name], name)
        return cls(**kw)

    def queue_for_priority(self, priority_name: str) -> QueueDefinition:
        mapping = {"CRITICAL": "high", "HIGH": "high",
                   "NORMAL": "normal", "LOW": "low"}
        name = mapping.get(priority_name.upper(), "normal")
        for q in self.queues:
            if q.name == name:
                return q
        return self.queues[0]


def load_queue_config(path: str | Path) -> QueueConfig:
    """A queue YAML file (``configs/queue.yaml``) through the port's YAML
    reader."""
    from audio_rag_tpu_torch.config._yaml import read_yaml

    return QueueConfig.from_dict(read_yaml(path))
