"""Job domain model for asynchronous ingestion (the port's copy of
``audio_rag_tpu/jobqueue/job.py``): ``Priority`` (LOW..CRITICAL),
``JobStatus`` (6 states), ``JobStage`` (9 stages) with ``STAGE_ORDER`` for
resume and progress, ``IngestJob`` with an idempotency key derived from
the tenant and a hash of the audio's first 1 MB, ``JobResult``,
``JobCheckpoint``, and their JSON forms, which both packages read and
write alike.
"""

from __future__ import annotations

import enum
import hashlib
import json
import time
import uuid
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any

__all__ = [
    "Priority",
    "JobStatus",
    "JobStage",
    "STAGE_ORDER",
    "get_next_stage",
    "IngestJob",
    "JobResult",
    "JobCheckpoint",
]


class Priority(int, enum.Enum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3

    @classmethod
    def from_name(cls, name: str) -> "Priority":
        return cls[name.upper()]


class JobStatus(str, enum.Enum):
    PENDING = "pending"
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"

    @property
    def is_terminal(self) -> bool:
        return self in (
            JobStatus.COMPLETED, JobStatus.FAILED, JobStatus.CANCELLED
        )


class JobStage(str, enum.Enum):
    VALIDATING = "validating"
    TRANSCRIBING = "transcribing"
    DIARIZING = "diarizing"
    ALIGNING = "aligning"
    CHUNKING = "chunking"
    CONTEXTUALIZING = "contextualizing"
    EMBEDDING = "embedding"
    INDEXING = "indexing"
    FINALIZING = "finalizing"


STAGE_ORDER: list[JobStage] = [
    JobStage.VALIDATING,
    JobStage.TRANSCRIBING,
    JobStage.DIARIZING,
    JobStage.ALIGNING,
    JobStage.CHUNKING,
    JobStage.CONTEXTUALIZING,
    JobStage.EMBEDDING,
    JobStage.INDEXING,
    JobStage.FINALIZING,
]


def get_next_stage(stage: JobStage) -> JobStage | None:
    i = STAGE_ORDER.index(stage)
    return STAGE_ORDER[i + 1] if i + 1 < len(STAGE_ORDER) else None


def _content_fingerprint(path: str | Path, max_bytes: int = 1 << 20) -> str:
    """sha256 of the first ``max_bytes`` of the file (of its path when it
    cannot be read)."""
    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            h.update(f.read(max_bytes))
    except OSError:
        h.update(str(path).encode())
    return h.hexdigest()


@dataclass
class IngestJob:
    tenant_id: str
    audio_path: str
    job_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    priority: Priority = Priority.NORMAL
    collection: str | None = None
    metadata: dict[str, Any] = field(default_factory=dict)
    config_overrides: dict[str, Any] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    idempotency_key: str | None = None

    def __post_init__(self) -> None:
        if isinstance(self.priority, str):
            self.priority = Priority.from_name(self.priority)
        elif isinstance(self.priority, int) and not isinstance(
            self.priority, Priority
        ):
            self.priority = Priority(self.priority)
        if self.idempotency_key is None:
            self.idempotency_key = (
                f"{self.tenant_id}:{_content_fingerprint(self.audio_path)}"
            )

    def to_json(self) -> str:
        d = asdict(self)
        d["priority"] = self.priority.name
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "IngestJob":
        d = json.loads(raw)
        d["priority"] = Priority.from_name(d["priority"])
        return cls(**d)


@dataclass
class JobResult:
    job_id: str
    status: JobStatus
    collection: str | None = None
    num_chunks: int = 0
    num_segments: int = 0
    num_speakers: int = 0
    duration_s: float = 0.0
    elapsed_s: float = 0.0
    error: str | None = None
    metrics: dict[str, Any] = field(default_factory=dict)
    completed_at: float = field(default_factory=time.time)

    def to_json(self) -> str:
        d = asdict(self)
        d["status"] = self.status.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "JobResult":
        d = json.loads(raw)
        d["status"] = JobStatus(d["status"])
        return cls(**d)


@dataclass
class JobCheckpoint:
    """Per-stage resumable state: the worker persists one after every
    completed stage and resumes from it."""

    job_id: str
    stage: JobStage
    data: dict[str, Any] = field(default_factory=dict)
    updated_at: float = field(default_factory=time.time)

    def to_json(self) -> str:
        d = asdict(self)
        d["stage"] = self.stage.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "JobCheckpoint":
        d = json.loads(raw)
        d["stage"] = JobStage(d["stage"])
        return cls(**d)


def calculate_progress(stage: JobStage | str | None) -> float:
    """Stage → fraction complete."""
    if stage is None:
        return 0.0
    if isinstance(stage, str):
        try:
            stage = JobStage(stage)
        except ValueError:
            return 0.0
    return round((STAGE_ORDER.index(stage) + 1) / len(STAGE_ORDER), 3)
