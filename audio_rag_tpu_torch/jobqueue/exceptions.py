"""Queue error taxonomy of the port (counterpart of
``audio_rag_tpu/jobqueue/exceptions.py``): the same classes, each with a
``recoverable`` flag and a structured context (queue depth, job ids,
reasons), rooted in the port's ``AudioRAGError``.
"""

from __future__ import annotations

from typing import Any

from audio_rag_tpu_torch.core.exceptions import AudioRAGError

__all__ = [
    "QueueError",
    "QueueConnectionError",
    "QueueFullError",
    "DuplicateJobError",
    "JobNotFoundError",
    "JobAlreadyTerminalError",
    "JobTimeoutError",
    "JobCancelledError",
    "ValidationError",
    "InvalidAudioError",
    "InvalidTenantError",
    "WorkerError",
    "WorkerShutdownError",
    "CheckpointError",
]


class QueueError(AudioRAGError):
    """Base queue error."""

    recoverable: bool = False

    def __init__(self, message: str, *, recoverable: bool | None = None,
                 context: dict[str, Any] | None = None):
        super().__init__(message, context=context)
        if recoverable is not None:
            self.recoverable = recoverable

    def to_dict(self) -> dict[str, Any]:
        d = super().to_dict()
        d["recoverable"] = self.recoverable
        return d


class QueueConnectionError(QueueError):
    recoverable = True


class QueueFullError(QueueError):
    recoverable = True

    def __init__(self, queue_name: str, depth: int, max_depth: int):
        super().__init__(
            f"queue {queue_name!r} is full ({depth}/{max_depth})",
            context={"queue": queue_name, "depth": depth,
                     "max_depth": max_depth},
        )


class DuplicateJobError(QueueError):
    recoverable = False

    def __init__(self, idempotency_key: str, existing_job_id: str):
        super().__init__(
            f"duplicate job (idempotency key {idempotency_key[:16]}…); "
            f"existing job {existing_job_id}",
            context={"idempotency_key": idempotency_key,
                     "existing_job_id": existing_job_id},
        )
        self.existing_job_id = existing_job_id


class JobNotFoundError(QueueError):
    recoverable = False

    def __init__(self, job_id: str):
        super().__init__(f"job {job_id} not found",
                         context={"job_id": job_id})


class JobAlreadyTerminalError(QueueError):
    recoverable = False

    def __init__(self, job_id: str, status: str):
        super().__init__(
            f"job {job_id} already {status}",
            context={"job_id": job_id, "status": status},
        )


class JobTimeoutError(QueueError):
    recoverable = True


class JobCancelledError(QueueError):
    recoverable = False


class ValidationError(QueueError):
    recoverable = False


class InvalidAudioError(ValidationError):
    def __init__(self, reason: str, path: str | None = None):
        super().__init__(f"invalid audio: {reason}",
                         context={"reason": reason, "path": path})


class InvalidTenantError(ValidationError):
    def __init__(self, tenant_id: str, reason: str):
        super().__init__(
            f"invalid tenant id {tenant_id!r}: {reason}",
            context={"tenant_id": tenant_id, "reason": reason},
        )


class WorkerError(QueueError):
    recoverable = True


class WorkerShutdownError(WorkerError):
    recoverable = True


class CheckpointError(QueueError):
    recoverable = True
