"""AudioRAGQueue, the enqueue side (counterpart of
``audio_rag_tpu/jobqueue/queue.py``): enqueue = validate → idempotency
check → depth check → persist the job; plus ``get_status`` (with
stage-derived progress), ``get_result``, ``cancel`` and
``get_queue_stats``. Workers poll the SQLite store's atomic claim.
"""

from __future__ import annotations

import logging
from typing import Any

from audio_rag_tpu_torch.jobqueue.config import QueueConfig
from audio_rag_tpu_torch.jobqueue.exceptions import (
    DuplicateJobError,
    JobAlreadyTerminalError,
    JobNotFoundError,
    QueueFullError,
)
from audio_rag_tpu_torch.jobqueue.job import (
    IngestJob,
    JobResult,
    JobStatus,
    calculate_progress,
)
from audio_rag_tpu_torch.jobqueue.store import JobStore
from audio_rag_tpu_torch.jobqueue.validation import JobValidator

log = logging.getLogger(__name__)

__all__ = ["AudioRAGQueue"]


class AudioRAGQueue:
    def __init__(
        self,
        config: QueueConfig | None = None,
        store: JobStore | None = None,
        validator: JobValidator | None = None,
    ):
        self.config = config or QueueConfig()
        self.store = store or JobStore(self.config.storage.db_path)
        self.validator = validator or JobValidator()

    # -- enqueue -----------------------------------------------------------
    def enqueue(self, job: IngestJob, validate: bool = True) -> str:
        """Queue a job; returns its id. Raises DuplicateJobError /
        QueueFullError / validation errors."""
        if validate:
            self.validator.validate(job)

        existing = self.store.check_idempotency(job.idempotency_key)
        if existing is not None:
            raise DuplicateJobError(job.idempotency_key, existing)

        qdef = self.config.queue_for_priority(job.priority.name)
        depth = self.store.queue_depth(qdef.name)
        if depth >= qdef.max_depth:
            raise QueueFullError(qdef.name, depth, qdef.max_depth)

        self.store.insert_job(job, qdef.name)
        self.store.put_idempotency(
            job.idempotency_key, job.job_id,
            self.config.storage.idempotency_ttl_s,
        )
        log.info("enqueued job %s (tenant=%s queue=%s depth=%d)",
                 job.job_id, job.tenant_id, qdef.name, depth + 1)
        return job.job_id

    # -- status / results --------------------------------------------------
    def get_status(self, job_id: str) -> dict[str, Any]:
        row = self.store.get_job_row(job_id)
        if row is None:
            raise JobNotFoundError(job_id)
        return {
            "job_id": job_id,
            "status": row["status"],
            "stage": row["stage"],
            "progress": calculate_progress(row["stage"])
            if row["status"] not in (JobStatus.COMPLETED.value,)
            else 1.0,
            "queue": row["queue"],
            "error": row["error"],
            "created_at": row["created_at"],
            "updated_at": row["updated_at"],
        }

    def get_result(self, job_id: str) -> JobResult | None:
        return self.store.get_result(job_id)

    def cancel(self, job_id: str) -> bool:
        row = self.store.get_job_row(job_id)
        if row is None:
            raise JobNotFoundError(job_id)
        status = JobStatus(row["status"])
        if status.is_terminal:
            raise JobAlreadyTerminalError(job_id, status.value)
        # running jobs finish their current stage; the worker observes the
        # cancelled status at its next checkpoint boundary
        self.store.set_status(job_id, JobStatus.CANCELLED)
        return True

    # -- stats -------------------------------------------------------------
    def get_queue_stats(self) -> dict[str, Any]:
        per_queue = self.store.stats()
        out: dict[str, Any] = {"queues": {}}
        for qdef in self.config.queues:
            counts = per_queue.get(qdef.name, {})
            depth = counts.get("queued", 0) + counts.get("running", 0)
            out["queues"][qdef.name] = {
                **counts,
                "depth": depth,
                "max_depth": qdef.max_depth,
                "utilization": round(depth / qdef.max_depth, 3),
            }
        out["workers"] = self.store.live_workers(
            self.config.worker.heartbeat_ttl_s
        )
        return out

    def health(self) -> bool:
        return self.store.health()
