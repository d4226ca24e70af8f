"""SQLite job store of the port (counterpart of
``audio_rag_tpu/jobqueue/store.py``, the same schema and SQL): one
WAL-mode SQLite database (on a file) holds the jobs with an atomic claim
of the next job by priority then age, TTL'd idempotency keys, results,
per-stage checkpoints, worker heartbeats, and a sliding-window rate-limit
event log for an API layer. One connection, shared across threads under a
lock.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any

from audio_rag_tpu_torch.jobqueue.job import (
    IngestJob,
    JobCheckpoint,
    JobResult,
    JobStage,
    JobStatus,
)

__all__ = ["JobStore"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    tenant_id TEXT NOT NULL,
    queue TEXT NOT NULL,
    priority INTEGER NOT NULL,
    status TEXT NOT NULL,
    stage TEXT,
    data TEXT NOT NULL,
    error TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    claimed_by TEXT
);
CREATE INDEX IF NOT EXISTS idx_jobs_claim
    ON jobs (status, queue, priority DESC, created_at);
CREATE TABLE IF NOT EXISTS results (
    job_id TEXT PRIMARY KEY,
    data TEXT NOT NULL,
    expires_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS checkpoints (
    job_id TEXT PRIMARY KEY,
    data TEXT NOT NULL,
    expires_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS idempotency (
    key TEXT PRIMARY KEY,
    job_id TEXT NOT NULL,
    expires_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS workers (
    worker_id TEXT PRIMARY KEY,
    info TEXT NOT NULL,
    last_heartbeat REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS rate_events (
    key TEXT NOT NULL,
    ts REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_rate ON rate_events (key, ts);
"""


class JobStore:
    def __init__(self, db_path: str = ":memory:"):
        self.db_path = db_path
        if db_path != ":memory:":
            Path(db_path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(
            db_path, check_same_thread=False, timeout=30.0
        )
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            if db_path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- jobs --------------------------------------------------------------
    def insert_job(self, job: IngestJob, queue: str) -> None:
        now = time.time()
        with self._lock:
            self._conn.execute(
                "INSERT INTO jobs (job_id, tenant_id, queue, priority, status,"
                " stage, data, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?)",
                (job.job_id, job.tenant_id, queue, int(job.priority),
                 JobStatus.QUEUED.value, None, job.to_json(), now, now),
            )
            self._conn.commit()

    def claim_next(self, worker_id: str,
                   queues: list[str] | None = None) -> IngestJob | None:
        """Atomically claim the highest-priority oldest queued job."""
        with self._lock:
            q = "SELECT job_id, data FROM jobs WHERE status = ?"
            args: list[Any] = [JobStatus.QUEUED.value]
            if queues:
                q += f" AND queue IN ({','.join('?' * len(queues))})"
                args.extend(queues)
            q += " ORDER BY priority DESC, created_at ASC LIMIT 1"
            row = self._conn.execute(q, args).fetchone()
            if row is None:
                return None
            cur = self._conn.execute(
                "UPDATE jobs SET status = ?, claimed_by = ?, updated_at = ?"
                " WHERE job_id = ? AND status = ?",
                (JobStatus.RUNNING.value, worker_id, time.time(),
                 row["job_id"], JobStatus.QUEUED.value),
            )
            self._conn.commit()
            if cur.rowcount != 1:
                return None  # raced; caller retries
            return IngestJob.from_json(row["data"])

    def set_status(
        self, job_id: str, status: JobStatus,
        stage: JobStage | None = None, error: str | None = None,
    ) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET status = ?, stage = COALESCE(?, stage),"
                " error = COALESCE(?, error), updated_at = ? WHERE job_id = ?",
                (status.value, stage.value if stage else None, error,
                 time.time(), job_id),
            )
            self._conn.commit()

    def set_stage(self, job_id: str, stage: JobStage) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE jobs SET stage = ?, updated_at = ? WHERE job_id = ?",
                (stage.value, time.time(), job_id),
            )
            self._conn.commit()

    def get_job_row(self, job_id: str) -> dict[str, Any] | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
        return dict(row) if row else None

    def list_jobs(
        self,
        tenant_id: str | None = None,
        status: str | None = None,
        limit: int = 50,
        offset: int = 0,
    ) -> tuple[list[dict[str, Any]], int]:
        """Paginated job listing (newest first); returns (rows, total)."""
        where: list[str] = []
        args: list[Any] = []
        if tenant_id:
            where.append("tenant_id = ?")
            args.append(tenant_id)
        if status:
            where.append("status = ?")
            args.append(status)
        clause = (" WHERE " + " AND ".join(where)) if where else ""
        with self._lock:
            (total,) = self._conn.execute(
                f"SELECT COUNT(*) FROM jobs{clause}", args
            ).fetchone()
            rows = self._conn.execute(
                f"SELECT job_id, tenant_id, queue, priority, status, stage,"
                f" error, created_at, updated_at FROM jobs{clause}"
                f" ORDER BY created_at DESC LIMIT ? OFFSET ?",
                (*args, limit, offset),
            ).fetchall()
        return [dict(r) for r in rows], int(total)

    def queue_depth(self, queue: str) -> int:
        with self._lock:
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM jobs WHERE queue = ? AND status IN (?, ?)",
                (queue, JobStatus.QUEUED.value, JobStatus.RUNNING.value),
            ).fetchone()
        return int(n)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT queue, status, COUNT(*) AS n FROM jobs"
                " GROUP BY queue, status"
            ).fetchall()
        out: dict[str, dict[str, int]] = {}
        for r in rows:
            out.setdefault(r["queue"], {})[r["status"]] = r["n"]
        return out

    # -- results / checkpoints / idempotency -------------------------------
    def put_result(self, result: JobResult, ttl_s: float) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO results VALUES (?,?,?)",
                (result.job_id, result.to_json(), time.time() + ttl_s),
            )
            self._conn.commit()

    def get_result(self, job_id: str) -> JobResult | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM results WHERE job_id = ? AND expires_at > ?",
                (job_id, time.time()),
            ).fetchone()
        return JobResult.from_json(row["data"]) if row else None

    def put_checkpoint(self, ckpt: JobCheckpoint, ttl_s: float) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO checkpoints VALUES (?,?,?)",
                (ckpt.job_id, ckpt.to_json(), time.time() + ttl_s),
            )
            self._conn.commit()

    def get_checkpoint(self, job_id: str) -> JobCheckpoint | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT data FROM checkpoints WHERE job_id = ?"
                " AND expires_at > ?",
                (job_id, time.time()),
            ).fetchone()
        return JobCheckpoint.from_json(row["data"]) if row else None

    def delete_checkpoint(self, job_id: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM checkpoints WHERE job_id = ?", (job_id,)
            )
            self._conn.commit()

    def check_idempotency(self, key: str) -> str | None:
        """Existing (unexpired) job id for this key, else None."""
        with self._lock:
            row = self._conn.execute(
                "SELECT job_id FROM idempotency WHERE key = ?"
                " AND expires_at > ?",
                (key, time.time()),
            ).fetchone()
        return row["job_id"] if row else None

    def put_idempotency(self, key: str, job_id: str, ttl_s: float) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO idempotency VALUES (?,?,?)",
                (key, job_id, time.time() + ttl_s),
            )
            self._conn.commit()

    # -- workers -----------------------------------------------------------
    def heartbeat(self, worker_id: str, info: dict[str, Any]) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO workers VALUES (?,?,?)",
                (worker_id, json.dumps(info), time.time()),
            )
            self._conn.commit()

    def live_workers(self, ttl_s: float = 300.0) -> dict[str, dict[str, Any]]:
        cutoff = time.time() - ttl_s
        with self._lock:
            rows = self._conn.execute(
                "SELECT * FROM workers WHERE last_heartbeat > ?", (cutoff,)
            ).fetchall()
        return {
            r["worker_id"]: {
                **json.loads(r["info"]),
                "last_heartbeat": r["last_heartbeat"],
            }
            for r in rows
        }

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM workers WHERE worker_id = ?", (worker_id,)
            )
            self._conn.commit()

    # -- rate limiting (shared with the API layer) -------------------------
    def rate_limit_count(self, key: str, window_s: float) -> int:
        """Record an event and return the count inside the sliding window."""
        now = time.time()
        with self._lock:
            self._conn.execute(
                "DELETE FROM rate_events WHERE key = ? AND ts <= ?",
                (key, now - window_s),
            )
            self._conn.execute(
                "INSERT INTO rate_events VALUES (?,?)", (key, now)
            )
            (n,) = self._conn.execute(
                "SELECT COUNT(*) FROM rate_events WHERE key = ? AND ts > ?",
                (key, now - window_s),
            ).fetchone()
            self._conn.commit()
        return int(n)

    def requeue_stale(self, worker_ttl_s: float = 300.0) -> list[str]:
        """Requeue RUNNING jobs claimed by workers with expired heartbeats.

        Crash recovery: a worker that dies mid-job leaves the job RUNNING;
        any live worker calls this periodically so the job returns to
        QUEUED (and resumes from its last stage checkpoint).
        """
        cutoff = time.time() - worker_ttl_s
        with self._lock:
            rows = self._conn.execute(
                "SELECT j.job_id FROM jobs j LEFT JOIN workers w"
                " ON j.claimed_by = w.worker_id"
                " WHERE j.status = ? AND (w.worker_id IS NULL"
                "       OR w.last_heartbeat <= ?)",
                (JobStatus.RUNNING.value, cutoff),
            ).fetchall()
            ids = [r["job_id"] for r in rows]
            for jid in ids:
                self._conn.execute(
                    "UPDATE jobs SET status = ?, claimed_by = NULL,"
                    " updated_at = ? WHERE job_id = ?",
                    (JobStatus.QUEUED.value, time.time(), jid),
                )
            self._conn.commit()
        return ids

    # -- maintenance -------------------------------------------------------
    def cleanup_expired(self) -> int:
        now = time.time()
        with self._lock:
            n = 0
            for table in ("results", "checkpoints", "idempotency"):
                cur = self._conn.execute(
                    f"DELETE FROM {table} WHERE expires_at <= ?", (now,)
                )
                n += cur.rowcount
            self._conn.commit()
        return n

    def health(self) -> bool:
        try:
            with self._lock:
                self._conn.execute("SELECT 1").fetchone()
            return True
        except sqlite3.Error:
            return False
