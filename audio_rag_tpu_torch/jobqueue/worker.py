"""Ingestion worker of the port (counterpart of
``audio_rag_tpu/jobqueue/worker.py``): claims jobs from the store and runs
them on the card. Graceful SIGTERM/SIGINT shutdown, model preload, worker
registration and periodic heartbeats carrying the card's memory, priority
order (high → normal → low), per-stage status, checkpoints and resume,
cancellation at stage boundaries, stage-grouped batch claims
(``worker.batch_claim``), a reaper that requeues the jobs of workers whose
heartbeats stopped, and an in-process mode (``run_once``).

Cancellation: the progress hook raises a signal that derives from
``BaseException``, so that the pipeline's progress wrapper (which swallows
a failing callback's ``Exception``) lets it through and a running job
stops at its next stage boundary. The JAX worker's signal is an
``Exception`` and is swallowed there, so its running jobs finish; a job
cancelled before its claim ends ``CANCELLED`` in both.

Run a worker: ``python -m audio_rag_tpu_torch.jobqueue.worker
--queue-config configs/queue.yaml --db /path/queue.db --max-jobs N``
(``AUDIO_RAG__DEVICE=cpu`` and small models run it on the CPU).
"""

from __future__ import annotations

import logging
import signal
import socket
import threading
import time
import traceback
import uuid
from typing import Any, Callable

import torch

from audio_rag_tpu_torch.jobqueue.config import QueueConfig, load_queue_config
from audio_rag_tpu_torch.jobqueue.job import (
    IngestJob,
    JobCheckpoint,
    JobResult,
    JobStage,
    JobStatus,
)
from audio_rag_tpu_torch.jobqueue.store import JobStore

log = logging.getLogger(__name__)

__all__ = ["GPUWorker", "process_ingest_job", "process_ingest_batch",
           "get_device_memory_info"]

_STAGE_BY_CKPT = {
    "aligned": JobStage.CHUNKING,
    "chunked": JobStage.EMBEDDING,
    "contextualized": JobStage.EMBEDDING,
}

_STAGE_BY_PROGRESS = {
    "transcribing": JobStage.TRANSCRIBING,
    "diarizing": JobStage.DIARIZING,
    "aligning": JobStage.ALIGNING,
    "chunking": JobStage.CHUNKING,
    "contextualizing": JobStage.CONTEXTUALIZING,
    "embedding": JobStage.EMBEDDING,
    "indexing": JobStage.INDEXING,
    "done": JobStage.FINALIZING,
}


def get_device_memory_info(device: str | torch.device | None = None
                           ) -> dict[str, Any]:
    """The card's memory for heartbeats: platform "cuda", PyTorch's
    allocated bytes and the card's total; platform "cpu" with no figures
    when ``device`` is the CPU or no card is present."""
    dev = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if dev.type != "cuda":
        return {"platform": "cpu", "bytes_in_use": None, "bytes_limit": None}
    return {
        "platform": "cuda",
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


class _CancelledSignal(BaseException):
    """Raised by the progress hook of a job cancelled while it runs."""


def process_ingest_job(job: IngestJob, store: JobStore, rag,
                       config: QueueConfig) -> JobResult:
    """Run one job with status and stage updates, checkpoints and
    resume."""
    t0 = time.time()
    row = store.get_job_row(job.job_id)
    if row and row["status"] == JobStatus.CANCELLED.value:
        result = JobResult(job_id=job.job_id, status=JobStatus.CANCELLED)
        store.put_result(result, config.storage.result_ttl_s)
        return result
    store.set_status(job.job_id, JobStatus.RUNNING,
                     stage=JobStage.VALIDATING)

    ckpt = store.get_checkpoint(job.job_id)
    resume = None
    if ckpt is not None:
        resume = {**ckpt.data, "stage": ckpt.data.get("ckpt_stage")}
        log.info("job %s resuming from checkpoint %s",
                 job.job_id, resume["stage"])

    def on_progress(stage: str, frac: float) -> None:
        js = _STAGE_BY_PROGRESS.get(stage)
        if js is not None:
            store.set_stage(job.job_id, js)
        row = store.get_job_row(job.job_id)
        if row and row["status"] == JobStatus.CANCELLED.value:
            raise _CancelledSignal()

    def on_checkpoint(stage: str, data: dict[str, Any]) -> None:
        store.put_checkpoint(
            JobCheckpoint(job_id=job.job_id,
                          stage=_STAGE_BY_CKPT.get(stage, JobStage.EMBEDDING),
                          data={"ckpt_stage": stage, **data}),
            config.storage.checkpoint_ttl_s)

    rag.ingestion.progress_callback = on_progress
    restore = _apply_config_overrides(rag, job.config_overrides)
    try:
        res = rag.ingestion.ingest(
            job.audio_path, collection=job.collection,
            metadata={"tenant_id": job.tenant_id, **job.metadata},
            checkpoint_cb=on_checkpoint, resume=resume)
        result = JobResult(
            job_id=job.job_id, status=JobStatus.COMPLETED,
            collection=res.collection, num_chunks=res.num_chunks,
            num_segments=res.num_segments, num_speakers=res.num_speakers,
            duration_s=res.duration_s,
            elapsed_s=round(time.time() - t0, 3),
            metrics=res.stage_timings)
        store.set_status(job.job_id, JobStatus.COMPLETED,
                         stage=JobStage.FINALIZING)
        store.delete_checkpoint(job.job_id)
    except _CancelledSignal:
        result = JobResult(job_id=job.job_id, status=JobStatus.CANCELLED,
                           elapsed_s=round(time.time() - t0, 3))
        log.info("job %s cancelled", job.job_id)
    except Exception as exc:
        log.error("job %s failed: %s\n%s", job.job_id, exc,
                  traceback.format_exc())
        result = JobResult(job_id=job.job_id, status=JobStatus.FAILED,
                           error=f"{type(exc).__name__}: {exc}",
                           elapsed_s=round(time.time() - t0, 3))
        store.set_status(job.job_id, JobStatus.FAILED, error=result.error)
    finally:
        rag.ingestion.progress_callback = None
        restore()

    store.put_result(result, config.storage.result_ttl_s)
    return result


def process_ingest_batch(jobs: list[IngestJob], store: JobStore, rag,
                         config: QueueConfig) -> list[JobResult]:
    """Run several compatible claimed jobs as one stage-grouped
    ``ingest_batch``: the contextual stage's ASR↔LLM swap is paid once per
    batch instead of twice per job. Progress and checkpoints coarsen to
    the batch and cancellation is observed at batch boundaries. On any
    failure the batch falls back to :func:`process_ingest_job` per job,
    which isolates a poison file."""
    t0 = time.time()
    live: list[IngestJob] = []
    results: dict[str, JobResult] = {}
    for job in jobs:
        row = store.get_job_row(job.job_id)
        if row and row["status"] == JobStatus.CANCELLED.value:
            results[job.job_id] = JobResult(job_id=job.job_id,
                                            status=JobStatus.CANCELLED)
            store.put_result(results[job.job_id],
                             config.storage.result_ttl_s)
        else:
            live.append(job)
            store.set_status(job.job_id, JobStatus.RUNNING,
                             stage=JobStage.TRANSCRIBING)
    if not live:
        return [results[j.job_id] for j in jobs]

    restore = _apply_config_overrides(rag, live[0].config_overrides)
    try:
        res_list = rag.ingestion.ingest_batch(
            [j.audio_path for j in live], collection=live[0].collection,
            metadatas=[{"tenant_id": j.tenant_id, **j.metadata}
                       for j in live])
        for job, res in zip(live, res_list):
            result = JobResult(
                job_id=job.job_id, status=JobStatus.COMPLETED,
                collection=res.collection, num_chunks=res.num_chunks,
                num_segments=res.num_segments,
                num_speakers=res.num_speakers, duration_s=res.duration_s,
                elapsed_s=round(time.time() - t0, 3),
                metrics=res.stage_timings)
            store.set_status(job.job_id, JobStatus.COMPLETED,
                             stage=JobStage.FINALIZING)
            store.put_result(result, config.storage.result_ttl_s)
            results[job.job_id] = result
    except Exception as exc:
        log.warning("batch ingest of %d jobs failed (%s); falling back "
                    "to per-job processing", len(live), exc)
        for job in live:
            results[job.job_id] = process_ingest_job(job, store, rag, config)
    finally:
        restore()
    return [results[j.job_id] for j in jobs]


def _apply_config_overrides(rag, overrides: dict[str, Any]):
    """Apply a job's ``{"section.key": value}`` or nested-dict overrides to
    ``rag.config``; returns the callback that restores the old values."""
    if not overrides:
        return lambda: None
    undo: list[tuple[Any, str, Any]] = []
    for key, value in overrides.items():
        try:
            if "." in key:
                section_name, attr = key.split(".", 1)
                pairs = [(section_name, attr, value)]
            elif isinstance(value, dict):
                pairs = [(key, a, v) for a, v in value.items()]
            else:
                log.warning("ignoring malformed config override %r", key)
                continue
            for section_name, attr, v in pairs:
                section = getattr(rag.config, section_name, None)
                if section is None or not hasattr(section, attr):
                    log.warning("unknown config override %s.%s",
                                section_name, attr)
                    continue
                undo.append((section, attr, getattr(section, attr)))
                setattr(section, attr, v)
        except Exception as exc:
            log.warning("config override %r failed: %s", key, exc)

    def restore() -> None:
        for section, attr, old in reversed(undo):
            setattr(section, attr, old)

    return restore


def _batch_key(job: IngestJob) -> tuple:
    return job.collection, repr(sorted((job.config_overrides or {}).items()))


class GPUWorker:
    """Long-running worker consuming the high → normal → low queues on the
    card (the JAX package's ``TPUWorker``; ``GPUWorker`` is the name of
    the upstream project's worker that both follow)."""

    def __init__(self, config: QueueConfig | None = None,
                 store: JobStore | None = None,
                 rag_factory: Callable[[], Any] | None = None,
                 worker_id: str | None = None):
        self.config = config or QueueConfig()
        self.store = store or JobStore(self.config.storage.db_path)
        self._rag_factory = rag_factory or self._default_rag
        self.worker_id = worker_id or (
            f"worker-{socket.gethostname()}-{uuid.uuid4().hex[:8]}")
        self._rag = None
        self._stop = threading.Event()
        self._heartbeat_thread: threading.Thread | None = None
        self.jobs_processed = 0

    @staticmethod
    def _default_rag():
        from audio_rag_tpu_torch.config import load_config
        from audio_rag_tpu_torch.pipeline import AudioRAG

        return AudioRAG(load_config())

    def _memory_info(self) -> dict[str, Any]:
        return get_device_memory_info(getattr(self._rag, "device", None))

    # -- lifecycle ---------------------------------------------------------
    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self.stop())

    def start(self, max_jobs: int | None = None) -> None:
        log.info("worker %s starting", self.worker_id)
        self._rag = self._rag_factory()
        if self.config.worker.preload_models:
            try:  # load the ASR and the embedder before the first job
                _ = self._rag.ingestion.asr
                _ = self._rag.embedder
            except Exception as exc:
                log.warning("model preload failed: %s", exc)
        self._start_heartbeat()
        last_reap = 0.0
        try:
            while not self._stop.is_set():
                now = time.monotonic()
                if now - last_reap > self.config.worker.heartbeat_ttl_s:
                    stale = self.store.requeue_stale(
                        self.config.worker.heartbeat_ttl_s)
                    if stale:
                        log.warning("requeued %d stale job(s): %s",
                                    len(stale), stale)
                    last_reap = now
                worked = self.run_once()
                if max_jobs is not None and self.jobs_processed >= max_jobs:
                    break
                if not worked:
                    self._stop.wait(self.config.worker.poll_interval_s)
        finally:
            self._shutdown()

    def run_once(self) -> bool:
        """Claim and process work; returns whether any job was found.

        With ``worker.batch_claim > 1`` and contextual headers on,
        compatible queued jobs (same collection and config overrides, no
        pending checkpoint) run as one stage-grouped ingest; other claims
        run one by one after it."""
        if self._rag is None:
            self._rag = self._rag_factory()
        queue_names = [q.name for q in self.config.queues]
        job = self.store.claim_next(self.worker_id, queue_names)
        if job is None:
            return False

        want = self.config.worker.batch_claim
        contextual_on = getattr(self._rag.config.contextual, "enabled",
                                False)
        batch: list[IngestJob] = [job]
        singles: list[IngestJob] = []
        if want > 1 and contextual_on \
                and self.store.get_checkpoint(job.job_id) is None:
            key = _batch_key(job)
            while len(batch) < want:
                nxt = self.store.claim_next(self.worker_id, queue_names)
                if nxt is None:
                    break
                if (_batch_key(nxt) == key
                        and self.store.get_checkpoint(nxt.job_id) is None):
                    batch.append(nxt)
                else:
                    singles.append(nxt)  # already claimed; run after

        if len(batch) > 1:
            log.info("worker %s claimed batch of %d job(s)",
                     self.worker_id, len(batch))
            process_ingest_batch(batch, self.store, self._rag, self.config)
            self.jobs_processed += len(batch)
        else:
            log.info("worker %s claimed job %s", self.worker_id, job.job_id)
            process_ingest_job(job, self.store, self._rag, self.config)
            self.jobs_processed += 1
        for nxt in singles:
            process_ingest_job(nxt, self.store, self._rag, self.config)
            self.jobs_processed += 1
        return True

    def stop(self) -> None:
        log.info("worker %s stopping (graceful)", self.worker_id)
        self._stop.set()

    def _shutdown(self) -> None:
        self._stop.set()  # ends the heartbeat thread after max_jobs too
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=2.0)
        self.store.remove_worker(self.worker_id)
        log.info("worker %s stopped after %d job(s)",
                 self.worker_id, self.jobs_processed)

    # -- heartbeats --------------------------------------------------------
    def _start_heartbeat(self) -> None:
        def beat() -> None:
            while not self._stop.is_set():
                self.store.heartbeat(self.worker_id, {
                    "jobs_processed": self.jobs_processed,
                    **self._memory_info()})
                self._stop.wait(self.config.worker.heartbeat_interval_s)

        self.store.heartbeat(self.worker_id, self._memory_info())
        self._heartbeat_thread = threading.Thread(
            target=beat, name="worker-heartbeat", daemon=True)
        self._heartbeat_thread.start()


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="audio_rag_tpu_torch worker")
    parser.add_argument("--db", default=None, help="queue db path")
    parser.add_argument("--queue-config", default=None,
                        help="queue YAML (e.g. configs/queue.yaml)")
    parser.add_argument("--max-jobs", type=int, default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    cfg = (load_queue_config(args.queue_config) if args.queue_config
           else QueueConfig())
    if args.db:
        cfg.storage.db_path = args.db
    worker = GPUWorker(cfg)
    worker.install_signal_handlers()
    worker.start(max_jobs=args.max_jobs)


if __name__ == "__main__":
    main()
