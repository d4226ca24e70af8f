"""The port's ingestion worker against the JAX package's: the ten
scenarios of ``tests/integration/test_worker_e2e.py`` on fake backends
through both packages (equal statuses, stages, progress, results, chunk
counts, stored chunks and tenant metadata), ``start(max_jobs=...)`` with
heartbeats and the reaper, the port's ``main()`` on a queue YAML, and the
port's cancellation of a running job at a stage boundary (the JAX worker's
signal is swallowed by the pipeline's progress wrapper, so there the job
completes)."""

from pathlib import Path

import numpy as np
import pytest

from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.jobqueue import config as jconfig
from audio_rag_tpu.jobqueue import job as jjob
from audio_rag_tpu.jobqueue import queue as jqueue
from audio_rag_tpu.jobqueue import store as jstore
from audio_rag_tpu.jobqueue import worker as jworker
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu_torch.config import load_config
from audio_rag_tpu_torch.jobqueue import config as pconfig
from audio_rag_tpu_torch.jobqueue import job as pjob
from audio_rag_tpu_torch.jobqueue import queue as pqueue
from audio_rag_tpu_torch.jobqueue import store as pstore
from audio_rag_tpu_torch.jobqueue import worker as pworker
from audio_rag_tpu_torch.pipeline import AudioRAG
from torch_ledger_common import fresh_ledger  # noqa: F401

NOWHERE = "configs/no-such-dir"  # no base.yaml: the schema's defaults

#: the JAX end-to-end test's ``fake_rag`` config
FAKE = {
    "asr": {"backend": "fake"},
    "diarization": {"backend": "fake"},
    "embedding": {"backend": "fake"},
    "retrieval": {"backend": "tpu", "capacity_step": 128},
    "reranking": {"backend": "none"},
    "generation": {"backend": "none"},
}
CONTEXTUAL = {**FAKE, "generation": {"backend": "fake"},
              "contextual": {"enabled": True}}


class _Pkg:
    def __init__(self, name):
        port = name == "port"
        self.name = name
        self.job, self.store, self.queue, self.config, self.worker = (
            (pjob, pstore, pqueue, pconfig, pworker) if port else
            (jjob, jstore, jqueue, jconfig, jworker))
        self.Worker = pworker.GPUWorker if port else jworker.TPUWorker

    def rag(self, sections):
        if self.name == "port":
            return AudioRAG(load_config(configs_dir=NOWHERE, overrides={
                **sections, "device": "cpu"}))
        return JaxAudioRAG(JaxConfig(**sections))

    def env(self):
        store = self.store.JobStore(":memory:")
        cfg = self.config.QueueConfig(
            storage=self.config.StorageConfig(db_path=":memory:"))
        cfg.worker.preload_models = False
        return store, cfg, self.queue.AudioRAGQueue(cfg, store=store)

    def stored(self, rag, collection=None):
        """The stored chunks (text, speaker, times, tenant) in order."""
        store = rag.store if self.name == "port" else rag._retriever
        name = collection or rag.config.retrieval.collection_name
        coll = store._coll(name) if name in store.list_collections() \
            else None
        return [(p["text"], p["speaker"], round(float(p["start"]), 3),
                 round(float(p["end"]), 3), p["metadata"].get("tenant_id"))
                for p in (coll.payloads if coll is not None else [])]


def _result(res):
    """A JobResult without its clock readings (the stage timings' keys
    kept)."""
    if res is None:
        return None
    return {"status": res.status.value, "collection": res.collection,
            "num_chunks": res.num_chunks, "num_segments": res.num_segments,
            "num_speakers": res.num_speakers, "duration_s": res.duration_s,
            "error": res.error, "metrics": sorted(res.metrics)}


def _status(queue, jid):
    st = queue.get_status(jid)
    return {k: st[k] for k in ("status", "stage", "progress", "queue",
                               "error")}


@pytest.fixture
def wav(tmp_path):
    sr = 16000
    audio = 0.1 * np.random.default_rng(0).standard_normal(sr * 10)
    p = tmp_path / "a.wav"
    write_wav(p, audio.astype(np.float32), sr)
    return str(p)


def _files(tmp_path, n, seed0=10):
    sr, paths = 16000, []
    tmp_path.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        p = tmp_path / f"b{seed0 + i}.wav"
        write_wav(p, (0.1 * np.random.default_rng(seed0 + i)
                      .standard_normal(sr * 8)).astype(np.float32), sr)
        paths.append(str(p))
    return paths


# -- the scenarios, each run through one package ----------------------------

def full_job_lifecycle(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    jid = queue.enqueue(pkg.job.IngestJob("tenant1", wav))
    worker = pkg.Worker(cfg, store=store, rag_factory=lambda: pkg.rag(FAKE))
    ran = (worker.run_once(), worker.run_once())
    return (ran, _status(queue, jid), _result(queue.get_result(jid)),
            store.get_checkpoint(jid), pkg.stored(worker._rag))


def failed_job_records_error(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    jid = queue.enqueue(pkg.job.IngestJob("tenant1", "/missing.wav"),
                        validate=False)
    worker = pkg.Worker(cfg, store=store, rag_factory=lambda: pkg.rag(FAKE))
    worker.run_once()
    st = _status(queue, jid)
    assert "AudioProcessingError" in st["error"]
    return st["status"], st["stage"], _result(queue.get_result(jid))["status"]


def cancellation_before_the_claim(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    jid = queue.enqueue(pkg.job.IngestJob("tenant1", wav))
    rag = pkg.rag(FAKE)
    job = store.claim_next("w1")
    store.set_status(jid, pkg.job.JobStatus.CANCELLED)
    res = pkg.worker.process_ingest_job(job, store, rag, cfg)
    return _result(res), _status(queue, jid), pkg.stored(rag)


def resume_from_checkpoint(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    jid = queue.enqueue(pkg.job.IngestJob("tenant1", wav))
    job = store.claim_next("w1")
    chunks = [{"text": "resumed chunk", "start": 0.0, "end": 5.0,
               "speaker": "S0", "chunk_id": "ck1", "metadata": {}}]
    store.put_checkpoint(pkg.job.JobCheckpoint(
        job_id=jid, stage=pkg.job.JobStage.EMBEDDING,
        data={"ckpt_stage": "chunked", "chunks": chunks}), ttl_s=60)

    class ExplodingASR:
        def transcribe_with_words(self, *a, **k):
            raise AssertionError("ASR must not run on resume")

    rag = pkg.rag(FAKE)
    rag.ingestion._asr = ExplodingASR()
    res = pkg.worker.process_ingest_job(job, store, rag, cfg)
    out = rag.query("resumed chunk", search_type="dense", rerank=False)
    return (_result(res), _status(queue, jid),
            [r.chunk_id for r in out.results], pkg.stored(rag))


def config_overrides_applied_and_restored(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    queue.enqueue(pkg.job.IngestJob(
        "tenant1", wav, config_overrides={
            "chunking.max_tokens": 77,
            "retrieval": {"collection_name": "override"},
            "nosection.x": 1, "flat": 2}))
    rag = pkg.rag(FAKE)
    before = rag.config.chunking.max_tokens
    job = store.claim_next("w1")
    seen = {}
    orig = rag.ingestion.ingest

    def spy(*a, **k):
        seen["max_tokens"] = rag.config.chunking.max_tokens
        seen["collection_name"] = rag.config.retrieval.collection_name
        return orig(*a, **k)

    rag.ingestion.ingest = spy
    res = pkg.worker.process_ingest_job(job, store, rag, cfg)
    assert seen == {"max_tokens": 77, "collection_name": "override"}
    assert rag.config.chunking.max_tokens == before
    return (_result(res), seen, rag.config.retrieval.collection_name,
            pkg.stored(rag, "override"))


def heartbeat_registered(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    worker = pkg.Worker(cfg, store=store, rag_factory=lambda: pkg.rag(FAKE))
    store.heartbeat(worker.worker_id, {"jobs_processed": 0})
    return ({k: v for k, v in store.live_workers()[worker.worker_id].items()
             if k != "last_heartbeat"}, worker.worker_id.startswith(
                 "worker-"))


def _enqueue(pkg, queue, paths, collection=None, tenant0=0):
    return [queue.enqueue(pkg.job.IngestJob(
        f"tenant{tenant0 + i}", p, collection=collection))
        for i, p in enumerate(paths)]


def batch_completes_all_jobs(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    cfg.worker.batch_claim = 4
    jids = _enqueue(pkg, queue, _files(tmp_path, 3))
    worker = pkg.Worker(cfg, store=store,
                        rag_factory=lambda: pkg.rag(CONTEXTUAL))
    ran = worker.run_once()
    assert worker.jobs_processed == 3
    out = worker._rag.query("word0", rerank=False)
    tenants = {r.metadata.get("tenant_id") for r in out.results}
    assert tenants <= {"tenant0", "tenant1", "tenant2"}
    return (ran, [_result(queue.get_result(j)) for j in jids],
            [_status(queue, j) for j in jids], sorted(tenants),
            pkg.stored(worker._rag))


def incompatible_collections_split(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    cfg.worker.batch_claim = 4
    a = _enqueue(pkg, queue, _files(tmp_path, 2), collection="colA")
    b = _enqueue(pkg, queue, _files(tmp_path, 1, seed0=50),
                 collection="colB", tenant0=5)
    worker = pkg.Worker(cfg, store=store,
                        rag_factory=lambda: pkg.rag(CONTEXTUAL))
    ran = worker.run_once()
    return (ran, worker.jobs_processed,
            [_result(queue.get_result(j)) for j in a + b],
            pkg.stored(worker._rag, "colA"), pkg.stored(worker._rag, "colB"))


def poison_file_falls_back_per_job(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    cfg.worker.batch_claim = 4
    good = _enqueue(pkg, queue, _files(tmp_path, 2))
    bad = queue.enqueue(pkg.job.IngestJob("tenantX", "/missing.wav"),
                        validate=False)
    worker = pkg.Worker(cfg, store=store,
                        rag_factory=lambda: pkg.rag(CONTEXTUAL))
    runs = [worker.run_once()]
    while runs[-1]:
        runs.append(worker.run_once())
    return (runs, [_result(queue.get_result(j)) for j in good + [bad]],
            [_status(queue, j) for j in good + [bad]],
            pkg.stored(worker._rag))


def batch_claim_1_unchanged(pkg, wav, tmp_path):
    store, cfg, queue = pkg.env()
    assert cfg.worker.batch_claim == 1
    jids = _enqueue(pkg, queue, _files(tmp_path, 2))
    worker = pkg.Worker(cfg, store=store,
                        rag_factory=lambda: pkg.rag(CONTEXTUAL))
    ran = [worker.run_once()]
    first = worker.jobs_processed
    while ran[-1]:
        ran.append(worker.run_once())
    return (ran, first, [_result(queue.get_result(j)) for j in jids],
            pkg.stored(worker._rag))


SCENARIOS = [full_job_lifecycle, failed_job_records_error,
             cancellation_before_the_claim, resume_from_checkpoint,
             config_overrides_applied_and_restored, heartbeat_registered,
             batch_completes_all_jobs, incompatible_collections_split,
             poison_file_falls_back_per_job, batch_claim_1_unchanged]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__ for f in SCENARIOS])
def test_worker_matches_jax(scenario, wav, tmp_path):
    got = scenario(_Pkg("port"), wav, tmp_path / "port")
    want = scenario(_Pkg("jax"), wav, tmp_path / "jax")
    assert got == want


def test_start_drains_with_heartbeats_and_the_reaper(tmp_path):
    """``start(max_jobs=3)`` in both packages: the reaper first requeues
    the job a worker without heartbeats had claimed, then the three jobs
    complete in priority order, the heartbeat row carried the device's
    memory while the worker ran, and the worker is gone after."""
    outs = []
    for name in ("port", "jax"):
        pkg = _Pkg(name)
        store, cfg, queue = pkg.env()
        cfg.worker.heartbeat_interval_s = 1
        paths = _files(tmp_path / name, 3)
        jids = [queue.enqueue(pkg.job.IngestJob(f"tenant{i}", p,
                                                priority=prio))
                for i, (p, prio) in enumerate(zip(paths, ["LOW", "NORMAL",
                                                          "HIGH"]))]
        store.claim_next("crashed-worker")  # the HIGH job, never beats
        beats = []
        orig = store.heartbeat

        def heartbeat(wid, info, orig=orig, beats=beats):
            beats.append(dict(info))
            orig(wid, info)

        store.heartbeat = heartbeat
        order = []
        worker = pkg.Worker(cfg, store=store,
                            rag_factory=lambda pkg=pkg: pkg.rag(FAKE))
        claim = store.claim_next

        def spy(wid, queues=None, claim=claim, order=order):
            job = claim(wid, queues)
            if job is not None:
                order.append(job.job_id)
            return job

        store.claim_next = spy
        worker.start(max_jobs=3)
        assert beats and {b["platform"] for b in beats} <= {"cpu"}
        if name == "port":  # its heartbeat thread ends with the worker
            assert not worker._heartbeat_thread.is_alive()
            assert worker.worker_id not in store.live_workers()
        else:  # the JAX one beats on until told to stop
            worker.stop()
            worker._heartbeat_thread.join(timeout=5)
        outs.append(([jids.index(j) for j in order],
                     [_result(queue.get_result(j)) for j in jids],
                     worker.jobs_processed))
    assert outs[0] == outs[1]
    assert outs[0][0] == [2, 1, 0]


def test_main_drains_a_queue_file(tmp_path, monkeypatch):
    """``python -m audio_rag_tpu_torch.jobqueue.worker --queue-config
    configs/queue.yaml --db ... --max-jobs 2`` on fake backends (the
    environment's config) drains two jobs from a file database."""
    db = str(tmp_path / "q.db")
    cfg = pconfig.load_queue_config("configs/queue.yaml")
    cfg.storage.db_path = db
    queue = pqueue.AudioRAGQueue(cfg)
    jids = [queue.enqueue(pjob.IngestJob(f"tenant{i}", p))
            for i, p in enumerate(_files(tmp_path, 2))]
    for key, value in {"ASR__BACKEND": "fake",
                       "DIARIZATION__BACKEND": "fake",
                       "EMBEDDING__BACKEND": "fake",
                       "RERANKING__BACKEND": "fake",
                       "GENERATION__BACKEND": "fake",
                       "DEVICE": "cpu"}.items():
        monkeypatch.setenv(f"AUDIO_RAG__{key}", value)
    queue_yaml = str(Path("configs/queue.yaml").resolve())
    monkeypatch.chdir(tmp_path)  # no configs/ here: the schema's defaults
    handled = []  # the signals main() takes over, not installed here
    monkeypatch.setattr(pworker.signal, "signal",
                        lambda sig, handler: handled.append(sig))
    # nor its root logging handler, which would outlive the test
    monkeypatch.setattr(pworker.logging, "basicConfig", lambda **kw: None)
    pworker.main(["--queue-config", queue_yaml, "--db", db,
                  "--max-jobs", "2"])
    assert handled == [pworker.signal.SIGTERM, pworker.signal.SIGINT]
    store = pstore.JobStore(db)
    assert [store.get_job_row(j)["status"] for j in jids] == [
        "completed", "completed"]
    assert store.live_workers() == {}


def test_running_job_is_cancelled_at_a_stage_boundary(wav):
    """The port stops a job cancelled while it runs at its next stage:
    nothing is stored and the result is CANCELLED. The JAX worker's
    signal is swallowed by its pipeline's progress wrapper, so the same
    job completes there."""
    outs = {}
    for name in ("port", "jax"):
        pkg = _Pkg(name)
        store, cfg, queue = pkg.env()
        jid = queue.enqueue(pkg.job.IngestJob("tenant1", wav))
        rag = pkg.rag(FAKE)
        asr = rag.ingestion.asr
        orig = asr.transcribe_with_words

        def cancel_then_transcribe(*a, orig=orig, store=store, jid=jid,
                                   pkg=pkg, **k):
            store.set_status(jid, pkg.job.JobStatus.CANCELLED)
            return orig(*a, **k)

        asr.transcribe_with_words = cancel_then_transcribe
        job = store.claim_next("w1")
        res = pkg.worker.process_ingest_job(job, store, rag, cfg)
        outs[name] = (res.status.value, queue.get_status(jid)["stage"],
                      len(pkg.stored(rag)))
    assert outs["port"] == ("cancelled", "diarizing", 0)
    assert outs["jax"][0] == "completed" and outs["jax"][2] > 0
