"""The port's job queue against the JAX package's: the same operation
sequences on both ``JobStore(":memory:")``s at one patched clock (equal
rows, claims, listings, stats, TTL expiry, heartbeats, rate limits and
requeues), the job, result and checkpoint JSON read across packages, the
validators, ``AudioRAGQueue``, and ``configs/queue.yaml`` read by the
port's YAML reader against ``QueueConfig(**yaml.safe_load(...))``. All
comparisons are exact."""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.jobqueue import config as jconfig
from audio_rag_tpu.jobqueue import job as jjob
from audio_rag_tpu.jobqueue import queue as jqueue
from audio_rag_tpu.jobqueue import store as jstore
from audio_rag_tpu.jobqueue import validation as jvalid
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.jobqueue import config as pconfig
from audio_rag_tpu_torch.jobqueue import job as pjob
from audio_rag_tpu_torch.jobqueue import queue as pqueue
from audio_rag_tpu_torch.jobqueue import store as pstore
from audio_rag_tpu_torch.jobqueue import validation as pvalid

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PKGS = {"jax": (jjob, jstore, jqueue, jconfig, jvalid),
        "port": (pjob, pstore, pqueue, pconfig, pvalid)}


@pytest.fixture
def clock(monkeypatch):
    """One clock for both stores, moved by the test."""
    now = {"t": 1_000_000.0}
    ns = types.SimpleNamespace(time=lambda: now["t"])
    for mod in (jstore, pstore):
        monkeypatch.setattr(mod, "time", ns)
    return now


def _job(pkg, i, queue_prio="NORMAL", created=0.0, **kw):
    job = PKGS[pkg][0]
    return job.IngestJob(tenant_id=f"tenant{i % 2}",
                         audio_path=f"/audio/{i}.wav", job_id=f"job-{i}",
                         priority=queue_prio, created_at=created, **kw)


def _out(x):
    """A value of either package in comparable form."""
    if hasattr(x, "to_json"):
        return ("json", x.to_json())
    if isinstance(x, dict):
        return {k: _out(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_out(v) for v in x]
    return x


def _claims(pkg, clock):
    job = PKGS[pkg][0]
    s = PKGS[pkg][1].JobStore(":memory:")
    out = []
    for i, (q, prio) in enumerate([("normal", "NORMAL"), ("high", "HIGH"),
                                   ("low", "LOW"), ("high", "CRITICAL"),
                                   ("normal", "NORMAL")]):
        clock["t"] += 1.0
        s.insert_job(_job(pkg, i, prio, created=clock["t"]), q)
    clock["t"] += 1.0
    out.append(s.claim_next("w1", ["low"]).job_id)
    for _ in range(5):
        clock["t"] += 1.0
        got = s.claim_next("w2")
        out.append(got.job_id if got else None)
    s.set_status("job-0", job.JobStatus.FAILED, error="boom")
    s.set_status("job-1", job.JobStatus.COMPLETED,
                 stage=job.JobStage.FINALIZING)
    s.set_stage("job-2", job.JobStage.EMBEDDING)
    out += [s.get_job_row(f"job-{i}") for i in range(5)]
    out += [s.get_job_row("absent"), s.stats(),
            [s.queue_depth(q) for q in ("high", "normal", "low")],
            s.list_jobs(), s.list_jobs(tenant_id="tenant1"),
            s.list_jobs(status="running", limit=1, offset=1), s.health()]
    return out


def _ttls(pkg, clock):
    job = PKGS[pkg][0]
    s = PKGS[pkg][1].JobStore(":memory:")
    res = job.JobResult(job_id="a", status=job.JobStatus.COMPLETED,
                        num_chunks=3, metrics={"embed": 0.5},
                        completed_at=5.0)
    ck = job.JobCheckpoint(job_id="a", stage=job.JobStage.CHUNKING,
                           data={"ckpt_stage": "aligned", "segments": []},
                           updated_at=6.0)
    s.put_result(res, 10)
    s.put_checkpoint(ck, 20)
    s.put_idempotency("k1", "a", 15)
    out = [s.get_result("a"), s.get_checkpoint("a"),
           s.check_idempotency("k1"), s.check_idempotency("k2")]
    for dt in (9.0, 1.0, 5.0, 5.0):
        clock["t"] += dt
        out += [s.get_result("a"), s.get_checkpoint("a"),
                s.check_idempotency("k1")]
    out.append(s.cleanup_expired())
    s.put_checkpoint(ck, 20)
    s.delete_checkpoint("a")
    out += [s.get_checkpoint("a"), s.cleanup_expired()]
    return out


def _workers(pkg, clock):
    job = PKGS[pkg][0]
    s = PKGS[pkg][1].JobStore(":memory:")
    for i in range(4):
        s.insert_job(_job(pkg, i, created=float(i)), "normal")
    s.heartbeat("dead", {"jobs_processed": 1})
    s.heartbeat("live", {"platform": "cpu"})
    for w in ("dead", "dead", "live"):
        s.claim_next(w)
    s.claim_next("ghost")  # never sent a heartbeat
    out = [s.live_workers(), s.requeue_stale(300)]
    clock["t"] += 200.0
    s.heartbeat("live", {"platform": "cpu", "jobs_processed": 2})
    clock["t"] += 150.0
    out += [s.live_workers(300), s.requeue_stale(300),
            [s.get_job_row(f"job-{i}") for i in range(4)]]
    s.remove_worker("live")
    out += [s.live_workers(10_000), s.requeue_stale(300),
            s.stats(), s.get_job_row("job-0")["status"]
            == job.JobStatus.QUEUED.value]
    return out


def _rate(pkg, clock):
    s = PKGS[pkg][1].JobStore(":memory:")
    out = []
    for dt in (0.0, 0.5, 0.5, 2.0, 0.1, 0.9, 0.0, 3.0):
        clock["t"] += dt
        out.append((s.rate_limit_count("ip1", 2.0),
                    s.rate_limit_count("ip2", 1.0)))
    return out


@pytest.mark.parametrize("sequence", [_claims, _ttls, _workers, _rate],
                         ids=["claims", "ttls", "workers", "rate"])
def test_store_matches_jax(sequence, clock):
    start = clock["t"]
    got = _out(sequence("port", clock))
    clock["t"] = start
    want = _out(sequence("jax", clock))
    assert got == want


def test_store_file_is_wal_and_shared_across_threads(tmp_path):
    """On a file both stores set WAL, and a row written from another
    thread reads back (``check_same_thread=False`` under the lock)."""
    import threading

    for mod in (pstore, jstore):
        db = tmp_path / mod.__name__.split(".")[0] / "q.db"
        s = mod.JobStore(str(db))
        assert db.exists()
        (mode,) = s._conn.execute("PRAGMA journal_mode").fetchone()
        assert mode == "wal"
        t = threading.Thread(target=s.heartbeat, args=("w", {"a": 1}))
        t.start()
        t.join()
        assert set(s.live_workers()) == {"w"}
        s.close()


def test_job_json_reads_across_packages(tmp_path):
    """A JAX-written job, result and checkpoint read by the port and
    written back give the JAX text, and the other way round; the enums,
    the stage order, progress and the idempotency key agree."""
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"RIFF" + bytes(range(256)) * 10)
    for a, b in (("jax", "port"), ("port", "jax")):
        A, B = PKGS[a][0], PKGS[b][0]
        objs = [
            A.IngestJob("t1", str(wav), job_id="j", priority="high",
                        collection="c", metadata={"k": [1, "x"]},
                        config_overrides={"chunking.max_tokens": 77},
                        created_at=1.5),
            A.IngestJob("t1", "/missing.wav", job_id="j2", created_at=2.0),
            A.JobResult(job_id="j", status=A.JobStatus.FAILED, error="x",
                        metrics={"transcribe": 1.25}, completed_at=3.0),
            A.JobCheckpoint(job_id="j", stage=A.JobStage.EMBEDDING,
                            data={"ckpt_stage": "chunked", "chunks": []},
                            updated_at=4.0),
        ]
        for obj in objs:
            text = obj.to_json()
            back = getattr(B, type(obj).__name__).from_json(text)
            assert back.to_json() == text
    assert [s.value for s in pjob.STAGE_ORDER] == [
        s.value for s in jjob.STAGE_ORDER]
    for s in [*jjob.STAGE_ORDER, None, "nonsense", "indexing"]:
        assert pjob.calculate_progress(
            getattr(s, "value", s)) == jjob.calculate_progress(s)
    assert [pjob.get_next_stage(pjob.JobStage(s.value)) and
            pjob.get_next_stage(pjob.JobStage(s.value)).value
            for s in jjob.STAGE_ORDER] == [
        jjob.get_next_stage(s) and jjob.get_next_stage(s).value
        for s in jjob.STAGE_ORDER]
    assert {p.name: int(p) for p in pjob.Priority} == {
        p.name: int(p) for p in jjob.Priority}
    assert [s.is_terminal for s in pjob.JobStatus] == [
        s.is_terminal for s in jjob.JobStatus]
    assert pjob.IngestJob("t", str(wav)).idempotency_key == \
        jjob.IngestJob("t", str(wav)).idempotency_key


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:
        return (type(exc).__name__, str(exc), getattr(exc, "context", None),
                getattr(exc, "recoverable", None))


@pytest.fixture
def audio_files(tmp_path):
    sr = 16000
    wav = 0.1 * np.random.default_rng(0).standard_normal(sr * 3)
    files = {"ok": tmp_path / "ok.wav", "empty": tmp_path / "empty.wav",
             "ext": tmp_path / "notes.txt",
             "corrupt": tmp_path / "corrupt.wav",
             "mp3": tmp_path / "noise.mp3"}
    write_wav(files["ok"], wav.astype(np.float32), sr)
    files["empty"].write_bytes(b"")
    files["ext"].write_text("hello")
    files["corrupt"].write_bytes(b"not a wav at all")
    files["mp3"].write_bytes(b"\x00" * 64)
    files["missing"] = tmp_path / "missing.wav"
    return {k: str(v) for k, v in files.items()}


def test_validators_match_jax(audio_files):
    """The same verdicts, messages and contexts for files (a failing
    duration probe is warn-only) and tenants, strict and simple."""
    cases = []
    for pkg in ("port", "jax"):
        V = PKGS[pkg][4]
        out = []
        for name, path in sorted(audio_files.items()):
            for kw in ({}, {"max_bytes": 1000}, {"max_duration_s": 2.0}):
                out.append(_outcome(V.AudioValidator(**kw).validate, path))
        tenants = ["audio_rag_mit_cs_6034_fall24", "simple-tenant", "ab",
                   "Upper", "x" * 70, "", "audio_rag_a_b_c", "ok_name_2"]
        for strict in (False, True):
            tv = V.TenantValidator(strict=strict)
            out += [_outcome(tv.validate, t) for t in tenants]
        out.append(_outcome(lambda: dataclasses.asdict(
            V.TenantValidator.parse("audio_rag_mit_cs_6034_fall24"))))
        out.append(_outcome(V.TenantValidator.parse, "simple"))
        out.append(V.TenantValidator.build("u", "d", "c", "s"))
        job = PKGS[pkg][0].IngestJob("bad tenant", audio_files["ok"])
        out.append(_outcome(V.JobValidator().validate, job))
        out.append(_outcome(V.JobValidator(strict_tenants=True).validate,
                            PKGS[pkg][0].IngestJob("t-1",
                                                   audio_files["ok"])))
        cases.append(out)
    assert cases[0] == cases[1]


def _queue_ops(pkg, files, clock):
    job, store, queue, config, _ = PKGS[pkg]
    cfg = config.QueueConfig(
        queues=[config.QueueDefinition(name="high", max_depth=2),
                config.QueueDefinition(name="normal", max_depth=1),
                config.QueueDefinition(name="low", max_depth=5)])
    q = queue.AudioRAGQueue(cfg, store=store.JobStore(":memory:"))
    out = []

    def enqueue(i, path, prio, **kw):
        clock["t"] += 1.0
        return _outcome(q.enqueue, job.IngestJob(
            f"tenant-{i}", path, job_id=f"j{i}", priority=prio,
            created_at=clock["t"]), **kw)

    out.append(enqueue(0, files["ok"], "HIGH"))
    out.append(enqueue(1, files["ok"], "HIGH"))  # another tenant
    out.append(enqueue(0, files["ok"], "LOW"))  # the same key: duplicate
    out.append(enqueue(2, files["missing"], "NORMAL"))
    out.append(enqueue(3, files["missing"], "NORMAL", validate=False))
    out.append(enqueue(4, files["empty"], "NORMAL", validate=False))
    out.append(enqueue(5, files["corrupt"], "CRITICAL", validate=False))
    out.append(enqueue(6, files["mp3"], "HIGH", validate=False))
    out += [_outcome(q.get_status, "j0"), _outcome(q.get_status, "nope"),
            _outcome(q.cancel, "j1"), _outcome(q.cancel, "j1"),
            _outcome(q.cancel, "nope"), _outcome(q.get_status, "j1"),
            q.get_result("j0"), q.get_queue_stats(), q.health()]
    q.store.heartbeat("w", {"platform": "cpu"})
    q.store.claim_next("w")
    q.store.set_status("j0", job.JobStatus.COMPLETED,
                       stage=job.JobStage.FINALIZING)
    out += [_outcome(q.get_status, "j0"), q.get_queue_stats()]
    return out


def test_queue_matches_jax(audio_files, clock):
    start = clock["t"]
    got = _out(_queue_ops("port", audio_files, clock))
    clock["t"] = start
    want = _out(_queue_ops("jax", audio_files, clock))
    assert got == want


def test_queue_yaml_reads_as_the_jax_config():
    """``configs/queue.yaml`` through the port's reader gives the JAX
    ``QueueConfig(**yaml.safe_load(...))``; the defaults agree too."""
    path = CONFIGS / "queue.yaml"
    got = pconfig.load_queue_config(path)
    want = jconfig.QueueConfig(**yaml.safe_load(path.read_text()))
    assert dataclasses.asdict(got) == want.model_dump()
    assert dataclasses.asdict(pconfig.QueueConfig()) == \
        jconfig.QueueConfig().model_dump()
    for name in ("HIGH", "critical", "Normal", "LOW", "other"):
        assert got.queue_for_priority(name).name == \
            want.queue_for_priority(name).name
    mapping = {"worker": {"batch_claim": "3", "poll_interval_s": 1,
                          "unknown": 1}, "storage": {"db_path": "x.db"},
               "queues": [{"name": "only", "timeout_s": 5.0}], "extra": 2}
    assert dataclasses.asdict(pconfig.QueueConfig.from_dict(mapping)) == \
        jconfig.QueueConfig(**mapping).model_dump()


@pytest.mark.parametrize("section,key,value", [
    ("worker", "batch_claim", 0), ("worker", "batch_claim", 17),
    ("worker", "poll_interval_s", 0), ("worker", "max_hbm_gb", 0.5),
    ("worker", "heartbeat_ttl_s", 0), ("storage", "result_ttl_s", 0),
    ("queues", "max_depth", 0), ("worker", "batch_claim", "many")])
def test_queue_config_bounds_match_jax(section, key, value):
    """A value out of the JAX model's bounds is refused by both."""
    data = ({"queues": [{"name": "q", key: value}]} if section == "queues"
            else {section: {key: value}})
    with pytest.raises(Exception):
        jconfig.QueueConfig(**data)
    with pytest.raises(ConfigError):
        pconfig.QueueConfig.from_dict(data)
