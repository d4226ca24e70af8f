"""The port's API (``audio_rag_tpu_torch/api``) against the JAX package's
(``audio_rag_tpu/api``): one server of each on fake backends, built as
``tests/integration/test_api.py`` builds its own (the port's pipeline on
the CPU), both on 127.0.0.1 at a port the OS picks, sent the same table
of requests through standard-library clients (``tests/torch_api_client``).
Each pair of answers has the same status, the same header names and the
same JSON body, but for the values that change from run to run (request,
job and chunk ids (also inside messages), timestamps, elapsed and stage
seconds, spooled file paths); scores within 1e-5. Validation errors compare by status and
``loc`` lists: the port's ``msg`` texts are its own (ROADMAP §3).

Also: the rate limiter at 2 queries a minute (429 and ``retry-after``
over HTTP, failing open on a closed store as
``tests/unit/api/test_rate_limit.py`` holds the JAX one), ``/metrics``
(the same metric names but the JAX engine's compiled-program gauge,
every line parsing, the auth gate, a route counter moving by one, a
failing gauge logged), the query coalescer (batches on the app's device
executor), the WebSocket route (the same transcripts, 4401, 4429), the
idle reaper (the sleep patched, its interval the JAX formula's) and the
web UI's files."""

import asyncio
import base64
import concurrent.futures as cf
import io
import json
import logging
import re
import struct
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np
import pytest

from audio_rag_tpu.api import deps as jdeps
from audio_rag_tpu.api.app import create_app as jax_create_app
from audio_rag_tpu.api.config import APIConfig as JaxAPIConfig
from audio_rag_tpu.api.config import RateLimitTier as JaxTier
from audio_rag_tpu.api.http import Request as JaxRequest
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config import loader as jloader
from audio_rag_tpu.jobqueue.config import QueueConfig as JaxQueueConfig
from audio_rag_tpu.jobqueue.config import StorageConfig as JaxStorageConfig
from audio_rag_tpu.jobqueue.queue import AudioRAGQueue as JaxQueue
from audio_rag_tpu.jobqueue.store import JobStore as JaxJobStore
from audio_rag_tpu.jobqueue.worker import TPUWorker
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu.resources import manager as jmanager
from audio_rag_tpu_torch.api import create_app
from audio_rag_tpu_torch.api import deps as tdeps
from audio_rag_tpu_torch.api import metrics as tmetrics
from audio_rag_tpu_torch.api.config import APIConfig, RateLimitTier
from audio_rag_tpu_torch.api.http import HTTPError, Request
from audio_rag_tpu_torch.config import load_config
from audio_rag_tpu_torch.jobqueue.config import QueueConfig, StorageConfig
from audio_rag_tpu_torch.jobqueue.queue import AudioRAGQueue
from audio_rag_tpu_torch.jobqueue.store import JobStore
from audio_rag_tpu_torch.jobqueue.worker import GPUWorker
from audio_rag_tpu_torch.pipeline import AudioRAG
from audio_rag_tpu_torch.resources import manager as tmanager
from torch_api_client import (
    Served,
    WSClient,
    multipart,
    parse_metrics,
    request,
    request_json,
)
from torch_ledger_common import reset_ledgers
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NOWHERE = ROOT / "configs" / "no-such-dir"  # no base.yaml: defaults only
KEY = {"x-api-key": "dev-key-basic"}
TINY = {"x-api-key": "tiny-key"}

#: ``tests/integration/test_api.py``'s ``make_rag`` (the port's on the CPU)
FAKE = {
    "asr": {"backend": "fake"},
    "diarization": {"backend": "fake"},
    "embedding": {"backend": "fake"},
    "retrieval": {"backend": "tpu", "capacity_step": 128},
    "reranking": {"backend": "fake"},
    "generation": {"backend": "fake"},
    "tts": {"backend": "null"},
    "device": "cpu",
}
#: values that change from run to run, left out of the comparison
VOLATILE = {"request_id", "job_id", "existing_job_id", "created_at",
            "updated_at", "elapsed_s", "chunk_id", "path",
            "processing_time_ms"}
#: a job id inside a message
_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                   r"[0-9a-f]{12}")
#: {name: seconds} maps: only their names are compared
TIMINGS = {"stage_timings", "metrics"}


def _api_config(cls, tier_cls, tmp: Path):
    cfg = cls(upload_dir=str(tmp / "uploads"), queue_db_path=":memory:")
    cfg.api_keys["tiny-key"] = {"tenant_id": "t_tiny", "tier": "tiny"}
    cfg.tiers["tiny"] = tier_cls(query_per_minute=2, ingest_per_hour=1,
                                 status_per_minute=100)
    return cfg


def _queue(qcls, scls, queue_cls, store_cls):
    qcfg = qcls(storage=scls(db_path=":memory:"))
    qcfg.worker.preload_models = False
    return queue_cls(qcfg, store=store_cls(":memory:"))


class Side:
    """One package's pipeline, queue, app and server."""

    def __init__(self, rag, queue, app, worker_cls):
        self.rag, self.queue, self.app = rag, queue, app
        self.worker_cls = worker_cls
        self.served = Served(app)
        self.port = self.served.port

    def run_worker_once(self) -> bool:
        return self.worker_cls(self.queue.config, store=self.queue.store,
                               rag_factory=lambda: self.rag).run_once()


class Pair:
    def __init__(self, jax: Side, port: Side):
        self.jax, self.port = jax, port

    def call(self, method, path, payload=None, headers=KEY, raw=None):
        return tuple(request_json(s.port, method, path, payload,
                                  dict(headers or {}), raw)
                     for s in (self.jax, self.port))

    def raw(self, method, path, body=None, headers=KEY):
        return tuple(request(s.port, method, path, body, dict(headers or {}))
                     for s in (self.jax, self.port))

    def same(self, method, path, payload=None, headers=KEY, raw=None):
        """Both answers, held equal; returns the port's."""
        j, p = self.call(method, path, payload, headers, raw)
        assert_same_answer(j, p)
        return p


def same(a, b, where="body"):
    """``a`` and ``b`` equal but for VOLATILE values, TIMINGS' seconds and
    numbers within 1e-5; mappings keep the same keys in the same order."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            if k in VOLATILE:
                continue
            if k in TIMINGS and isinstance(a[k], dict):
                assert set(a[k]) == set(b[k]), (f"{where}.{k}", a[k], b[k])
            else:
                same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif (isinstance(a, (int, float)) and isinstance(b, (int, float))
          and not isinstance(a, bool) and not isinstance(b, bool)):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(a)), (where, a, b)
    elif isinstance(a, str) and isinstance(b, str):
        assert _UUID.sub("<id>", a) == _UUID.sub("<id>", b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def assert_same_answer(j, p):
    (js, jh, jb), (ps, ph, pb) = j, p
    assert js == ps, (js, jb, ps, pb)
    assert set(jh) == set(ph), (sorted(jh), sorted(ph))
    same(jb, pb)


def wav_bytes(seed=0, seconds=2.0, suffix=b"") -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(
            (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 3000).astype("<i2").tobytes())
    return buf.getvalue() + suffix


def declared_wav(declared: int, present: int = 64) -> bytes:
    """A WAV whose data chunk declares ``declared`` bytes at 8 kHz, 8-bit
    mono, followed by ``present``."""
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
    return (b"RIFF" + struct.pack("<I", 36 + declared) + b"WAVE" + b"fmt "
            + struct.pack("<I", 16) + fmt + b"data"
            + struct.pack("<I", declared) + b"\x80" * present)


def upload(pair, filename, data, fields=None, headers=KEY):
    body, ctype = multipart(fields or {}, [("file", filename, data,
                                           "audio/wav")])
    return pair.call("POST", "/api/v1/ingest",
                     headers={**headers, "content-type": ctype}, raw=body)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api")
    reset_ledgers()  # whatever an earlier module left in either package
    jrag = JaxAudioRAG(jloader.load_config(configs_dir=NOWHERE,
                                           overrides=FAKE))
    prag = AudioRAG(load_config(configs_dir=NOWHERE, overrides=FAKE))
    audio = 0.1 * np.random.default_rng(0).standard_normal(
        16000 * 10).astype(np.float32)
    write_wav(tmp / "x.wav", audio, 16000)
    for rag in (jrag, prag):  # the seeded corpus of test_api.py
        rag.ingest(str(tmp / "x.wav"))
    jq = _queue(JaxQueueConfig, JaxStorageConfig, JaxQueue, JaxJobStore)
    pq = _queue(QueueConfig, StorageConfig, AudioRAGQueue, JobStore)
    jax_side = Side(jrag, jq, jax_create_app(
        _api_config(JaxAPIConfig, JaxTier, tmp / "jax"), rag=jrag, queue=jq),
        TPUWorker)
    port_side = Side(prag, pq, create_app(
        _api_config(APIConfig, RateLimitTier, tmp / "port"), rag=prag,
        queue=pq), GPUWorker)
    pair = Pair(jax_side, port_side)
    pair.seeded = str(tmp / "x.wav")
    yield pair
    for side in (jax_side, port_side):
        side.served.stop()
    jrag.unload_all()


# -- auth, probes, routing -------------------------------------------------------------

@pytest.mark.parametrize("method,path,payload,headers", [
    ("POST", "/api/v1/query", {"query": "x"}, {}),
    ("POST", "/api/v1/query", {"query": "x"}, {"x-api-key": "nope"}),
    ("GET", "/health/live", None, {"x-request-id": "rid-123"}),
    ("GET", "/health/ready", None, {}),
    ("GET", "/health/startup", None, {}),
    ("GET", "/api", None, {}),
    ("GET", "/api/v1/nope", None, KEY),
    ("GET", "/api/v1/query", None, KEY),
    ("OPTIONS", "/api/v1/query", None, {"origin": "http://ui"}),
    ("GET", "/api/v1/collections/zzz", None, KEY),
    ("GET", "/api/v1/jobs/doesnotexist", None, KEY),
    ("GET", "/api/v1/jobs?limit=abc", None, KEY),
], ids=["401", "403", "live+request-id", "ready", "startup", "api", "404",
        "405", "preflight", "collection-404", "job-404", "limit-422"])
def test_routes_answer_as_jax(pair, method, path, payload, headers):
    p = pair.same(method, path, payload, headers)
    if "x-request-id" in headers:
        assert p[1]["x-request-id"] == "rid-123"


# -- queries -------------------------------------------------------------------------------

@pytest.mark.parametrize("body", [
    {"query": "word0 word1", "search_type": "dense", "rerank": False},
    {"query": "word2 word3", "search_type": "hybrid", "top_k": 3},
    {"query": "word1", "search_type": "sparse", "include_context": True,
     "metadata_filter": {"source": "<seeded file>"}},
    {"query": "word0", "generate_answer": True},
    {"query": "word0", "use_hyde": True, "rerank": False},
], ids=["dense", "hybrid", "sparse+context+filter", "answer", "hyde"])
def test_queries_match_jax(pair, body):
    if "metadata_filter" in body:
        body = {**body, "metadata_filter": {"source": pair.seeded}}
    status, headers, out = pair.same("POST", "/api/v1/query", body)
    assert status == 200 and out["results"]
    assert {"x-ratelimit-limit", "x-ratelimit-remaining",
            "x-ratelimit-reset"} <= set(headers)
    if body.get("generate_answer"):
        assert "fake answer" in out["answer"]


def test_spoken_answer_decodes_as_jax(pair):
    j, p = pair.call("POST", "/api/v1/query",
                     {"query": "word0", "generate_answer": True,
                      "speak_answer": True})
    assert j[0] == p[0] == 200

    def params(body):
        with wave.open(io.BytesIO(base64.b64decode(
                body["answer_audio_b64"]))) as wf:
            return (wf.getnchannels(), wf.getsampwidth(), wf.getframerate(),
                    wf.getnframes())

    assert params(p[2]) == params(j[2])
    assert params(p[2])[3] > 0
    j[2]["answer_audio_b64"] = p[2]["answer_audio_b64"] = None
    assert_same_answer(j, p)


#: each body, and what the JAX server answers it with (status, locs)
VALIDATION = [
    ({"query": ""}, 422, [["query"]]),
    ({"query": "x" * 4097}, 422, [["query"]]),
    ({"query": "x", "top_k": 0}, 422, [["top_k"]]),
    ({"query": "x", "top_k": 101}, 422, [["top_k"]]),
    ({"query": "x", "top_k": "5"}, 200, None),
    ({"query": "x", "top_k": 2.5}, 422, [["top_k"]]),
    ({"query": "x", "search_type": "x"}, 422, [["search_type"]]),
    ({"query": "x", "rerank": "yes"}, 200, None),
    ({"query": "x", "rerank": "maybe"}, 422, [["rerank"]]),
    ({"query": None, "top_k": "x", "search_type": 3}, 422,
     [["query"], ["top_k"], ["search_type"]]),
    ({}, 422, [["query"]]),
    ({"top_k": 3}, 422, [["query"]]),
    ({"query": "x", "undeclared": 1}, 200, None),
    ({"query": "x", "metadata_filter": [1]}, 422, [["metadata_filter"]]),
]


@pytest.mark.parametrize("body,status,locs", VALIDATION,
                         ids=[f"v{i}" for i in range(len(VALIDATION))])
def test_validation_matches_jax(pair, body, status, locs):
    j, p = pair.call("POST", "/api/v1/query", body)
    assert j[0] == p[0] == status, (j, p)
    if locs is None:
        assert_same_answer(j, p)
        return
    for out in (j[2], p[2]):
        assert out["error"] == "validation_error"
        assert [e["loc"] for e in out["detail"]] == locs
        assert all(e["msg"] for e in out["detail"])


@pytest.mark.parametrize("raw,status", [
    (b"[1, 2]", 500), (b"{not json", 400), (b"", 422)],
    ids=["json-list", "malformed", "empty"])
def test_bodies_that_are_not_objects_match_jax(pair, raw, status):
    j, p = pair.call("POST", "/api/v1/query", raw=raw,
                     headers={**KEY, "content-type": "application/json"})
    assert j[0] == p[0] == status
    assert_same_answer(j, p)


def test_rate_limit_matches_jax(pair):
    """At 2 queries a minute (the tier of ``tests/unit/api/
    test_rate_limit.py``) the third query is refused with 429 and
    ``retry-after``."""
    answers = [pair.call("POST", "/api/v1/query",
                         {"query": "word0", "rerank": False}, TINY)
               for _ in range(3)]
    for (j, p), status in zip(answers, (200, 200, 429)):
        assert j[0] == p[0] == status
        assert_same_answer(j, p)
    (_, jh, _), (_, ph, _) = answers[2]
    assert jh["retry-after"] == ph["retry-after"] == "60"
    assert ph["x-ratelimit-remaining"] == "0"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_rate_limit_fails_open_on_a_closed_store(pkg):
    deps, req_cls, cfg_cls, tier_cls, store_cls = (
        (jdeps, JaxRequest, JaxAPIConfig, JaxTier, JaxJobStore)
        if pkg == "jax" else
        (tdeps, Request, APIConfig, RateLimitTier, JobStore))
    cfg = cfg_cls()
    cfg.api_keys = {"k1": {"tenant_id": "t1", "tier": "tiny"}}
    cfg.tiers["tiny"] = tier_cls(query_per_minute=2)
    store = store_cls(":memory:")
    req = req_cls(method="POST", path="/api/v1/query", query={},
                  headers={"x-api-key": "k1"})
    deps.authenticate(req, cfg)
    store.close()
    deps.check_rate_limit(req, cfg, "query", store)  # no raise
    assert "rate_headers" not in req.context


def test_auth_errors_are_the_jax_ones():
    cfg = APIConfig()
    with pytest.raises(HTTPError) as ei:
        tdeps.authenticate(Request("GET", "/", {}, {}), cfg)
    assert ei.value.status == 401
    with pytest.raises(HTTPError) as ei:
        tdeps.authenticate(Request("GET", "/", {}, {"x-api-key": "no"}), cfg)
    assert ei.value.status == 403


# -- the query coalescer ---------------------------------------------------------------

def test_concurrent_queries_coalesce_on_the_device_executor(pair):
    """Six concurrent search-only queries return their sequential ids
    (and, across packages, the same texts); each server's coalescer has
    served 12 or more, every batch on the app's device executor."""
    out = {}
    for name, side in (("jax", pair.jax), ("port", pair.port)):
        threads: list[str] = []
        q = side.rag.querying
        orig = q.query_batch

        def spy(*a, _orig=orig, **kw):
            threads.append(threading.current_thread().name)
            return _orig(*a, **kw)

        q.query_batch = spy
        try:
            def ask(text, port=side.port):
                s, _, body = request_json(
                    port, "POST", "/api/v1/query",
                    {"query": text, "rerank": False, "top_k": 3}, KEY)
                assert s == 200
                return body["results"]

            words = [f"word{i}" for i in range(6)]
            sequential = [ask(w) for w in words]
            with cf.ThreadPoolExecutor(max_workers=6) as pool:
                concurrent = list(pool.map(ask, words))
        finally:
            del q.query_batch
        assert [[r["chunk_id"] for r in rs] for rs in concurrent] == [
            [r["chunk_id"] for r in rs] for rs in sequential]
        c = side.app.state["query_coalescer"]
        assert c.requests_served >= 12
        assert threads and set(threads) == {"device_0"}, threads
        out[name] = concurrent
    same(out["jax"], out["port"])


# -- ingest, jobs, queue ---------------------------------------------------------------

def test_upload_queues_and_the_worker_completes_it_as_jax(pair):
    j, p = upload(pair, "lecture.wav", wav_bytes(),
                  {"priority": "high", "collection": "lectures",
                   "metadata": json.dumps({"course": "cs229"})})
    assert j[0] == p[0] == 202
    assert_same_answer(j, p)
    assert p[2]["queue"] == "high" and p[2]["collection"] == "lectures"
    ids = j[2]["job_id"], p[2]["job_id"]
    st = [request_json(s.port, "GET", f"/api/v1/jobs/{i}", headers=KEY)
          for s, i in zip((pair.jax, pair.port), ids)]
    assert_same_answer(*st)
    assert st[1][2]["status"] == "queued"
    assert pair.jax.run_worker_once() and pair.port.run_worker_once()
    done = [request_json(s.port, "GET", f"/api/v1/jobs/{i}", headers=KEY)
            for s, i in zip((pair.jax, pair.port), ids)]
    assert_same_answer(*done)
    assert done[1][2]["status"] == "completed"
    assert done[1][2]["result"]["num_chunks"] == \
        done[0][2]["result"]["num_chunks"] > 0


@pytest.mark.parametrize("filename,data,fields,status", [
    ("x.txt", b"hello", {}, 422),
    ("empty.wav", b"", {}, 422),
    ("bad.wav", wav_bytes(seed=3), {"metadata": "{not json"}, 422),
    ("cfg.wav", wav_bytes(seed=4), {"config": "[oops"}, 422),
    ("prio.wav", wav_bytes(seed=5), {"priority": "urgent"}, 422),
    ("long.wav", declared_wav(0xFFFFFF00), {}, 422),
    ("garbage.wav", b"RIFF not really a wave file", {}, 202),
], ids=["extension", "empty", "metadata", "config", "priority",
        "too-long", "undecodable"])
def test_rejected_uploads_match_jax(pair, filename, data, fields, status):
    j, p = upload(pair, filename, data, fields)
    assert j[0] == p[0] == status
    assert_same_answer(j, p)


def test_duplicate_cancel_and_listing_match_jax(pair):
    data = wav_bytes(seed=1, suffix=b"unique-suffix-dup-test")
    first = upload(pair, "dup.wav", data)
    second = upload(pair, "dup.wav", data)
    assert first[0][0] == first[1][0] == 202
    assert second[0][0] == second[1][0] == 409
    assert_same_answer(*second)
    for (_, _, a), (_, _, b) in zip(first, second):
        assert b["existing_job_id"] == a["job_id"]
    ids = first[0][2]["job_id"], first[1][2]["job_id"]
    for method, want in (("DELETE", 200), ("DELETE", 409), ("GET", 200)):
        answers = [request_json(s.port, method, f"/api/v1/jobs/{i}",
                                headers=KEY)
                   for s, i in zip((pair.jax, pair.port), ids)]
        assert answers[0][0] == answers[1][0] == want
        assert_same_answer(*answers)
    assert answers[1][2]["status"] == "cancelled"
    for path in ("/api/v1/jobs?limit=5", "/api/v1/jobs?limit=500",
                 "/api/v1/jobs?offset=1&limit=2",
                 "/api/v1/jobs?status=cancelled", "/api/v1/queue/stats"):
        p = pair.same("GET", path)
        assert p[0] == 200
    assert p[2]["queues"]["high"]["completed"] == 1
    assert pair.same("GET", "/api/v1/jobs?limit=500")[2]["limit"] == 100


# -- collections and status ----------------------------------------------------------------

def test_collections_match_jax(pair):
    listing = pair.same("GET", "/api/v1/collections")[2]["collections"]
    assert {c["name"] for c in listing} == {"audio_rag", "lectures"}
    assert pair.same("GET", "/api/v1/collections/audio_rag")[2]["count"] > 0
    assert pair.same("DELETE", "/api/v1/collections/lectures")[2] == {
        "deleted": "lectures"}
    assert pair.same("DELETE", "/api/v1/collections/lectures")[0] == 404
    assert pair.same("GET", "/api/v1/collections/lectures")[0] == 404


def test_status_has_the_jax_keys(pair):
    j, p = pair.call("GET", "/api/v1/status")
    assert j[0] == p[0] == 200
    assert list(j[2]) == list(p[2])
    assert j[2]["config"] == p[2]["config"]
    assert j[2]["collections"] == p[2]["collections"]
    assert p[2]["engine"]["device"]["type"] == "cpu"


# -- metrics -------------------------------------------------------------------------------

def _metrics(port, headers=None):
    status, hdrs, body = request(port, "GET", "/metrics",
                                 headers=headers or {})
    return status, hdrs, body.decode()


def test_metrics_names_match_jax_but_the_compiled_programs(pair):
    pair.same("POST", "/api/v1/query", {"query": "word0", "rerank": False})
    (js, jh, jtext), (ps, ph, ptext) = (_metrics(s.port)
                                        for s in (pair.jax, pair.port))
    assert js == ps == 200
    assert ph["content-type"] == jh["content-type"]
    jm, pm = parse_metrics(jtext), parse_metrics(ptext)  # every line parses
    names = {n for n, _ in pm}
    # departure: the port's engine keeps no compiled programs
    assert {n for n, _ in jm} - names == {"audio_rag_compiled_programs"}
    assert names - {n for n, _ in jm} == set()
    assert ("audio_rag_requests_total", (
        ("method", "POST"), ("route", "/api/v1/query"),
        ("status", "200"))) in pm
    assert pm[("audio_rag_hbm_budget_gb", ())] == \
        jm[("audio_rag_hbm_budget_gb", ())]
    for name in ("audio_rag_queue_depth", "audio_rag_engine_hbm_gb",
                 "audio_rag_uptime_seconds", "audio_rag_request_seconds_sum"):
        assert name in names


def test_metrics_auth_gate_and_route_counter_match_jax(pair):
    def live_count(text):
        return parse_metrics(text).get(("audio_rag_requests_total", (
            ("method", "GET"), ("route", "/health/live"),
            ("status", "200"))), 0.0)

    for side in (pair.jax, pair.port):
        before = live_count(_metrics(side.port)[2])
        request(side.port, "GET", "/health/live")
        assert live_count(_metrics(side.port)[2]) == before + 1
        cfg = side.app.state["config"]
        cfg.metrics_require_auth = True
        try:
            assert _metrics(side.port)[0] == 401
            assert _metrics(side.port, KEY)[0] == 200
        finally:
            cfg.metrics_require_auth = False


def test_a_failing_gauge_is_logged_and_left_out(pair, monkeypatch, caplog):
    """Departure: the JAX module drops a failing gauge silently."""
    def broken(*a, **k):
        raise RuntimeError("manager gone")

    monkeypatch.setattr(tmanager, "get_resource_manager", broken)
    with caplog.at_level(logging.WARNING, logger=tmetrics.__name__):
        names = {g[0] for g in tmetrics._gauges(pair.port.app)}
    assert "audio_rag_hbm_budget_gb" not in names
    assert "audio_rag_engine_hbm_gb" in names
    assert any("resources gauges failed" in r.getMessage()
               and "manager gone" in r.getMessage() for r in caplog.records)


# -- live transcription --------------------------------------------------------------

WS_PATH = "/api/v1/ws/transcribe"


def _session(port, frames, path=WS_PATH + "?api_key=dev-key-basic",
             headers=None):
    """Send ``frames``, then stop; every message until "stopped"."""
    with WSClient(port, path, headers) as ws:
        msgs = [ws.recv_json()]
        for f in frames:
            ws.send_bytes(f)
        ws.send_json({"command": "stop"})
        while msgs[-1].get("status") != "stopped":
            msgs.append(ws.recv_json())
    return msgs


def test_websocket_transcripts_match_jax(pair):
    pcm = (np.random.default_rng(0).standard_normal(16000) * 3000).astype(
        "<i2").tobytes()
    j = _session(pair.jax.port, [pcm] * 6)
    p = _session(pair.port.port, [pcm] * 6,
                 path=WS_PATH, headers=KEY)  # the key as a header
    same(j, p)
    assert p[0] == {"type": "status", "status": "listening"}
    texts = [m for m in p if m["type"] == "transcript"]
    assert len(texts) == 2 and texts[0]["text"] and \
        texts[0]["end"] > texts[0]["start"]
    pair.same("GET", "/api/v1/streaming/status")


def test_websocket_commands_match_jax(pair):
    """``reset``, an unknown command and a frame that is not JSON answer
    as the JAX route does, and the session goes on to ``stop``."""
    def commands(port):
        with WSClient(port, WS_PATH + "?api_key=dev-key-basic") as ws:
            msgs = [ws.recv_json()]
            for text in ('{"command": "reset"}', '{"command": "bogus"}',
                         "not json", '{"command": "stop"}'):
                ws.send_text(text)
                msgs.append(ws.recv_json())
        return msgs

    j, p = commands(pair.jax.port), commands(pair.port.port)
    assert j == p
    assert [m.get("status") or m.get("error") for m in p] == [
        "listening", "reset", "unknown command 'bogus'", "invalid JSON",
        "stopped"]


def _refused(port, path):
    with WSClient(port, path) as ws:
        msg = ws.recv_json()
        return msg, ws.recv()


def test_websocket_refusals_match_jax(pair):
    for side in (pair.jax, pair.port):
        msg, close = _refused(side.port, WS_PATH)
        assert msg == {"type": "error", "error": "unauthorized"}
        assert close == ("close", 4401)
        cfg = side.rag.config.streaming
        old, cfg.max_sessions = cfg.max_sessions, 1
        try:
            with WSClient(side.port,
                          WS_PATH + "?api_key=dev-key-basic") as ws1:
                assert ws1.recv_json()["status"] == "listening"
                msg, close = _refused(side.port,
                                      WS_PATH + "?api_key=dev-key-basic")
                assert msg == {"type": "error",
                               "error": "session limit 1 reached"}
                assert close == ("close", 4429)
                status = request_json(side.port, "GET",
                                      "/api/v1/streaming/status",
                                      headers=KEY)[2]
                assert status["sessions"] == 1 and status["active"]
                ws1.send_json({"command": "stop"})
                assert ws1.recv_json()["status"] == "stopped"
        finally:
            cfg.max_sessions = old


def test_sessions_on_two_loops_build_their_muxes(tmp_path):
    """Two apps served one after the other on two event loops in one
    process each build their mux under concurrent connections and stop
    it at shutdown (the route module's lock binds to neither loop)."""
    rag = AudioRAG(load_config(configs_dir=NOWHERE, overrides=FAKE))
    pcm = np.zeros(16000, "<i2").tobytes()
    for i in range(2):
        app = create_app(APIConfig(upload_dir=str(tmp_path),
                                   queue_db_path=":memory:"), rag=rag)
        with Served(app) as srv:
            with cf.ThreadPoolExecutor(3) as pool:
                runs = list(pool.map(
                    lambda _: _session(srv.port, [pcm]), range(3)))
        assert all(r[-1] == {"type": "status", "status": "stopped"}
                   for r in runs)
        assert app.state["streaming_mux"]._stopped


# -- the idle reaper, the web UI and the entry point -------------------------------------

class _Idle:
    unloaded = 0

    def unload(self):
        self.unloaded += 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_idle_reaper_evicts_an_idle_backend(pkg, tmp_path, monkeypatch):
    """The reaper sleeps ``max(idle / 4, 10)`` s (80 s idle: 20), then
    evicts what was idle longer than ``idle``; the sleep is patched."""
    if pkg == "jax":
        rag = JaxAudioRAG(jloader.load_config(configs_dir=NOWHERE,
                                              overrides=FAKE))
        app = jax_create_app(JaxAPIConfig(upload_dir=str(tmp_path),
                                          queue_db_path=":memory:"), rag=rag)
        mod = jmanager
    else:
        rag = AudioRAG(load_config(configs_dir=NOWHERE, overrides=FAKE))
        app = create_app(APIConfig(upload_dir=str(tmp_path),
                                   queue_db_path=":memory:"), rag=rag)
        mod = tmanager
    rag.config.resources.unload_after_idle_seconds = 80
    rm = mod.ResourceManager(14.0)
    monkeypatch.setattr(mod, "get_resource_manager", lambda *a: rm)
    idle, busy = _Idle(), _Idle()
    rm.register_model("idle", 1.0, idle)
    rm.register_model("busy", 1.0, busy)
    rm._models["idle"].last_used -= 1000
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)
        if len(sleeps) > 1:
            raise asyncio.CancelledError

    loop = asyncio.new_event_loop()
    try:
        monkeypatch.setattr(asyncio, "sleep", fake_sleep)
        for fn in app._on_startup:
            loop.run_until_complete(fn())
        with pytest.raises(asyncio.CancelledError):
            loop.run_until_complete(app.state["idle_reaper"])
    finally:
        monkeypatch.undo()
        loop.close()
    assert sleeps == [20.0, 20.0]
    assert (idle.unloaded, busy.unloaded) == (1, 0)
    assert set(rm._models) == {"busy"}


@pytest.mark.parametrize("path", ["/", "/app.js", "/styles.css",
                                  "/ui/index.html", "/ui/missing.js",
                                  "/ui/..", "/ui/..%2fREADME.md"])
def test_web_ui_files_match_jax(pair, path):
    """The UI's three files; nothing outside ``frontend/``."""
    j, p = pair.raw("GET", path, headers={})
    assert j[0] == p[0] and j[2] == p[2]
    assert j[1]["content-type"] == p[1]["content-type"]
    if "/ui/" in path and path != "/ui/index.html":
        assert p[0] == 404
    else:
        assert p[0] == 200 and p[2] == (
            ROOT / "frontend" / (path.rsplit("/", 1)[1] or "index.html")
        ).read_bytes()


def test_module_entry_point_runs_on_the_card_unless_told(tmp_path):
    """``python -m audio_rag_tpu_torch.api`` raises without a card by
    default, and serves on the CPU with ``AUDIO_RAG__DEVICE=cpu``."""
    import os
    import socket

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("AUDIO_RAG")}
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "audio_rag_tpu_torch.api", "--host",
           "127.0.0.1"]
    import torch

    if not torch.cuda.is_available():
        out = subprocess.run(cmd + ["--port", "1"], cwd=tmp_path, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(cmd + ["--port", str(port)], cwd=tmp_path,
                            env={**env, "AUDIO_RAG__DEVICE": "cpu"},
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, _, body = request_json(port, "GET", "/health/ready")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert status == 200 and body["status"] == "ready"
        status, _, body = request_json(port, "GET", "/api/v1/status",
                                       headers=KEY)
        assert status == 200 and body["engine"]["device"]["type"] == "cpu"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
