"""The port's keyed coalescer (``utils/coalescer.py``) and query coalescer
(``engine/query_coalescer.py``): the behaviours the JAX package's
``tests/unit/utils/test_coalescer.py`` and
``tests/unit/engine/test_query_coalescer.py`` hold its own to, one
parametrised case each, the port's ``call`` hook, and the query
coalescer's ``run_in`` and ``linger_s`` against the JAX one's."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from audio_rag_tpu.engine.query_coalescer import (
    QueryCoalescer as JaxQueryCoalescer,
)
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    AudioRAGConfig,
    EmbeddingConfig,
    RerankingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.core.types import AudioChunk
from audio_rag_tpu_torch.engine.query_coalescer import QueryCoalescer
from audio_rag_tpu_torch.pipeline import AudioRAG
from audio_rag_tpu_torch.utils.coalescer import KeyedCoalescer
from torch_llm_common import one_torch_thread  # noqa: F401


class SquareCoalescer(KeyedCoalescer):
    worker_name = "square"

    def __init__(self, max_batch=8, linger_s=0.0, delay_s=0.0):
        self.delay_s = delay_s
        self.batches: list[tuple] = []
        super().__init__(max_batch=max_batch, linger_s=linger_s)

    def _run_batch(self, payloads, key):
        if key == ("bad",):
            raise ValueError("boom")
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batches.append((key, len(payloads)))
        return [p * p for p in payloads]


def _batches_while_in_flight():
    c = SquareCoalescer(max_batch=8, delay_s=0.02)
    try:
        futs = [c._submit(i, ()) for i in range(12)]
        assert [f.result(timeout=10) for f in futs] == \
            [i * i for i in range(12)]
        assert c.items_served == 12
        assert c.batches_run < 12, "nothing coalesced"
    finally:
        c.stop()


def _keys_never_mix():
    c = SquareCoalescer(max_batch=8, delay_s=0.01)
    try:
        futs = [c._submit(i, (i % 3,)) for i in range(15)]
        assert [f.result(timeout=10) for f in futs] == \
            [i * i for i in range(15)]
        served = {k: 0 for k in ((0,), (1,), (2,))}
        for key, n in c.batches:
            served[key] += n
        assert served == {(0,): 5, (1,): 5, (2,): 5}
    finally:
        c.stop()


def _failing_batch_spares_the_worker():
    c = SquareCoalescer(max_batch=4)
    try:
        with pytest.raises(ValueError, match="boom"):
            c._submit(1, ("bad",)).result(timeout=10)
        assert c._submit(3, ("ok",)).result(timeout=10) == 9
    finally:
        c.stop()


def _submit_after_stop_raises():
    c = SquareCoalescer()
    c.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        c._submit(1, ())
    c.stop()  # idempotent


def _linger_gathers_staggered_arrivals():
    c = SquareCoalescer(max_batch=8, linger_s=0.08)
    try:
        futs = []
        for i in range(4):
            futs.append(c._submit(i, ()))
            time.sleep(0.01)
        [f.result(timeout=10) for f in futs]
        assert c.batches_run == 1 and c.items_served == 4
    finally:
        c.stop()


def _every_accepted_submission_resolves():
    """submit() hammered from 4 threads while stop() fires: every future
    whose submit did not raise resolves (a result or the stop error)."""
    for _ in range(10):
        c = SquareCoalescer(max_batch=8, delay_s=0.001)
        futs: list = []
        done = threading.Event()

        def submitter():
            i = 0
            while not done.is_set():
                try:
                    futs.append(c._submit(i, (i % 2,)))
                except RuntimeError:
                    return
                i += 1

        threads = [threading.Thread(target=submitter) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.01)
        c.stop()
        done.set()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            f.exception(timeout=10)  # a timeout here is the leak


def _call_runs_on_the_worker_between_batches():
    c = SquareCoalescer(max_batch=4, delay_s=0.01)
    try:
        futs = [c._submit(i, ()) for i in range(6)]
        name = c.call(lambda: threading.current_thread().name)
        assert name.result(timeout=10) == "square"
        with pytest.raises(ZeroDivisionError):
            c.call(lambda: 1 / 0).result(timeout=10)
        assert [f.result(timeout=10) for f in futs] == \
            [i * i for i in range(6)]
        assert c.items_served == 6  # calls are not items
    finally:
        c.stop()


@pytest.mark.parametrize("case", [
    _batches_while_in_flight, _keys_never_mix,
    _failing_batch_spares_the_worker, _submit_after_stop_raises,
    _linger_gathers_staggered_arrivals, _every_accepted_submission_resolves,
    _call_runs_on_the_worker_between_batches,
], ids=lambda f: f.__name__.strip("_"))
def test_keyed_coalescer(case):
    case()


# -- the query coalescer -----------------------------------------------------------

WORDS = ("gradient descent loss spectrogram harmonic attention token layer "
         "model search hybrid window speech audio chunk query").split()
QUERIES = [f"{WORDS[i % 16]} {WORDS[(i * 5 + 3) % 16]}" for i in range(12)]


@pytest.fixture(scope="module")
def rag():
    if not (ASSETS_DIR / "retr_embedder_small.npz").exists():
        pytest.skip("trained embedder asset not built")
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(backend="none"), device="cpu"))
    texts = [" ".join(WORDS[(i * 3 + k) % 16] for k in range(6))
             for i in range(16)]
    chunks = [AudioChunk(t, 5.0 * i, 5.0 * i + 5.0, chunk_id=f"c{i}")
              for i, t in enumerate(texts)]
    rag.store.add(chunks, rag.embedder.embed(texts), "coalesce")
    return rag


def _ids(result):
    return [r.chunk_id for r in result.results]


def _matches_single_queries(rag):
    want = {q: _ids(rag.query(q, top_k=3, collection="coalesce"))
            for q in QUERIES}
    c = QueryCoalescer(rag)
    try:
        futs = [c.submit(q, top_k=3, collection="coalesce") for q in QUERIES]
        got = {q: _ids(f.result(timeout=60)) for q, f in zip(QUERIES, futs)}
    finally:
        c.stop()
    assert got == want
    assert c.requests_served == len(QUERIES)
    assert c.batches_run <= len(QUERIES)


def _concurrent_submits_coalesce(rag):
    c = QueryCoalescer(rag)
    results = {}
    gate = threading.Barrier(len(QUERIES))

    def worker(q):
        gate.wait(timeout=10)
        results[q] = c.query(q, top_k=3, collection="coalesce")

    try:
        threads = [threading.Thread(target=worker, args=(q,))
                   for q in QUERIES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        c.stop()
    assert len(results) == len(QUERIES)
    assert all(r.results for r in results.values())
    assert c.batches_run < c.requests_served


def _mixed_keys_all_served(rag):
    c = QueryCoalescer(rag)
    try:
        futs = [c.submit(QUERIES[i], top_k=3 if i % 2 == 0 else 5,
                         collection="coalesce") for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
    finally:
        c.stop()
    for i, out in enumerate(outs):
        assert len(out.results) == (3 if i % 2 == 0 else 5)


def _error_fails_its_batch(rag):
    calls = []

    def broken(*args, **kw):
        calls.append(args)
        raise RuntimeError("device boom")

    c = QueryCoalescer(rag)
    rag.query_batch = broken
    try:
        with pytest.raises(RuntimeError, match="device boom"):
            c.query(QUERIES[0], collection="coalesce")
        assert len(calls) == 1
        del rag.query_batch
        # the worker survives its failed batch
        assert c.query(QUERIES[0], top_k=3, collection="coalesce").results
    finally:
        rag.__dict__.pop("query_batch", None)
        c.stop()


@pytest.mark.parametrize("case", [
    _matches_single_queries, _concurrent_submits_coalesce,
    _mixed_keys_all_served, _error_fails_its_batch,
], ids=lambda f: f.__name__.strip("_"))
def test_query_coalescer(rag, case):
    case(rag)


class _RecordingPipeline:
    """A ``query_batch`` provider that records the thread and the size of
    each batch."""

    def __init__(self):
        self.calls: list[tuple[str, int]] = []

    def query_batch(self, queries, **kw):
        self.calls.append((threading.current_thread().name, len(queries)))
        return [f"hits of {q} at {kw['top_k']}" for q in queries]


def _trickle(cls, linger_s: float, gap_s: float = 0.01):
    """Six queries submitted ``gap_s`` apart to a ``cls`` coalescer whose
    batches run on a one-thread "device" executor."""
    pipe = _RecordingPipeline()
    with ThreadPoolExecutor(1, thread_name_prefix="device") as device:
        c = cls(pipe, run_in=lambda fn: device.submit(fn).result(),
                linger_s=linger_s)
        try:
            futs = []
            for q in QUERIES[:6]:
                futs.append(c.submit(q, top_k=3))
                time.sleep(gap_s)
            got = [f.result(timeout=10) for f in futs]
        finally:
            c.stop()
    return got, pipe.calls


def test_query_coalescer_runs_in_the_executor_and_lingers_as_jax():
    """The API passes its device executor (``run_in``) and a linger
    (``linger_s``): every batch runs on the executor's thread, and a
    trickle of arrivals 10 ms apart fills one batch under a 250 ms linger,
    as the JAX coalescer does on the same arrivals."""
    got, calls = _trickle(QueryCoalescer, linger_s=0.25)
    want, jax_calls = _trickle(JaxQueryCoalescer, linger_s=0.25)
    assert got == want == [f"hits of {q} at 3" for q in QUERIES[:6]]
    assert calls == jax_calls == [("device_0", 6)]
