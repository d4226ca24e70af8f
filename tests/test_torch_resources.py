"""The port's device-memory manager and engine ledger against the JAX
package's: the JAX unit tests' manager scenarios (``tests/unit/core/
test_resources_engine.py``, ``test_pinning.py``) and failing unloads,
driven through both managers with the same sizes, clock and call sequence
(the same victims, errors, ``status()`` and ``eviction_count``); the
engine's ledger; each backend's estimate against the bytes it loads at the
tiny presets; ``AudioRAG``'s budget, pins, ``status`` and ``unload_all``;
a headed tiny-synth + eval-small ingest under a budget that cannot hold
the ASR and the generator together (it evicts and reloads, and stores the
chunks of the unbounded run and of the JAX pipeline); and an eviction of
the generator while its scheduler thread waits on the manager, which must
not deadlock. All comparisons are exact."""

import threading
import time
import types

import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxAudioRAGConfig
from audio_rag_tpu.config.schema import ContextualConfig as JaxCtxConfig
from audio_rag_tpu.config.schema import GenerationConfig as JaxGenConfig
from audio_rag_tpu.core.exceptions import ResourceError as JaxResourceError
from audio_rag_tpu.engine import engine as jax_engine
from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxLLM
from audio_rag_tpu.resources import manager as jax_manager
from audio_rag_tpu_torch.asr.whisper import WhisperASR
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    ASRConfig,
    AudioRAGConfig,
    ContextualConfig,
    DiarizationConfig,
    EmbeddingConfig,
    GenerationConfig,
    RerankingConfig,
    ResourceConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError, ResourceError
from audio_rag_tpu_torch.diarization.clustering import ClusteringDiarizer
from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
from audio_rag_tpu_torch.embeddings.e5 import E5Embedder
from audio_rag_tpu_torch.engine import engine as port_engine
from audio_rag_tpu_torch.engine.scheduler import ScheduledGenerator
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from audio_rag_tpu_torch.pipeline import AudioRAG
from audio_rag_tpu_torch.reranking.bge import BGEReranker
from audio_rag_tpu_torch.resources import manager as port_manager
from test_torch_generation import _Calls, _follow_calls, _replayed
from torch_ledger_common import fresh_ledger  # noqa: F401
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import _jax_rag, _port_rag, _turn_audio

PACKAGES = {"jax": (jax_manager, JaxResourceError),
            "port": (port_manager, ResourceError)}


class _Model:
    """A backend stand-in: its unload is logged, and may raise."""

    def __init__(self, name, log, fail=False):
        self.name, self.log, self.fail = name, log, fail

    def unload(self):
        self.log.append(self.name)
        if self.fail:
            raise RuntimeError(f"unload of {self.name} failed")


def _drive(pkg, ops, monkeypatch):
    """Run ``ops`` on a fresh manager of ``pkg`` at a clock that ticks
    once an op; returns every op's outcome, the unload log and the final
    status (without the card's counters)."""
    mod, _ = PACKAGES[pkg]
    clock = {"t": 100.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock["t"], perf_counter=time.perf_counter))
    rm = mod.ResourceManager(max_hbm_gb=10.0)
    unloads, out = [], []
    for op, *args in ops:
        clock["t"] += 1.0
        try:
            if op == "register":
                name, gb, *fail = args
                rm.register_model(name, gb, _Model(name, unloads, bool(fail)))
                rm._models[name].last_used = clock["t"]
                res = None
            elif op == "idle_since":  # the JAX pinning test's long idle
                rm._models[args[0]].last_used = args[1]
                res = None
            elif op == "ensure":
                res = rm.ensure_hbm(*args)
            else:
                res = getattr(rm, {"pin": "pin", "touch": "touch",
                                   "unregister": "unregister",
                                   "used": "used_gb", "fit": "can_fit",
                                   "idle": "evict_idle",
                                   "unload_all": "unload_all",
                                   "status": "status"}[op])(*args)
            if isinstance(res, dict):
                res.pop("device", None)
            out.append(("ok", res))
        except Exception as exc:
            out.append((type(exc).__name__, str(exc),
                        getattr(exc, "context", None)))
    status = rm.status()
    status.pop("device", None)
    return out, unloads, status, rm.eviction_count, sorted(rm.pinned_names)


#: the JAX unit tests' scenarios, and failing unloads
SCENARIOS = {
    "register_and_budget": [("register", "a", 4.0), ("used",),
                            ("ensure", 5.0), ("used",)],
    "lru_eviction": [("register", "a", 4.0), ("register", "b", 4.0),
                     ("touch", "a"), ("touch", "b"), ("ensure", 5.0),
                     ("used",), ("status",)],
    "lru_by_registration": [("register", "a", 2.0), ("register", "b", 3.0),
                            ("register", "c", 4.0), ("touch", "a"),
                            ("ensure", 6.0, "d"), ("ensure", 9.0, "a"),
                            ("status",)],
    "never_fits": [("ensure", 8.0), ("fit", 8.0), ("fit", 12.0),
                   ("register", "a", 1.0), ("ensure", 10.5, "b")],
    "protected_model": [("register", "a", 8.0), ("ensure", 4.0, "a"),
                        ("status",)],
    "empty_ledger_over_budget": [("register", "a", 11.0), ("unregister", "a"),
                                 ("register", "b", 12.0),
                                 ("ensure", 1.0, "b")],
    "unload_all": [("register", "m0", 1.0), ("register", "m1", 1.0),
                   ("register", "m2", 1.0), ("unload_all",), ("used",)],
    "unload_all_goes_past_a_failure": [
        ("register", "m0", 1.0), ("register", "m1", 1.0, "fail"),
        ("register", "m2", 1.0), ("unload_all",), ("status",)],
    "failing_eviction_raises_and_drops_the_entry": [
        ("register", "a", 6.0, "fail"), ("register", "b", 3.0),
        ("ensure", 5.0, "c"), ("status",), ("ensure", 5.0, "c")],
    "pinned_models_survive_eviction": [
        ("pin", "embeddings"), ("register", "embeddings", 3.0),
        ("register", "asr", 6.0), ("ensure", 7.0, "generation"),
        ("status",)],
    "only_pinned_left_fails_loudly": [
        ("pin", "embeddings"), ("register", "embeddings", 6.0),
        ("ensure", 8.0, "generation"), ("status",)],
    "pin_applies_to_future_registrations": [
        ("pin", "embeddings"), ("register", "embeddings", 3.0),
        ("unregister", "embeddings"), ("register", "embeddings", 3.0),
        ("status",), ("pin", "embeddings", False), ("status",),
        ("pin", "asr"), ("register", "asr", 6.0), ("ensure", 5.0, "x")],
    "idle_eviction_skips_pinned": [
        ("pin", "embeddings"), ("register", "embeddings", 3.0),
        ("register", "asr", 2.0), ("register", "gen", 1.0),
        ("idle_since", "embeddings", 0.0), ("idle", 3.5), ("idle", 0.0),
        ("idle", 1.5), ("status",)],
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_manager_matches_jax(scenario, monkeypatch):
    ops = SCENARIOS[scenario]
    got = _drive("port", ops, monkeypatch)
    want = _drive("jax", ops, monkeypatch)
    assert got == want


def test_engine_ledger_matches_jax():
    """put/get/drop and the GB figures of the same tensors; the port's
    status names the device where the JAX one names the mesh;
    ``bf16_storage`` casts the same leaves."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    trees = {"m": {"w": rng.standard_normal((128, 64)).astype(np.float32),
                   "q": [rng.integers(-127, 127, (32, 16)).astype(np.int8)]},
             "n": {"b": np.ones((3, 5), np.float32)}}
    jeng = jax_engine.InferenceEngine.from_config()
    peng = port_engine.InferenceEngine("cpu")
    for name, tree in trees.items():
        jeng.put_params(name, {k: ([jnp.asarray(x) for x in v]
                                   if isinstance(v, list) else jnp.asarray(v))
                               for k, v in tree.items()})
        placed = peng.put_params(name, {k: ([torch.from_numpy(x) for x in v]
                                            if isinstance(v, list) else
                                            torch.from_numpy(v))
                                        for k, v in tree.items()})
        assert peng.get_params(name) is placed
    js, ps = jeng.status(), peng.status()
    assert ps["models"] == js["models"] and ps["hbm_used_gb"] == js[
        "hbm_used_gb"]
    assert peng.hbm_used_gb() == pytest.approx(jeng.hbm_used_gb(), abs=0)
    assert ps["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    for eng in (jeng, peng):
        eng.drop_params("m")
        eng.drop_params("absent")
    assert peng.status()["models"] == jeng.status()["models"] == {
        "n": {"gb": 0.0}}
    jt = jax_engine.bf16_storage({"a": jnp.ones(3), "i": jnp.ones(2, "int8")})
    pt = port_engine.bf16_storage({"a": torch.ones(3),
                                   "i": torch.ones(2, dtype=torch.int8)})
    assert [str(x.dtype) for x in (jt["a"], jt["i"])] == ["bfloat16", "int8"]
    assert (pt["a"].dtype, pt["i"].dtype) == (torch.bfloat16, torch.int8)
    if not torch.cuda.is_available():
        with pytest.raises(ConfigError, match="CUDA"):
            port_engine.InferenceEngine(torch.device("cuda"))


#: each backend at a tiny preset: (build, booked name, engine name)
BACKENDS = {
    "whisper-test-f32": (lambda: WhisperASR(ASRConfig(
        model_size="test", compute_type="float32"), "cpu"), "asr", "whisper"),
    "whisper-test-bf16-int8": (lambda: WhisperASR(ASRConfig(
        model_size="test", decoder_int8=True), "cpu"), "asr", "whisper"),
    "whisper-synth-int4": (lambda: WhisperASR(ASRConfig(
        model_size="tiny-synth", compute_type="float32",
        decoder_int4=True), "cpu"), "asr", "whisper"),
    "whisper-test-int8-lm4": (lambda: WhisperASR(ASRConfig(
        model_size="test", decoder_int8=True, lm_head_int4=True), "cpu"),
        "asr", "whisper"),
    "llm-test-int8": (lambda: LLMGenerator(GenerationConfig(
        model="test", decoder_int8=True), "cpu"), "generation", "llm"),
    "llm-test-int4-lm4": (lambda: LLMGenerator(GenerationConfig(
        model="test", decoder_int4=True, lm_head_int4=True), "cpu"),
        "generation", "llm"),
    "llm-eval-small": (lambda: LLMGenerator(GenerationConfig(
        model="eval-small"), "cpu"), "generation", "llm"),
    "bgem3-eval-small": (lambda: BGEM3Embedder(EmbeddingConfig(
        model="eval-small"), "cpu"), "embeddings", "bgem3"),
    "e5-test": (lambda: E5Embedder(EmbeddingConfig(
        backend="multilingual-e5", model="test"), "cpu"), "embeddings", "e5"),
    "reranker-test": (lambda: BGEReranker(RerankingConfig(model="test"),
                                          "cpu"), "reranking", "reranker"),
    "reranker-eval-small": (lambda: BGEReranker(RerankingConfig(
        model="eval-small"), "cpu"), "reranking", "reranker"),
    "diarizer-test": (lambda: ClusteringDiarizer(DiarizationConfig(
        backend="clustering", model="test"), "cpu"), "diarization",
        "speaker"),
    "diarizer-asset": (lambda: ClusteringDiarizer(DiarizationConfig(
        backend="clustering"), "cpu"), "diarization", "speaker"),
}


def _tensor_bytes(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_estimate_is_the_loaded_bytes(backend):
    """The estimate, known before the load, equals the bytes of the
    tensors the backend keeps (its weights and quantized copies); the load
    books it under the JAX name and records it with the engine, and the
    unload takes both back."""
    build, name, engine_name = BACKENDS[backend]
    b = build()
    est = b.hbm_required_gb
    rm = port_manager.get_resource_manager()
    assert rm.used_gb() == 0.0
    b.load()
    kept = _tensor_bytes([b._params, getattr(b, "_params_q8", None)])
    assert round(est * 1e9) == kept > 0
    assert rm.status()["models"] == {name: {"gb": est, "pinned": False}}
    eng = port_engine.get_engine()
    assert eng.models[engine_name].bytes == kept
    assert [e["name"] for e in rm.events] == [name]
    b.unload()
    assert not b.is_loaded and rm.used_gb() == 0.0
    assert engine_name not in eng.models
    b.unload()  # a second unload is a no-op


def _fake_cfg(**kw):
    return AudioRAGConfig(**{
        "asr": ASRConfig(backend="fake"),
        "diarization": DiarizationConfig(backend="fake"),
        "embedding": EmbeddingConfig(backend="fake"),
        "reranking": RerankingConfig(backend="none"),
        "generation": GenerationConfig(backend="fake"),
        "device": "cpu", **kw})


def test_audiorag_budget_pins_status_and_unload_all():
    """The budget and the pins come from ``resources``; ``status()`` gives
    the manager's and the engine's status under the JAX keys; the JAX
    fakes' estimate 0.0 is the port's; ``unload_all`` unloads every booked
    backend through the manager and rebuilds each stage on its next use."""
    from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
    from audio_rag_tpu_torch.asr.fake import FakeASR

    rag = AudioRAG(_fake_cfg(resources=ResourceConfig(
        max_hbm_gb=3.0, pin_query_models=True)))
    rm = port_manager.get_resource_manager()
    assert rm.max_hbm_gb == 3.0 and rm.pinned_names == {"embeddings",
                                                       "reranking"}
    jrag = JaxAudioRAG(JaxAudioRAGConfig(**{
        "asr": {"backend": "fake"}, "diarization": {"backend": "fake"},
        "embedding": {"backend": "fake"}, "reranking": {"backend": "none"},
        "generation": {"backend": "fake"},
        "resources": {"max_hbm_gb": 3.0, "pin_query_models": True}}))
    for fake in (FakeASR(), rag.embedder, rag.generator, rag.diarizer):
        assert fake.hbm_required_gb == 0.0
    got, want = rag.status(), jrag.status()
    for key in ("resources", "engine"):
        assert key in got and key in want
    want_res = dict(want["resources"])
    want_res.pop("device", None)
    assert got["resources"] == want_res
    assert got["engine"]["models"] == want["engine"]["models"] == {}
    # a booked backend goes through the manager's unload_all
    asr = WhisperASR(ASRConfig(model_size="test", compute_type="float32"),
                     "cpu")
    asr.load()
    assert rag.status()["resources"]["models"] == {
        "asr": {"gb": asr.hbm_required_gb, "pinned": False}}
    assert rag.status()["engine"]["models"] == {
        "whisper": {"gb": round(asr.hbm_required_gb, 3)}}
    rag.unload_all()
    assert not asr.is_loaded
    assert rag.status()["resources"]["models"] == {}
    assert rag.status()["engine"]["models"] == {}
    jrag.unload_all()


def _headed_rag():
    rag = _port_rag({})
    rag.config.contextual = ContextualConfig(enabled=True)
    # no wave scheduler: its waves' makeup (and so the sampling keys) may
    # vary with the host's load
    rag.config.generation = GenerationConfig(
        model="eval-small", max_tokens=48, use_scheduler=False)
    return rag


def _rows(payloads):
    return [(p["text"], p["speaker"], round(float(p["start"]), 3),
             round(float(p["end"]), 3), p["metadata"].get("original_text"))
            for p in payloads]


@pytest.mark.skipif(not (ASSETS_DIR / "llm_small.npz").exists(),
                    reason="trained LLM asset not built")
def test_headed_ingest_under_a_tight_budget(tmp_path):
    """The spine's three turns with the trained generator's headers: once
    unbounded, then twice under a budget that holds the generator and the
    embedder but not the ASR beside the generator. The bounded ingests
    evict the ASR for the generator, then reload it (evicting the
    generator and the embedder), and store the unbounded run's chunks;
    the JAX pipeline stores the same."""
    path = tmp_path / "turns.wav"
    write_wav(path, _turn_audio(), SR)
    rag = _headed_rag()
    rm = port_manager.get_resource_manager()
    calls = _Calls(rag.generator)
    jax_rag = _jax_rag({})
    jax_rag.config.contextual = JaxCtxConfig(enabled=True)
    jax_gen = JaxLLM(JaxGenConfig(backend="llm-jax", model="eval-small",
                                  max_tokens=48, use_scheduler=False))
    jax_gen.load()
    jax_rag.ingestion._generator = jax_gen
    jax_calls = _Calls(jax_gen)
    try:
        rag.ingest(str(path), collection="free", diarize=False)
        calls.close()
        free = _rows(rag.store._coll("free").payloads)
        assert rm.eviction_count == 0 and len(free) == 3
        assert any(r[0].startswith("[Context: ") for r in free)
        asr_gb = rag.asr.hbm_required_gb
        gen_gb = rag.generator.hbm_required_gb
        emb_gb = rag.embedder.hbm_required_gb
        rag.unload_all()
        rm.max_hbm_gb = max(asr_gb, gen_gb) + emb_gb
        assert asr_gb + gen_gb > rm.max_hbm_gb
        n0 = len(rm.events)
        for coll in ("tight", "again"):
            rag.ingest(str(path), collection=coll, diarize=False)
            assert _rows(rag.store._coll(coll).payloads) == free
        seq = [(e["kind"], e["name"]) for e in rm.events[n0:]]
        assert seq[:4] == [("load", "asr"), ("evict", "asr"),
                           ("load", "generation"), ("load", "embeddings")]
        assert ("load", "asr") in seq[4:] and ("evict", "generation") in seq
        assert rm.eviction_count == sum(k == "evict" for k, _ in seq) >= 3

        def jax_rows():
            jax_rag.ingest(str(path), collection="free", diarize=False)
            return _rows(jax_rag._retriever._coll("free").payloads)

        ref = jax_rows()
        if not _follow_calls(jax_gen, jax_calls, calls):
            jax_rag._retriever.delete_collection("free")
            ref = _replayed(jax_gen, calls, 0, jax_rows)
        assert free == ref
    finally:
        jax_calls.close()
        rag.unload_all()
        jax_rag.unload_all()


def test_evicting_the_generator_under_its_waiting_thread():
    """The manager holds its lock while it unloads a victim. Its booked
    generator is the scheduler's inner generator, whose unload joins no
    thread: the scheduler's thread, blocked on that lock in the middle of
    a wave, goes on with the weights it read once the eviction is over,
    answers as before, and the next wave loads the weights again."""
    rm = port_manager.get_resource_manager(1.0)
    sg = ScheduledGenerator(LLMGenerator(GenerationConfig(
        model="test", temperature=0.0, max_tokens=8), "cpu"))
    try:
        first = sg.generate("hello there")
        assert rm.status()["models"]["generation"]["gb"] > 0
        done = {}

        def evict_while_waited_on():
            with rm._lock:
                fut = sg.scheduler.submit("hello there")
                time.sleep(0.3)  # the wave reaches touch() and waits
                rm.ensure_hbm(1.0, for_model="asr")  # evicts generation
                done["evicted"] = not sg.inner.is_loaded
            done["answer"] = fut.result(timeout=30)

        t = threading.Thread(target=evict_while_waited_on, daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "eviction deadlocked"
        assert done == {"evicted": True, "answer": first}
        assert rm.eviction_count == 1 and sg.scheduler._thread.is_alive()
        assert sg.generate("hello there") == first and sg.inner.is_loaded
    finally:
        sg.unload()


def test_generated_text_depends_only_on_its_request():
    """A generator decodes each answer against its own request's words
    (and the side file's), not against every word its tokenizer has seen:
    the same prompt gives the same text whatever else went before, as a
    reload after an eviction and the stage-grouped batch against the
    per-file loop need."""
    gen = LLMGenerator(GenerationConfig(model="test", temperature=0.0,
                                        max_tokens=16), "cpu")
    first = gen.generate("alpha bravo charlie")
    ids = gen.last_token_ids[0]
    assert ids and "<unk>" in first
    # history: words for every id of the answer, as other requests leave
    gen._tok._reverse.update({i: f"seen{i}" for i in ids})
    assert gen.generate("alpha bravo charlie") == first
    assert gen._tok.decode(ids) != first  # the global map would differ
