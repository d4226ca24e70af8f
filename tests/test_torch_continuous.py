"""The PyTorch port's continuous batcher against the JAX package's, on the
CPU: the mirrors of ``tests/unit/components/test_continuous.py`` (greedy
tokens equal to the wave's, determinism, ``max_tokens``, the token
counter, short requests overtaking a long one, oversubscription, the
adaptive segments' policy and tokens, token streaming, the factory's
continuous mode, speculative and pipelined segments), each request's
greedy tokens held to the JAX ``ContinuousBatcher``'s on the same weights,
a failed segment failing every live request, and ``AudioRAG.unload_all``
stopping the batcher's thread and freeing its cache.

Both generators run the ``test`` preset with the JAX package's weights
(``init_llm`` at ``PRNGKey(0)``, bf16 storage; the port's through
``weights.convert_llm``). Where two greedy paths part, they may only part
at a near-tie: the teacher-forced logits of the shared prefix put the two
tokens within 0.05 of the best (the JAX test's arbiter)."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import GenerationConfig as JaxGenConfig
from audio_rag_tpu.engine.continuous import ContinuousBatcher as JaxBatcher
from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxLLM
from audio_rag_tpu_torch.config import (
    AudioRAGConfig,
    EmbeddingConfig,
    GenerationConfig,
    RerankingConfig,
)
from audio_rag_tpu_torch.engine import continuous as cont
from audio_rag_tpu_torch.engine.continuous import ContinuousBatcher
from audio_rag_tpu_torch.engine.scheduler import ScheduledGenerator
from audio_rag_tpu_torch.generation import create_generator
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from audio_rag_tpu_torch.models import llm as tl
from audio_rag_tpu_torch.pipeline import AudioRAG
from audio_rag_tpu_torch.weights import convert_llm
from torch_llm_common import one_torch_thread  # noqa: F401

PROMPTS = ["alpha bravo charlie delta", "echo foxtrot golf",
           "hotel india juliet kilo lima"]
GAP = 0.05  # the near-tie arbiter's margin (the JAX test's)


@pytest.fixture(scope="module")
def jax_gen():
    gen = JaxLLM(JaxGenConfig(model="test", temperature=0.0,
                              use_scheduler=False, max_tokens=24))
    gen.load()
    yield gen
    gen.unload()


@pytest.fixture(scope="module")
def generator(jax_gen):
    """The port's ``test`` generator on the JAX generator's weights."""
    gen = LLMGenerator(GenerationConfig(model="test", temperature=0.0,
                                        use_scheduler=False, max_tokens=24),
                       device="cpu")
    gen.load()
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jax_gen._params)
    gen._params = convert_llm(tree, gen.dims)
    yield gen
    gen.unload()


@pytest.fixture()
def batcher(generator):
    b = ContinuousBatcher(generator, n_slots=4, segment_tokens=8)
    yield b
    b.stop()


def _next_token_logits(gen, prompt, prefix, keep=None):
    """Teacher-forced next-token logits after prompt + prefix (no cache);
    ``keep``: only the prompt's last ``keep`` tokens, as the batcher cuts
    it."""
    ids = gen._tok.encode(prompt)[-(keep or 0):] + list(prefix)
    logits, _ = tl.llm_forward(gen._params, gen.dims,
                               torch.tensor([ids]), dtype=gen.dtype)
    return logits[0, -1].numpy()


def _trim(ids, eos, n):
    ids = list(ids)
    return (ids[:ids.index(eos)] if eos in ids else ids)[:n]


def _agree(gen, prompt, got, want, n=24, keep=None):
    """``got`` and ``want`` (token ids) are equal up to EOS and ``n``, or
    part at a near-tie of the teacher-forced logits."""
    eos = gen._tok.eos_id
    a, b = _trim(got, eos, n), _trim(want, eos, n)
    if a == b:
        return
    m = min(len(a), len(b))
    first = next((i for i in range(m) if a[i] != b[i]), m)
    logits = _next_token_logits(gen, prompt, b[:first], keep)
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] < GAP, (prompt, first, top2)
    if first < m:
        assert logits[a[first]] >= logits.max() - GAP
        assert logits[b[first]] >= logits.max() - GAP


def _recorded(batcher_cls, monkeypatch):
    """Every finished slot's raw tokens by prompt, for ``batcher_cls``."""
    seen: dict[str, list[int]] = {}
    orig = batcher_cls._finish

    def record(self, slot):
        seen[slot.request.prompt] = list(slot.tokens)
        orig(self, slot)

    monkeypatch.setattr(batcher_cls, "_finish", record)
    return seen


def _serve(b, prompts, **kw):
    futures = [b.submit(p, **kw) for p in prompts]
    return [f.result(timeout=120) for f in futures]


# -- correctness ---------------------------------------------------------------------

def test_matches_wave_and_jax_batcher_greedy(generator, jax_gen, batcher,
                                             monkeypatch):
    """Greedy continuous decode gives each request the wave's tokens and
    the JAX batcher's (right-padded slot prefill and per-slot positions
    against the left-padded wave), up to a near-tie."""
    wave = {}
    for p in PROMPTS:
        generator.generate_batch([p], max_tokens=24)
        wave[p] = generator.last_token_ids[0]
    got = _recorded(ContinuousBatcher, monkeypatch)
    ref = _recorded(JaxBatcher, monkeypatch)
    _serve(batcher, PROMPTS, max_tokens=24)
    jb = JaxBatcher(jax_gen, n_slots=4, segment_tokens=8)
    try:
        _serve(jb, PROMPTS, max_tokens=24)
    finally:
        jb.stop()
    for p in PROMPTS:
        _agree(generator, p, got[p], wave[p])
        _agree(generator, p, got[p], ref[p])
        assert len(_trim(got[p], generator._tok.eos_id, 24)) >= 1


@pytest.mark.parametrize("n_words,max_tokens,ctx", [
    # cut to C - 8 tokens: 7 to deliver, a 16-step segment
    (200, 100, 96),
    (200, 100, 2048),
    # prompt + max_tokens past C: the 7th segment runs over
    (20, 200, 2048),
], ids=["prompt_at_cap_C96", "prompt_at_cap_C128", "quota_past_cache"])
def test_slot_running_past_the_cache_end(generator, jax_gen, monkeypatch,
                                         n_words, max_tokens, ctx):
    """A slot whose segment steps past the cache's last frame (its room is
    checked only at segment boundaries) delivers the JAX batcher's greedy
    tokens: the steps out of bounds write nothing, as JAX's scatter drops
    them, and what they emit lies beyond max_new. At C = 96 only the
    cache's end is passed; at C = max_len = 128 (the ``test`` preset's)
    the rope lookup runs past its table too and clamps, as JAX's gather."""
    prompt = " ".join(f"w{i}" for i in range(n_words))
    seen: dict[str, tuple] = {}
    ref = _recorded(JaxBatcher, monkeypatch)
    orig = ContinuousBatcher._finish

    def record(self, slot):
        seen["port"] = (list(slot.tokens), slot.pos, slot.max_new)
        orig(self, slot)

    monkeypatch.setattr(ContinuousBatcher, "_finish", record)
    outs = {}
    for name, cls, gen in (("port", ContinuousBatcher, generator),
                           ("jax", JaxBatcher, jax_gen)):
        b = cls(gen, n_slots=2, segment_tokens=16, context_tokens=ctx)
        try:
            outs[name] = b.generate(prompt, max_tokens=max_tokens)
        finally:
            b.stop()
    C = min(tl.LLM_PRESETS["test"].max_len, ctx)
    got, pos, max_new = seen["port"]
    eos = generator._tok.eos_id
    assert eos not in got and pos > C  # the slot did step past the end
    _agree(generator, prompt, got, ref[prompt], n=max_new, keep=C - 8)
    if _trim(got, eos, max_new) == _trim(ref[prompt], eos, max_new):
        assert outs["port"] == outs["jax"]


def test_temperature_zero_deterministic(batcher):
    a = batcher.generate("november oscar papa", max_tokens=12)
    assert a == batcher.generate("november oscar papa", max_tokens=12)


def test_max_tokens_respected(generator, batcher):
    out = batcher.generate("quebec romeo sierra", max_tokens=5)
    assert len(generator._tok.encode(out, add_special=False)) <= 5


def test_tokens_generated_counter(batcher):
    """``tokens_generated`` counts the ids delivered."""
    before = batcher.tokens_generated
    batcher.generate("tango uniform victor", max_tokens=7)
    assert 1 <= batcher.tokens_generated - before <= 7


def test_counters_include_a_request_when_it_resolves(batcher, monkeypatch):
    """``requests_served`` and ``tokens_generated`` count a request before
    its future resolves, so a caller that reads them right after its
    answer sees its own request. The admission waits for a gate until a
    done-callback (run where the future resolves) is in place."""
    gate = threading.Event()
    prefill = cont.llm_prefill_slots

    def gated(*args, **kw):
        assert gate.wait(timeout=30)
        return prefill(*args, **kw)

    monkeypatch.setattr(cont, "llm_prefill_slots", gated)
    served, tokens = batcher.requests_served, batcher.tokens_generated
    seen = []
    fut = batcher.submit("whiskey xray yankee", max_tokens=6)
    fut.add_done_callback(lambda _: seen.append(
        (batcher.requests_served, batcher.tokens_generated)))
    gate.set()
    fut.result(timeout=120)
    assert len(seen) == 1 and seen[0][0] == served + 1
    assert 1 <= seen[0][1] - tokens <= 6


def test_a_failed_segment_fails_every_live_request(generator, monkeypatch):
    """A segment that raises hands its exception to every live request's
    future (nothing falls back); the batcher then serves again."""
    b = ContinuousBatcher(generator, n_slots=4, segment_tokens=8)
    try:
        def boom(*a, **kw):
            raise RuntimeError("segment failed")

        monkeypatch.setattr(cont, "llm_decode_slots", boom)
        futures = [b.submit(p, max_tokens=12) for p in PROMPTS]
        for f in futures:
            with pytest.raises(RuntimeError, match="segment failed"):
                f.result(timeout=120)
        monkeypatch.undo()
        assert b.generate(PROMPTS[0], max_tokens=4)
    finally:
        b.stop()


# -- no head-of-line blocking -------------------------------------------------------

def test_short_requests_overtake_long_one(batcher):
    """Short requests join at the next boundary and finish while the long
    request admitted before them still runs."""
    done_at: dict[str, float] = {}

    def record(name):
        return lambda _: done_at.__setitem__(name, time.perf_counter())

    long_f = batcher.submit("tango uniform", max_tokens=96)
    long_f.add_done_callback(record("long"))
    time.sleep(0.05)
    shorts = []
    for i in range(3):
        f = batcher.submit(f"victor whiskey {i}", max_tokens=4)
        f.add_done_callback(record(f"short{i}"))
        shorts.append(f)
    for f in shorts:
        f.result(timeout=120)
    long_f.result(timeout=120)
    assert all(done_at[f"short{i}"] < done_at["long"] for i in range(3))


def test_oversubscription_all_served(batcher):
    futures = [batcher.submit(f"xray yankee {i}", max_tokens=6)
               for i in range(12)]  # 12 requests, 4 slots
    assert len([f.result(timeout=180) for f in futures]) == 12
    assert batcher.requests_served >= 12


# -- adaptive segments ----------------------------------------------------------------

def test_segment_selection_policy(generator):
    """Long segments only when nobody waits and every live slot has the
    quota and the cache for one."""
    b = ContinuousBatcher(generator, n_slots=2, segment_tokens=4,
                          idle_segment_tokens=16)
    try:
        req = cont._Request("p", None, None, None)
        assert b._segment_for_dispatch() == 4  # nothing live
        slot = cont._Slot(request=req, tokens=[1], pos=8, max_new=64,
                          last_token=1)
        b._slots[0] = slot
        assert b._segment_for_dispatch() == 16
        b._queue.put(cont._Request("q", None, None, None))
        assert b._segment_for_dispatch() == 4  # a request waits
        b._queue.get_nowait()
        slot.max_new = len(slot.tokens) + 8
        assert b._segment_for_dispatch() == 4  # no quota for 16
        slot.max_new, slot.pos = 64, b._C - 2 - 16
        assert b._segment_for_dispatch() == 4  # no cache for 16
    finally:
        b._slots[0] = None
        b.stop()


def test_adaptive_matches_fixed_output(generator):
    """Adaptive segments change how many segments run, not the tokens."""
    outs, runs = {}, {}
    for idle in (0, 16):
        b = ContinuousBatcher(generator, n_slots=2, segment_tokens=4,
                              idle_segment_tokens=idle)
        try:
            outs[idle] = _serve(b, PROMPTS[:2], max_tokens=20)
            runs[idle] = b.segments_run
        finally:
            b.stop()
    assert outs[16] == outs[0]
    assert runs[16] < runs[0]


# -- streaming and the factory --------------------------------------------------------

def test_stream_deltas_accumulate_to_full_text(generator):
    sg = ScheduledGenerator(generator, mode="continuous", n_slots=2,
                            segment_tokens=4)
    try:
        full = sg.generate("streaming check one two", max_tokens=16)
        deltas = list(sg.generate_stream("streaming check one two",
                                         max_tokens=16))
        assert len(deltas) >= 2
        assert "".join(deltas).strip() == full
    finally:
        sg.scheduler.stop()


def test_factory_builds_the_continuous_batcher(generator, monkeypatch):
    """``scheduler_mode="continuous"`` builds the batcher with the
    config's slots, segments and context (the schema's defaults: 8, 16,
    48, 2048); ``generate_batch`` answers every prompt; the config refuses
    settings outside the schema's bounds."""
    cfg = GenerationConfig(model="test", temperature=0.0,
                           scheduler_mode="continuous")
    assert (cfg.scheduler_slots, cfg.scheduler_segment_tokens,
            cfg.scheduler_idle_segment_tokens,
            cfg.scheduler_context_tokens) == (8, 16, 48, 2048)
    sg = create_generator(GenerationConfig(
        model="test", temperature=0.0, scheduler_mode="continuous",
        scheduler_slots=2, scheduler_segment_tokens=8,
        scheduler_idle_segment_tokens=0, scheduler_context_tokens=96),
        device="cpu")
    try:
        b = sg.scheduler
        assert isinstance(sg, ScheduledGenerator)
        assert isinstance(b, ContinuousBatcher)
        assert (b.n_slots, b.segment, b.idle_segment, b.ctx) == (
            2, 8, 0, 96)
        sg.load()
        sg.inner._params = generator._params
        out = sg.generate_batch(["zulu one", "zulu two"], max_tokens=6)
        assert len(out) == 2 and b._cache[0].shape[3] == 96
    finally:
        sg.unload()
    for bad in ({"scheduler_slots": 0}, {"scheduler_segment_tokens": 0},
                {"scheduler_idle_segment_tokens": -1},
                {"scheduler_context_tokens": 32}):
        with pytest.raises(Exception, match="scheduler_"):
            GenerationConfig(**bad)


def test_unload_all_stops_the_batcher(generator):
    """``AudioRAG.unload_all`` joins the batcher's thread and drops its
    cache and the generator's weights; waiting requests fail."""
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        reranking=RerankingConfig(backend="none"),
        generation=GenerationConfig(model="test", temperature=0.0,
                                    scheduler_mode="continuous",
                                    scheduler_slots=2), device="cpu"))
    gen = rag.generator
    b = gen.scheduler
    gen.inner._params = generator._params
    assert gen.generate("zulu three", max_tokens=4)
    assert b._cache is not None and b._thread.is_alive()
    rag.unload_all()
    assert not b._thread.is_alive() and b._cache is None
    assert not gen.inner.is_loaded
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit("zulu four")


# -- speculative and pipelined segments ---------------------------------------------

def _spec_tokens(generator, spec_k, monkeypatch):
    seen = _recorded(ContinuousBatcher, monkeypatch)
    b = ContinuousBatcher(generator, n_slots=4, segment_tokens=8,
                          spec_k=spec_k)
    try:
        _serve(b, PROMPTS, max_tokens=24)
    finally:
        b.stop()
    return dict(seen)


def test_spec_matches_plain_greedy(generator, monkeypatch):
    """Speculative segments give the plain segments' greedy tokens, up to
    a near-tie."""
    plain = _spec_tokens(generator, 0, monkeypatch)
    spec = _spec_tokens(generator, 4, monkeypatch)
    for p in PROMPTS:
        _agree(generator, p, spec[p], plain[p])


def test_mixed_temperatures(generator):
    """A sampling slot rides the speculative segment beside a greedy one."""
    b = ContinuousBatcher(generator, n_slots=4, segment_tokens=8, spec_k=4)
    try:
        f1 = b.submit("tango uniform victor", max_tokens=12, temperature=0.0)
        f2 = b.submit("whiskey xray yankee", max_tokens=12, temperature=0.8)
        assert isinstance(f1.result(timeout=120), str)
        assert isinstance(f2.result(timeout=120), str)
    finally:
        b.stop()


def test_spec_counts_real_tokens(generator):
    b = ContinuousBatcher(generator, n_slots=2, segment_tokens=8, spec_k=4)
    try:
        out = b.generate("zulu alpha", max_tokens=6)
        assert len(generator._tok.encode(out, add_special=False)) <= 6
        assert b.tokens_generated >= 1
    finally:
        b.stop()


def test_pipelined_matches_plain(generator):
    """Segments issued from the previous one's device outputs before its
    readback give the same text."""
    outs = {}
    for pipelined in (False, True):
        b = ContinuousBatcher(generator, n_slots=4, segment_tokens=8,
                              pipeline_segments=pipelined)
        try:
            outs[pipelined] = _serve(b, PROMPTS, max_tokens=32)
        finally:
            b.stop()
    assert outs[True] == outs[False]


def test_pipelined_mid_eos_slot_not_corrupted(generator):
    """A slot that finishes while a chained segment is in flight delivers
    its capped output, and a later request reuses the slot."""
    b = ContinuousBatcher(generator, n_slots=2, segment_tokens=8,
                          pipeline_segments=True)
    try:
        f_long = b.submit(PROMPTS[0], max_tokens=40)
        f_short = b.submit(PROMPTS[1], max_tokens=24)
        short = f_short.result(timeout=120)
        assert len(generator._tok.encode(short, add_special=False)) <= 24
        assert isinstance(f_long.result(timeout=120), str)
        assert isinstance(b.generate(PROMPTS[2], max_tokens=12), str)
    finally:
        b.stop()


def test_stop_fails_live_and_waiting_requests(generator):
    """Stopping a batcher with every slot busy and requests waiting
    resolves every future: each finished request has its text, every
    other one fails with "scheduler stopped"."""
    b = ContinuousBatcher(generator, n_slots=2, segment_tokens=4)
    futures = [b.submit(f"yankee zulu {i}", max_tokens=96) for i in range(6)]
    time.sleep(0.05)
    b.stop()
    assert not b._thread.is_alive() and b._cache is None
    for f in futures:
        assert f.done()
        if f.exception() is not None:
            assert "stopped" in str(f.exception())


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_continuous_mode_runs_on_the_card_by_default(no_cuda):
    """The factory's continuous batcher is built on the card unless the
    caller asks for the CPU: without one it raises."""
    from audio_rag_tpu_torch.core.exceptions import ConfigError

    with pytest.raises(ConfigError, match="CUDA is not available"):
        create_generator(GenerationConfig(model="test",
                                          scheduler_mode="continuous"))
