"""The PyTorch port's generator, wave scheduler, HyDE and answering query
against the JAX package's, on the CPU with the committed trained LLM
(``llm_small.npz``): ``LLMGenerator.generate_batch`` gives the same texts
and token ids on RAG prompts (greedy, sampled, int8, int4 head), its batch
bucket, empty batch, context-window error and eight-word stream behave as
the JAX generator's; ``ScheduledGenerator`` coalesces concurrent requests
into one wave; ``HyDEExpander`` writes the same passage; and
``AudioRAG.query(generate_answer=True)`` / ``use_hyde=True`` give the
answer, passage and ranking of the JAX ``QueryPipeline.query`` on the
spine's turns. What the port does not have raises ``ConfigError`` (the
continuous batcher and the speculative program now build and answer), and
the new modules import nothing of JAX."""

import ast
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.config.schema import ExpansionConfig as JaxExpansionConfig
from audio_rag_tpu.config.schema import GenerationConfig as JaxGenConfig
from audio_rag_tpu.core.exceptions import GenerationError as JaxGenError
from audio_rag_tpu.core.types import AudioChunk as JaxChunk
from audio_rag_tpu.expansion.hyde import HyDEExpander as JaxHyDE
from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxLLM
from audio_rag_tpu.models import llm as jl
from audio_rag_tpu.pipeline.query import QueryPipeline
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    AudioRAGConfig,
    EmbeddingConfig,
    ExpansionConfig,
    GenerationConfig,
    RerankingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError, GenerationError
from audio_rag_tpu_torch.core.types import AudioChunk
from audio_rag_tpu_torch.engine.scheduler import (
    GenerationScheduler, ScheduledGenerator)
from audio_rag_tpu_torch.expansion.hyde import HYDE_PROMPT, HyDEExpander
from audio_rag_tpu_torch.generation import create_generator
from audio_rag_tpu_torch.generation.fake import FakeGenerator
from audio_rag_tpu_torch.generation import llm as llm_module
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from audio_rag_tpu_torch.pipeline import AudioRAG
from torch_llm_common import one_torch_thread, rag_prompts  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "llm_small.npz").exists(),
    reason="trained LLM asset not built")

#: profile → generator switches both packages take
PROFILES = {"greedy": {}, "int8": {"decoder_int8": True},
            "int8+lm4": {"decoder_int8": True, "lm_head_int4": True}}
SYSTEM = "You answer from the excerpts."


def _pair(**kw):
    """The JAX and the port's eval-small generators, loaded, unscheduled."""
    kw = {"model": "eval-small", "temperature": 0.0, "max_tokens": 48,
          "use_scheduler": False, **kw}
    jax_gen = JaxLLM(JaxGenConfig(backend="llm-jax", **kw))
    jax_gen.load()
    gen = LLMGenerator(GenerationConfig(**kw), device="cpu")
    gen.load()
    return jax_gen, gen


@pytest.fixture(scope="module")
def prompts():
    return rag_prompts(3, seed=21)


@pytest.fixture(scope="module")
def greedy_pair():
    return _pair()


#: a choice whose top two scores (the JAX package's logits, or for a
#: sampled token its logits/T plus the step's Gumbel noise) are closer than
#: TIE_ULPS bf16 ulps of each of the two logits (over T, sampled) may go
#: either way: the packages' bf16 states differ by sum order, which moves
#: this asset's (bf16-valued) logits by up to two ulps (0.05 at |7|) in
#: every profile, quantized or not
TIE_ULPS = 2


def _tie_bound(logits, picks, temp):
    """How far apart two choices' scores may be and still go either way
    (:data:`TIE_ULPS`)."""
    mag = np.maximum(np.abs(logits[list(picks)]), 2.0 ** -100)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return TIE_ULPS * float(ulp.sum()) / (temp if temp > 0 else 1.0)


def _temperature(jax_gen, kw):
    t = kw.get("temperature")
    return jax_gen.config.temperature if t is None else t


def _wave(jax_gen, texts, kw):
    """The prompts as the JAX generator joins and cuts them, their
    tokens, the prompt bucket and the new tokens the wave may write."""
    tok, dims = jax_gen._tok, jax_gen.dims
    system = kw.get("system")
    full = [f"{system}\n\n{t}" if system else t for t in texts]
    cap = min(jax_gen.config.max_prompt_tokens, dims.max_len - 8)
    seqs = [tok.encode(t)[-cap:] for t in full]
    P = min(1 << (max(map(len, seqs)) - 1).bit_length(), cap)
    max_new = min(kw.get("max_tokens") or jax_gen.config.max_tokens,
                  dims.max_len - P - 1)
    return full, [s[-P:] for s in seqs], P, max_new


def _jax_scores(jax_gen, texts, kw, ids, steps):
    """The JAX generator's scores and f32 logits for the first ``steps``
    new tokens of a batch of ``texts``, teacher-forced on ``ids`` (the
    batch rebuilt as it builds it, prefilled, then decoded on ``ids``, EOS
    after a row's end), each (steps, rows, vocab): the scores are the
    logits, or when it samples logits·f32(1/T) plus the Gumbel noise of
    each step's key (``llm_generate``'s key chain)."""
    tok, dims = jax_gen._tok, jax_gen.dims
    full, seqs, P, _ = _wave(jax_gen, texts, kw)
    n = steps - 1  # tokens fed after the prompt
    ids = [(r + [tok.eos_id] * n)[:n] for r in ids]
    B = 1 << (len(seqs) - 1).bit_length()
    seqs = seqs + [seqs[0]] * (B - len(seqs))
    ids = ids + [ids[0]] * (B - len(ids))
    batch = np.full((B, P + n), tok.eos_id, np.int32)
    valid = np.zeros((B, P + n), bool)
    for i, (s, new) in enumerate(zip(seqs, ids)):
        batch[i, P - len(s):P] = s
        batch[i, P:] = new
        valid[i, P - len(s):] = True
    hd = dims.d_model // dims.n_heads
    cache = (jnp.zeros((dims.n_layers, B, dims.n_kv_heads, P + n + 1, hd),
                       jnp.bfloat16),) * 2
    kv = np.concatenate([valid, np.ones((B, 1), bool)], 1)
    pos = np.maximum(np.cumsum(valid[:, :P], 1) - 1, 0)
    logits, cache = jax.jit(lambda p, t, c: jl.llm_forward(
        p, dims, t, 0, c, kv_valid=jnp.asarray(kv), pos_ids=jnp.asarray(pos),
        last_pos=jnp.full((B,), P - 1, jnp.int32)))(
        jax_gen._params, jnp.asarray(batch[:, :P]), cache)
    outs = [logits[:, 0]]
    offset = P - valid[:, :P].sum(1)
    decode = jax.jit(lambda p, t, i, ck, cv, rp, q8: jl.llm_decode_step(
        p, dims, t, i, ck, cv, kv_valid=jnp.asarray(kv), rope_pos=rp,
        q8=q8))
    for i in range(P, P + n):
        out, *cache = decode(jax_gen._params, jnp.asarray(batch[:, i]),
                             jnp.int32(i), *cache,
                             jnp.asarray(i - offset, jnp.int32),
                             jax_gen._params_q8)
        outs.append(out)
    logits = np.stack([np.asarray(o, np.float32) for o in outs])
    sc = logits.copy()
    temp = _temperature(jax_gen, kw)
    if temp > 0.0:
        rng = jax.random.PRNGKey(abs(hash(tuple(full))) % (2 ** 31))
        for t in range(steps):
            key, rng = jax.random.split(rng)
            sc[t] = (sc[t] * (np.float32(1.0) / np.float32(temp))
                     + np.asarray(jax.random.gumbel(key, sc[t].shape),
                                  np.float32))
    return sc[:, :len(texts)], logits[:, :len(texts)]


def _check_batch(jax_gen, texts, kw, ref, got, ref_ids, got_ids):
    """The same token ids and texts as the JAX generator's. A row may part
    from the JAX row only at a near-tie (:func:`_tie_bound`): the same tokens
    before it, and there the two choices are the two best scores, within
    the bound. From there the port's row is followed to its end,
    teacher-forced: each of its tokens (EOS included) is the JAX model's
    best on the port's own prefix, or at one more near-tie its
    runner-up. At most one row a batch parts."""
    parted = [r for r, (a, b) in enumerate(zip(got_ids, ref_ids)) if a != b]
    assert len(got) == len(ref) and len(parted) <= 1, parted
    for row in range(len(ref)):
        if row not in parted:
            assert got[row] == ref[row]
    if not parted:
        return
    row, eos = parted[0], jax_gen._tok.eos_id
    max_new = _wave(jax_gen, texts, kw)[3]
    a, b = (got_ids[row] + [eos])[:max_new], (ref_ids[row] + [eos])[:max_new]
    step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    temp = _temperature(jax_gen, kw)
    sc, logits = (x[:, row] for x in _jax_scores(jax_gen, texts, kw,
                                                  got_ids, len(a)))
    top2 = np.argsort(-sc[step])[:2]
    # the rebuilt scores round as an unfused JAX program does, so at a tie
    # they may rank the two either way
    assert {a[step], b[step]} == set(top2.tolist()), (row, step, top2)
    assert sc[step, top2[0]] - sc[step, top2[1]] <= _tie_bound(
        logits[step], top2, temp), (row, step)
    ties = 0
    for t in range(step + 1, len(a)):
        best = int(np.argmax(sc[t]))
        if a[t] != best:
            assert (a[t] in np.argsort(-sc[t])[:2]
                    and sc[t, best] - sc[t, a[t]] <= _tie_bound(
                        logits[t], (best, a[t]), temp)), (row, t, a[t])
            ties += 1
    assert ties <= 1, (row, ties)


def _same(jax_gen, gen, texts, **kw):
    ref = jax_gen.generate_batch(texts, **kw)
    got = gen.generate_batch(texts, **kw)
    _check_batch(jax_gen, texts, kw, ref, got, jax_gen.last_token_ids,
                 gen.last_token_ids)
    return got


class _Calls:
    """Records each ``generate_batch`` of a generator (either package's):
    its prompts, keywords, answers and generated ids, until ``close``."""

    def __init__(self, gen):
        self.gen, self.seen = gen, []
        orig = gen.generate_batch

        def spy(prompts, **kw):
            out = orig(prompts, **kw)
            self.seen.append((list(prompts), kw, out,
                              list(gen.last_token_ids)))
            return out

        gen.generate_batch = spy

    def close(self):
        del self.gen.generate_batch


def _follow_calls(jax_gen, ref_calls, got_calls, starts=(0, 0)):
    """Each call the port's generator made from ``starts[1]`` on, held
    (:func:`_check_batch`) to the JAX generator's on the same prompts and
    keywords: to the JAX call recorded at the same place, or, where the
    port's prompts follow from an earlier near-tie, to a fresh JAX call on
    them. True when every call was the recorded JAX call, with the same
    ids; nothing is left uncompared either way."""
    ref, got = ref_calls.seen[starts[0]:], got_calls.seen[starts[1]:]
    assert len(got) == len(ref) > 0
    same = True
    for (tp, kw, g, gids), (jp, jkw, r, rids) in zip(got, ref):
        if (tp, kw) != (jp, jkw):
            assert not same, "the prompts parted before any near-tie"
            r = type(jax_gen).generate_batch(jax_gen, tp, **kw)
            rids = list(jax_gen.last_token_ids)
        _check_batch(jax_gen, tp, kw, r, g, rids, gids)
        same = same and (tp, kw) == (jp, jkw) and gids == rids
    return same


def _replayed(jax_gen, got_calls, start, run):
    """``run()`` with the JAX generator answering each prompt as the port's
    did from ``got_calls.seen[start]`` on (a prompt the port never asked
    raises), so that the JAX pipeline is held to the port's after a
    near-tie."""
    said = {}
    for prompts, kw, out, _ in got_calls.seen[start:]:
        for p, text in zip(prompts, out):
            said[p, tuple(sorted(kw.items()))] = text
    spy = jax_gen.generate_batch
    jax_gen.generate_batch = lambda prompts, **kw: [
        said[p, tuple(sorted(kw.items()))] for p in prompts]
    try:
        return run()
    finally:
        jax_gen.generate_batch = spy


@pytest.mark.parametrize("profile", list(PROFILES))
def test_generate_batch_matches_jax(profile, greedy_pair, prompts):
    """Three RAG prompts with a system prompt (a batch bucket of 4: the
    filler row copies row 0): the same texts and token ids, greedy
    (sampled waves: the HyDE and query tests). Answers end in EOS and are
    readable (no ``<unk>``)."""
    jax_gen, gen = greedy_pair if profile == "greedy" else _pair(
        **PROFILES[profile])
    got = _same(jax_gen, gen, prompts, system=SYSTEM)
    assert gen.last_stats["rows"] == 4 and len(got) == 3
    assert all(n < 48 for n in gen.last_token_counts)
    assert all(t and "<unk>" not in t for t in got)


def test_empty_batch_window_error_and_stream(greedy_pair, prompts):
    """An empty batch gives no answers; a request with no room for new
    tokens raises ``GenerationError`` in both; the stream yields the
    answer's words in groups of eight, as the JAX generator's."""
    jax_gen, gen = greedy_pair
    assert gen.generate_batch([]) == jax_gen.generate_batch([]) == []
    with pytest.raises(JaxGenError, match="context window"):
        jax_gen.generate(prompts[0], max_tokens=-1)
    with pytest.raises(GenerationError, match="context window"):
        gen.generate(prompts[0], max_tokens=-1)
    chunks = list(gen.generate_stream(prompts[1]))
    assert chunks == list(jax_gen.generate_stream(prompts[1]))
    assert " ".join(c.strip() for c in chunks) == gen._tok.decode(
        gen.last_token_ids[0]).strip()
    assert all(len(c.split()) <= 8 and c.endswith(" ") for c in chunks)
    assert len(chunks) >= 2


class _GatedGenerator:
    """``generate_batch`` waits for ``gate``, then echoes its prompts in
    capitals, or raises."""

    def __init__(self, fail: bool):
        self.fail = fail
        self.gate = threading.Event()

    def generate_batch(self, prompts, **kw):
        assert self.gate.wait(timeout=30)
        if self.fail:
            raise GenerationError("the wave failed")
        return [p.upper() for p in prompts]


@pytest.mark.parametrize("fail", [False, True], ids=["answer", "error"])
def test_scheduler_counts_a_wave_before_its_callers_wake(fail):
    """A request's future resolves only once its wave is counted, so a
    caller that reads ``batches_run``/``requests_served`` right after its
    answer (or its error) sees its own wave. A done-callback runs where
    the future resolves and reads the counters at that instant."""
    gen = _GatedGenerator(fail)
    sched = GenerationScheduler(gen, max_wait_ms=1.0)
    try:
        seen = []
        futures = [sched.submit(p) for p in ("alpha", "bravo")]
        for f in futures:
            f.add_done_callback(lambda _: seen.append(
                (sched.batches_run, sched.requests_served)))
        gen.gate.set()
        if fail:
            for f in futures:
                with pytest.raises(GenerationError, match="the wave failed"):
                    f.result(timeout=30)
        else:
            assert [f.result(timeout=30) for f in futures] == ["ALPHA",
                                                               "BRAVO"]
        assert seen == [(1, 2), (1, 2)]
    finally:
        sched.stop()


def test_scheduler_coalesces_concurrent_requests(greedy_pair, prompts):
    """Three requests submitted together run as one wave (the batch a
    direct ``generate_batch`` of the three gives); a request with other
    decode parameters waits for the next wave."""
    _, gen = greedy_pair
    direct = gen.generate_batch(prompts)
    sched = ScheduledGenerator(gen, max_batch=16, max_wait_ms=500.0)
    try:
        futures = [sched.scheduler.submit(p) for p in prompts]
        other = sched.scheduler.submit(prompts[0], max_tokens=8)
        assert [f.result(timeout=120) for f in futures] == direct
        assert other.result(timeout=120) == gen.generate(prompts[0],
                                                          max_tokens=8)
        assert sched.scheduler.batches_run == 2
        assert sched.scheduler.requests_served == 4
        assert sched.generate_batch(prompts[:2]) == gen.generate_batch(
            prompts[:2])
        assert sched.is_loaded and sched.check_availability()
    finally:
        sched.scheduler.stop()


def test_hyde_writes_the_jax_passage(greedy_pair):
    """A hypothesis sampled at 0.7: the JAX expander's prompt and passage
    (:func:`_follow_calls`; after a near-tie, the JAX expander's passage
    from the port's generation); the i-th of several at 0.7 + 0.1·i, at most 256
    tokens, empty passages dropped; without a generator the query
    stands."""
    jax_gen, gen = greedy_pair
    q = "what does the lecture say about gradient descent"
    ref_calls, got_calls = _Calls(jax_gen), _Calls(gen)
    try:
        ref = JaxHyDE(JaxExpansionConfig(backend="hyde"), jax_gen).expand(q)
        got = HyDEExpander(ExpansionConfig(backend="hyde"), gen).expand(q)
    finally:
        ref_calls.close()
        got_calls.close()
    if not _follow_calls(jax_gen, ref_calls, got_calls):
        ref = _replayed(jax_gen, got_calls, 0, lambda: JaxHyDE(
            JaxExpansionConfig(backend="hyde"), jax_gen).expand(q))
    assert got == ref
    assert len(got) == 1 and got[0] != q

    class Stub:
        def __init__(self):
            self.asked = []

        def check_availability(self):
            return True

        def generate(self, prompt, **kw):
            self.asked.append((prompt, kw))
            n = len(self.asked)
            return "" if n == 2 else f" passage {n} "

    for expander in (
            JaxHyDE(JaxExpansionConfig(backend="hyde", num_hypotheses=3),
                    Stub()),
            HyDEExpander(ExpansionConfig(backend="hyde", num_hypotheses=3),
                         Stub())):
        assert expander.expand(q) == ["passage 1", "passage 3"]
        asked = expander.generator.asked
        assert [kw for _, kw in asked] == [
            {"max_tokens": 256, "temperature": 0.7 + 0.1 * i}
            for i in range(3)]
        assert asked[0][0] == HYDE_PROMPT.format(query=q)
    assert HyDEExpander(generator=None).expand_single(q) == q


# -- AudioRAG.query with answers and HyDE -------------------------------------------

TURNS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure",
         "attention layers mix token information"]


@pytest.fixture(scope="module")
def rags():
    """Both packages' query pipelines over the spine's three turns, with
    the trained embedder and generator (scheduled, sampling at the
    config's 0.7), no reranker (the filtered queries of
    ``test_torch_slice.py`` hold the same embed → search → rerank path);
    HyDE on through the config."""
    jcfg = JaxConfig(**{
        "embedding": {"backend": "bge-m3", "model": "eval-small"},
        "retrieval": {"backend": "tpu", "capacity_step": 128},
        "reranking": {"backend": "none"},
        "generation": {"backend": "llm-jax", "model": "eval-small",
                       "max_tokens": 48},
        "expansion": {"backend": "hyde"},
        "tts": {"backend": "null"}})
    jax_qp = QueryPipeline(jcfg)
    port = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        reranking=RerankingConfig(backend="none"),
        generation=GenerationConfig(model="eval-small", max_tokens=48),
        expansion=ExpansionConfig(backend="hyde"), device="cpu"))
    spans = [(6.0 * i, 6.0 * i + 6.0) for i in range(3)]
    jax_qp.retriever.add(
        [JaxChunk(t, s, e, speaker="SPEAKER_00")
         for t, (s, e) in zip(TURNS, spans)],
        jax_qp.embedder.embed(TURNS), "spine")
    port.store.add([AudioChunk(t, s, e, speaker="SPEAKER_00")
                    for t, (s, e) in zip(TURNS, spans)],
                   port.embedder.embed(TURNS), "spine")
    calls = _Calls(jax_qp.generator.inner), _Calls(port.generator.inner)
    yield jax_qp, port, calls
    jax_qp.generator.unload()
    port.generator.unload()


def _ranked(res):
    return [(r.text, round(r.score, 2)) for r in res.results]


@pytest.mark.parametrize("hyde,q", [(False, "spectrogram harmonic"),
                                    (True, "gradient descent loss")],
                         ids=["False", "True"])
def test_query_answers_as_jax(rags, hyde, q):
    """With HyDE off the fused path answers; on, the passage is embedded
    and searched: the JAX pipeline's prompts, passage, results and answer
    (:func:`_follow_calls`; after a sampled near-tie, the JAX pipeline's
    passage, results and answer from the port's generations), and the
    same stage names."""
    jax_qp, port, (jax_calls, port_calls) = rags
    assert isinstance(port.generator, ScheduledGenerator)
    starts = len(jax_calls.seen), len(port_calls.seen)
    ref = jax_qp.query(q, collection="spine", use_hyde=hyde,
                       generate_answer=True)
    got = port.query(q, collection="spine", use_hyde=hyde,
                     generate_answer=True)
    jax_gen = jax_qp.generator.inner
    if not _follow_calls(jax_gen, jax_calls, port_calls, starts):
        ref = _replayed(jax_gen, port_calls, starts[1], lambda: jax_qp.query(
            q, collection="spine", use_hyde=hyde, generate_answer=True))
    assert got.answer == ref.answer
    assert got.expanded_query == ref.expanded_query
    assert _ranked(got) == _ranked(ref)
    assert got.answer and (got.expanded_query is not None) == hyde
    assert set(got.stage_timings) == set(ref.stage_timings)
    assert "generate" in got.stage_timings
    assert port.query("gradient", collection="spine",
                      use_hyde=False).answer is None


def test_unload_all_stops_the_scheduler():
    """``AudioRAG.unload_all`` stops the wave scheduler's thread and drops
    the generator's weights; the next use builds a new generator."""
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        reranking=RerankingConfig(backend="none"),
        generation=GenerationConfig(model="eval-small"), device="cpu"))
    gen = rag.generator
    thread = gen.scheduler._thread
    assert thread.is_alive() and gen.inner.is_loaded
    rag.unload_all()
    assert not thread.is_alive() and not gen.inner.is_loaded
    with pytest.raises(RuntimeError, match="stopped"):
        gen.scheduler.submit("gradient")
    again = rag.generator
    assert again is not gen and again.is_loaded
    rag.unload_all()


def test_unported_modes_raise(monkeypatch):
    """An LLM checkpoint raises ``ConfigError`` naming what is not
    ported, and so does the trained generator when its asset is
    missing; the continuous batcher, the speculative program, PRF
    expansion and speech, ported since, build and answer instead (PRF's
    first pass finds nothing in an empty collection, so the query stands
    and nothing is spoken); the
    config refuses unknown names; "none" and "fake" build as in the JAX
    package."""
    sg = create_generator(GenerationConfig(
        model="eval-small", temperature=0.0, max_tokens=8,
        scheduler_mode="continuous", scheduler_slots=2), device="cpu")
    try:
        assert type(sg.scheduler).__name__ == "ContinuousBatcher"
        assert sg.generate("what is gradient descent")
    finally:
        sg.unload()
    gen = LLMGenerator(GenerationConfig(model="eval-small", temperature=0.0,
                                        speculative_k=4, max_tokens=8),
                       device="cpu")
    assert gen.generate("what is gradient descent") is not None
    assert gen.last_spec_stats["block_verifies"] >= 1
    missing = LLMGenerator(GenerationConfig(model="test",
                                            checkpoint_path="/x"), "cpu")
    missing.load()  # no /x/llm.safetensors: the seeded weights
    assert missing.is_loaded
    missing.unload()
    with monkeypatch.context() as m:
        m.setattr(llm_module, "load_llm_small", lambda *a: None)
        with pytest.raises(ConfigError, match="llm_small.npz"):
            LLMGenerator(GenerationConfig(model="eval-small"),
                         device="cpu").load()
    rag = AudioRAG(AudioRAGConfig(
        embedding=EmbeddingConfig(model="eval-small"),
        reranking=RerankingConfig(backend="none"),
        generation=GenerationConfig(backend="fake"),
        expansion=ExpansionConfig(backend="prf"), device="cpu"))
    out = rag.query("gradient", collection="c")
    assert out.expanded_query == "gradient" and not out.results
    # nothing retrieved, so no answer: the JAX pipeline speaks nothing and
    # builds no TTS
    out = rag.query("gradient", collection="c", use_hyde=False,
                    speak_answer=True)
    assert out.answer is None and out.audio is None
    assert "tts" not in out.stage_timings and not rag.querying._tts_built
    assert isinstance(rag.generator, FakeGenerator)
    rag.unload_all()
    assert create_generator(GenerationConfig(backend="none")) is None
    for bad in ({"backend": "ollama"}, {"scheduler_mode": "slots"},
                {"temperature": 3.0}):
        with pytest.raises(ConfigError):
            GenerationConfig(**bad)
    with pytest.raises(ConfigError):
        ExpansionConfig(num_hypotheses=4)


def test_new_modules_import_no_jax():
    """The source scan over the generation, expansion, scheduler,
    continuous batcher, contextual and LLM modules (``test_torch_slice.py`` imports every module of the port in
    a process without JAX)."""
    mods = ["audio_rag_tpu_torch/models/llm.py",
            "audio_rag_tpu_torch/generation/__init__.py",
            "audio_rag_tpu_torch/generation/base.py",
            "audio_rag_tpu_torch/generation/fake.py",
            "audio_rag_tpu_torch/generation/llm.py",
            "audio_rag_tpu_torch/generation/prompts.py",
            "audio_rag_tpu_torch/engine/scheduler.py",
            "audio_rag_tpu_torch/engine/continuous.py",
            "audio_rag_tpu_torch/contextual/__init__.py",
            "audio_rag_tpu_torch/contextual/processor.py",
            "audio_rag_tpu_torch/expansion/__init__.py",
            "audio_rag_tpu_torch/expansion/hyde.py"]
    for m in mods:
        roots = set()
        for node in ast.walk(ast.parse((ROOT / m).read_text())):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert roots and not roots & {"jax", "jaxlib", "audio_rag_tpu"}, m
