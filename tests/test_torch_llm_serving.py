"""The PyTorch port's LLM serving programs against the JAX package's, on
the CPU: ``llm_block_verify`` (the verify pass), ``llm_speculative_generate``
(k ∈ {2, 4, 8}; bf16, int8 and int4 head), ``llm_prefill_slots``,
``llm_decode_slots`` (greedy, and sampled at 0.3 / 0.7 / 1.3, whose
reciprocals are inexact) and ``llm_decode_slots_spec``, each against the
jitted JAX function on the ``test`` preset (f32) and on the committed
trained generator (``llm_small.npz``, bf16 storage); the per-row decode
step against the wave's; and the generator's speculative dispatch and its
``last_spec_stats`` against the JAX generator's. Tokens are exact; logits
are held within stated tolerances. Inputs come from numpy seeds; JAX trees
reach the port through ``weights.convert_llm``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import GenerationConfig as JaxGenConfig
from audio_rag_tpu.engine.engine import bf16_storage
from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxLLM
from audio_rag_tpu.models import llm as jl
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.config import GenerationConfig
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from audio_rag_tpu_torch.models import llm as tl
from audio_rag_tpu_torch.ops import random as trandom
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer
from audio_rag_tpu_torch.weights import convert_llm, load_llm_small
from torch_llm_common import one_torch_thread, rag_prompts  # noqa: F401

EOS = 2
#: profile → (weight bits or 0, head bits)
QUANT = {"bf16": (0, None), "int8": (8, None), "int8+lm4": (8, 4)}


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def test_preset():
    """The ``test`` preset's JAX weights (PRNGKey(0)) in f32, both trees."""
    dims = jl.LLM_PRESETS["test"]
    jp = jax.jit(lambda k: jl.init_llm(k, dims))(jax.random.PRNGKey(0))
    tp = convert_llm(jax.tree.map(np.asarray, jp), tl.LLM_PRESETS["test"],
                     dtype=torch.float32)
    return dims, tl.LLM_PRESETS["test"], jp, tp


@pytest.fixture(scope="module")
def asset():
    tree = load_npz_asset(ASSETS_DIR / "llm_small.npz")
    if tree is None:
        pytest.skip("trained LLM asset not built")
    dims = jl.LLM_PRESETS["eval-small"]
    jp = bf16_storage(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                                   tree))
    return dims, tl.LLM_PRESETS["eval-small"], jp, load_llm_small()


@functools.lru_cache(maxsize=None)
def _quantized(which, bits, lm_bits):
    """(JAX, port) quantized copies of a module fixture's weights."""
    dims, tdims, jp, tp = _TREES[which]
    if not bits:
        return None, None
    return (jax.jit(lambda p: jl.quantize_llm_weights(
        p, dims, bits, lm_head_bits=lm_bits))(jp),
        tl.quantize_llm_weights(tp, tdims, bits, lm_head_bits=lm_bits))


_TREES: dict = {}


@pytest.fixture(scope="module")
def trees(test_preset, asset):
    _TREES.update({"test": test_preset, "asset": asset})
    yield _TREES
    _quantized.cache_clear()
    _TREES.clear()
    _JITTED.clear()


_JITTED: dict = {}


def _jitted(fn, **static):
    """``jax.jit`` of ``fn`` with its static keywords bound, built once a
    module (each JAX reference compiles once per shape)."""
    key = (fn, tuple(sorted(static.items(), key=lambda kv: kv[0])))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, **static))
    return _JITTED[key]


def _t(a, dtype=torch.long):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _rag_rows(tok, n, seed):
    """``n`` RAG prompts tokenized for the trained generator."""
    return [tok.encode(p) for p in rag_prompts(n, seed=seed)]


def _left_padded(seqs, P):
    toks = np.full((len(seqs), P), EOS, np.int32)
    mask = np.zeros((len(seqs), P), bool)
    for i, s in enumerate(seqs):
        toks[i, P - len(s):], mask[i, P - len(s):] = s, True
    return toks, mask


# -- the verify pass and the per-row decode step ------------------------------------

def _filled_cache(dims, B, C, seed, dtype):
    """A (L, B, HKV, C, hd) cache pair of seeded values in ``dtype``."""
    rng = np.random.default_rng(seed)
    hd = dims.d_model // dims.n_heads
    shape = (dims.n_layers, B, dims.n_kv_heads, C, hd)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


#: case → (trees, jax dtype, torch dtype, quant profile, logits atol)
VERIFY = {"test-f32": ("test", jnp.float32, torch.float32, "bf16", 1e-5),
          "asset-bf16": ("asset", jnp.bfloat16, torch.bfloat16, "bf16",
                         0.1),
          "asset-int8": ("asset", jnp.bfloat16, torch.bfloat16, "int8",
                         0.1),
          "asset-int8+lm4": ("asset", jnp.bfloat16, torch.bfloat16,
                             "int8+lm4", 0.1)}


@pytest.mark.parametrize("case", list(VERIFY))
def test_block_verify_matches_jax(trees, case):
    """A k = 4 block at per-row positions (one row's block runs into the
    cache's last frame, where the clipped writes alias) over a seeded
    cache with pad frames: the JAX function's logits (f32: within 1e-5;
    bf16: within 0.1, a few bf16 ulps of logits up to ~20) and its cache
    at every frame a row wrote inside its range; the same first-position
    argmax."""
    which, jdt, tdt, prof, atol = VERIFY[case]
    dims, tdims, jp, tp = trees[which]
    jq8, tq8 = _quantized(which, *QUANT[prof])
    B, C, k = 3, 40, 4
    rng = np.random.default_rng(17)
    block = rng.integers(4, dims.vocab, (B, k)).astype(np.int32)
    pos = np.array([5, 20, C - 2], np.int32)
    valid = np.ones((B, C), bool)
    valid[0, :2] = False  # a left-padded row
    rope = pos - np.array([2, 0, 0], np.int32)
    ck, cv = _filled_cache(dims, B, C, 3, np.float32)
    ref, rk, rv = _jitted(jl.llm_block_verify, dims=dims, dtype=jdt)(
        jp, block=jnp.asarray(block), pos=jnp.asarray(pos),
        cache_k=jnp.asarray(ck).astype(jdt),
        cache_v=jnp.asarray(cv).astype(jdt), kv_valid=jnp.asarray(valid),
        rope_pos=jnp.asarray(rope), q8=jq8)
    tk, tv = _t(ck, tdt), _t(cv, tdt)
    got, gk, gv = tl.llm_block_verify(
        tp, tdims, _t(block), _t(pos), tk, tv, kv_valid=_t(valid, torch.bool),
        rope_pos=_t(rope), dtype=tdt, q8=tq8)
    assert got.shape == (B, k, dims.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)
    assert (got[:, 0].argmax(-1).numpy()
            == np.asarray(ref)[:, 0].argmax(-1)).all()
    for b in range(B):  # the frames written in range (not the aliased tail)
        for j in range(min(k, C - pos[b] - 1)):
            f = pos[b] + j
            np.testing.assert_allclose(_f32(gk[:, b, :, f]),
                                       _f32(rk[:, b, :, f]), rtol=0,
                                       atol=atol)
            np.testing.assert_allclose(_f32(gv[:, b, :, f]),
                                       _f32(rv[:, b, :, f]), rtol=0,
                                       atol=atol)


def test_verify_and_per_row_step_match_the_wave_step(trees):
    """f32, ``test`` preset, a left-padded batch: a verify block's logits at
    position j equal the wave decode step's teacher-forced at that
    position, and the per-row decode step (positions as a tensor) equals
    the wave step (one int position) — within 1e-5 — and writes the same
    frames."""
    _, tdims, _, tp = trees["test"]
    rng = np.random.default_rng(8)
    B, P, C, k = 2, 8, 24, 4
    seqs = [rng.integers(4, tdims.vocab, n).tolist() for n in (8, 5)]
    toks, mask = _left_padded(seqs, P)
    block = rng.integers(4, tdims.vocab, (B, k))
    valid = np.concatenate([mask, np.ones((B, C - P), bool)], 1)
    pos_ids = np.maximum(np.cumsum(mask, 1) - 1, 0)
    offset = P - mask.sum(1)
    hd = tdims.d_model // tdims.n_heads

    def prefilled():
        c = [torch.zeros((tdims.n_layers, B, tdims.n_kv_heads, C, hd))
             for _ in range(2)]
        tl.llm_forward(tp, tdims, _t(toks), 0, tuple(c), torch.float32,
                       kv_valid=_t(valid, torch.bool), pos_ids=_t(pos_ids))
        return c

    wave, per_row = prefilled(), prefilled()
    kv = _t(valid, torch.bool)
    steps = []
    for j in range(k):
        i = P + j
        lg, *wave = tl.llm_decode_step(
            tp, tdims, _t(block[:, j]), i, *wave, kv_valid=kv,
            dtype=torch.float32, rope_pos=_t(i - offset))
        lr, *per_row = tl.llm_decode_step(
            tp, tdims, _t(block[:, j]), torch.full((B,), i), *per_row,
            kv_valid=kv, dtype=torch.float32, rope_pos=_t(i - offset))
        np.testing.assert_allclose(lr.numpy(), lg.numpy(), rtol=1e-5,
                                   atol=1e-5)
        steps.append(lg)
    for a, b in zip(wave, per_row):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
    got, *_ = tl.llm_block_verify(
        tp, tdims, _t(block), torch.full((B,), P), *prefilled(), kv_valid=kv,
        rope_pos=_t(P - offset), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(),
                               torch.stack(steps, 1).numpy(), rtol=1e-5,
                               atol=1e-5)


# -- speculative generation ----------------------------------------------------------

def _jax_spec(dims, max_new, k):
    return _jitted(jl.llm_speculative_generate, dims=dims,
                   max_new_tokens=max_new, eos_id=EOS, spec_k=k,
                   return_stats=True)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_speculative_matches_jax_test_preset(trees, k):
    """f32, ``test`` preset: the JAX test's left-padded rows of unequal
    length, 12 new tokens — the JAX function's tokens and verify count,
    and the port's greedy wave's tokens; rows past EOS hold EOS."""
    dims, tdims, jp, tp = trees["test"]
    toks, mask = _left_padded([[7, 11, 13, 17, 19, 23], [101, 103, 107],
                               [5]], 8)
    ref, iters = _jitted(
        jl.llm_speculative_generate, dims=dims, max_new_tokens=12, eos_id=0,
        spec_k=k, dtype=jnp.float32, return_stats=True)(
        jp, prompt=jnp.asarray(toks), prompt_mask=jnp.asarray(mask))
    stats = {}
    got, n = tl.llm_speculative_generate(
        tp, tdims, _t(toks), 12, 0, spec_k=k, dtype=torch.float32,
        prompt_mask=_t(mask, torch.bool), stats=stats)
    wave = tl.llm_generate(tp, tdims, _t(toks), 12, 0, dtype=torch.float32,
                           prompt_mask=_t(mask, torch.bool))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), wave.numpy())
    assert n == int(iters) == stats["steps"] >= 1


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("prof", list(QUANT))
def test_speculative_matches_jax_on_the_asset(trees, prof, k):
    """The trained generator, bf16 storage, unquantized, int8 and int8 +
    int4 head: a RAG prompt of its own for each case, a single left-padded
    row (the generator's speculative request), 48 new tokens — the jitted
    JAX function's tokens and verify count, and the port's greedy wave's
    tokens. The answer ends in EOS."""
    dims, tdims, jp, tp = trees["asset"]
    jq8, tq8 = _quantized("asset", *QUANT[prof])
    tok = get_tokenizer(vocab_size=dims.vocab)
    seed = 5 + k + 10 * list(QUANT).index(prof)
    for s in _rag_rows(tok, 1, seed=seed):
        P = 1 << (len(s) - 1).bit_length()
        toks, mask = _left_padded([s], P)
        ref, iters = _jax_spec(dims, 48, k)(
            jp, prompt=jnp.asarray(toks), prompt_mask=jnp.asarray(mask),
            decoder_q8=jq8)
        got, n = tl.llm_speculative_generate(
            tp, tdims, _t(toks), 48, EOS, spec_k=k,
            prompt_mask=_t(mask, torch.bool), decoder_q8=tq8)
        wave = tl.llm_generate(tp, tdims, _t(toks), 48, EOS,
                               prompt_mask=_t(mask, torch.bool),
                               decoder_q8=tq8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), wave.numpy())
        assert n == int(iters)
        assert (got[0, P:] == EOS).any()


def test_generator_speculative_dispatch_matches_jax(trees):
    """``LLMGenerator`` with ``speculative_k`` 4 at temperature 0: a single
    prompt runs the speculative program (the JAX generator's text, ids and
    ``last_spec_stats``; the same text as with ``speculative_k`` 0), a
    batch of two runs the wave (no speculative figures), and a sampled
    single prompt the wave."""
    kw = {"model": "eval-small", "temperature": 0.0, "max_tokens": 48,
          "use_scheduler": False, "speculative_k": 4, "decoder_int8": True}
    jax_gen = JaxLLM(JaxGenConfig(backend="llm-jax", **kw))
    jax_gen.load()
    gen = LLMGenerator(GenerationConfig(**kw), device="cpu")
    plain = LLMGenerator(GenerationConfig(**{**kw, "speculative_k": 0}),
                         device="cpu")
    prompts = rag_prompts(2, seed=31)
    for p in prompts:
        ref = jax_gen.generate(p)
        got = gen.generate(p)
        assert got == ref == plain.generate(p)
        assert gen.last_token_ids == jax_gen.last_token_ids
        assert gen.last_spec_stats == jax_gen.last_spec_stats
        st = gen.last_spec_stats
        assert st["tokens_emitted"] == gen.last_token_counts[0]
        assert st["block_verifies"] == gen.last_stats["steps"] >= 1
        assert 0.0 <= st["accept_rate"] <= 1.0
    assert gen.generate_batch(prompts[:2]) == jax_gen.generate_batch(
        prompts[:2])
    assert gen.last_spec_stats is None is jax_gen.last_spec_stats
    assert gen.last_stats["rows"] == 2
    gen.generate(prompts[0], temperature=0.7)
    assert gen.last_spec_stats is None
    jax_gen.unload()


# -- the slot programs ---------------------------------------------------------------

#: the slot tests' requests: (slot, prompt index) — slot 1 stays free; row 3
#: is the admission bucket's filler (a copy of row 0)
SLOTS = [2, 0, 3, 2]


def _slot_inputs(which, trees, C):
    """Right-padded prompts for ``SLOTS`` (three RAG prompts on the asset;
    seeded tokens of 5 to 30 on the test preset) and their lengths."""
    dims = trees[which][0]
    if which == "asset":
        seqs = _rag_rows(get_tokenizer(vocab_size=dims.vocab), 3, seed=9)
    else:
        rng = np.random.default_rng(21)
        seqs = [rng.integers(4, dims.vocab, n).tolist() for n in (30, 5, 17)]
    seqs = seqs + [seqs[0]]
    Pb = 1 << (max(map(len, seqs)) - 1).bit_length()
    prompts = np.full((4, Pb), EOS, np.int32)
    n_valid = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        prompts[i, :len(s)] = s
    return seqs, prompts, n_valid


#: case → (trees, jax dtype, torch dtype, cache frames)
SLOT_CASES = {"test-f32": ("test", jnp.float32, torch.float32, 96),
              "asset-bf16": ("asset", jnp.bfloat16, torch.bfloat16, 320)}
TEMPS = {"greedy": [0.0, 0.0, 0.0, 0.0], "t0.3": [0.3] * 4,
         "t0.7": [0.7] * 4, "t1.3": [1.3] * 4,
         "mixed": [0.0, 0.7, 1.3, 0.0]}


def _prefilled_slots(which, trees, C, temps, jdt, tdt):
    """Both packages' slot caches after one admission of ``SLOTS`` at
    ``temps``: (JAX cache, port cache, JAX first tokens, port first tokens,
    prompt lengths, prompt token lists)."""
    dims, tdims, jp, tp = trees[which]
    seqs, prompts, n_valid = _slot_inputs(which, trees, C)
    hd = dims.d_model // dims.n_heads
    shape = (dims.n_layers, 4, dims.n_kv_heads, C, hd)
    jck, jcv, jfirst = _jitted(jl.llm_prefill_slots, dims=dims, dtype=jdt)(
        jp, prompts=jnp.asarray(prompts), n_valid=jnp.asarray(n_valid),
        cache_k=jnp.zeros(shape, jdt), cache_v=jnp.zeros(shape, jdt),
        slots=jnp.asarray(SLOTS, jnp.int32),
        temps=jnp.asarray(temps, jnp.float32), rng=jax.random.PRNGKey(3))
    tck, tcv = (torch.zeros(shape, dtype=tdt) for _ in range(2))
    tck, tcv, tfirst = tl.llm_prefill_slots(
        tp, tdims, _t(prompts), _t(n_valid), tck, tcv, SLOTS, temps,
        trandom.PRNGKey(3), dtype=tdt)
    return (jck, jcv), (tck, tcv), np.asarray(jfirst), tfirst.numpy(), \
        n_valid, seqs


def _slot_state(first, n_valid, temps):
    """(last tokens, positions, active, temperatures) of the 4 slots after
    admitting the first three rows of ``SLOTS``."""
    last, pos = np.zeros(4, np.int32), np.zeros(4, np.int32)
    active, st = np.zeros(4, bool), [0.0] * 4
    for r in range(3):
        s = SLOTS[r]
        last[s], pos[s], active[s], st[s] = first[r], n_valid[r], True, \
            temps[r]
    return last, pos, active, st


@pytest.mark.parametrize("temps", list(TEMPS))
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_prefill_and_decode_slots_match_jax(trees, case, temps):
    """One admission of three prompts into slots 2, 0, 3 (slot 1 free; the
    bucket's filler row repeats row 0) and a 16-step segment, greedy or
    sampled at T whose reciprocal is inexact: the JAX functions' first
    tokens, segment tokens and positions exactly, and the cache frames
    each request wrote (f32: within 1e-5; bf16: within 0.07, a bf16 ulp
    of |K|, |V| < 16)."""
    which, jdt, tdt, C = SLOT_CASES[case]
    dims, tdims, jp, tp = trees[which]
    temps = TEMPS[temps]
    jc, tc, jfirst, tfirst, n_valid, _ = _prefilled_slots(
        which, trees, C, temps, jdt, tdt)
    np.testing.assert_array_equal(tfirst, jfirst)
    last, pos, active, st = _slot_state(jfirst, n_valid, temps)
    ref, jk, jv, jpos, jfin = _jitted(
        jl.llm_decode_slots, dims=dims, n_steps=16, eos_id=EOS, dtype=jdt)(
        jp, last_tok=jnp.asarray(last), cache_k=jc[0], cache_v=jc[1],
        pos=jnp.asarray(pos), active=jnp.asarray(active),
        temps=jnp.asarray(st, jnp.float32), rng=jax.random.PRNGKey(5))
    got, tk, tv, tpos, tfin = tl.llm_decode_slots(
        tp, tdims, _t(last), *tc, _t(pos), _t(active, torch.bool), st,
        trandom.PRNGKey(5), 16, EOS, dtype=tdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    assert (got[1] == EOS).all()  # the free slot
    tol = 1e-5 if tdt == torch.float32 else 0.07
    for r in range(3):
        s = SLOTS[r]
        hi = int(jpos[s])
        np.testing.assert_allclose(_f32(tk[:, s, :, :hi]),
                                   _f32(jk[:, s, :, :hi]), rtol=0, atol=tol)
        np.testing.assert_allclose(_f32(tv[:, s, :, :hi]),
                                   _f32(jv[:, s, :, :hi]), rtol=0, atol=tol)


def test_sampling_divides_by_the_temperature(monkeypatch):
    """The slot programs' sampled scores are ``logits / T`` by true f32
    division, bit for bit the jitted JAX expression (a product with the
    f32 reciprocal differs at 0.3 and 0.7), and a greedy row keeps its
    argmax."""
    rng = np.random.default_rng(4)
    lg = (rng.standard_normal((4, 4096)) * 9).astype(np.float32)
    temps = [0.3, 0.7, 1.3, 0.0]
    ref = np.asarray(jax.jit(lambda x, t: x / jnp.where(
        t > 0, t, 1.0)[:, None])(jnp.asarray(lg), jnp.asarray(temps,
                                                               jnp.float32)))
    seen = []
    orig = trandom.categorical

    def spy(key, logits):
        seen.append(logits.numpy().copy())
        return orig(key, logits)

    monkeypatch.setattr(trandom, "categorical", spy)
    got = tl._pick_rows(torch.from_numpy(lg), tl._Temps(temps, "cpu"),
                        trandom.PRNGKey(1))
    np.testing.assert_array_equal(seen[0], ref)
    inv = lg * (np.float32(1) / np.asarray(temps[:3] + [1.0],
                                           np.float32))[:, None]
    assert (inv[:2] != ref[:2]).any()
    assert int(got[3]) == int(lg[3].argmax())
    key = jax.random.PRNGKey(1)
    want = jax.random.categorical(key, jnp.asarray(ref), axis=-1)
    np.testing.assert_array_equal(got[:3].numpy(), np.asarray(want)[:3])


@pytest.mark.parametrize("temps", ["greedy", "mixed"])
@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_decode_slots_spec_matches_jax(trees, case, temps):
    """The speculative segment (k = 4, 16 steps) from the same admission,
    each slot's prompt tail and first token as its history: the JAX
    function's tokens and positions exactly; its greedy slots' tokens are
    the plain segment's."""
    which, jdt, tdt, C = SLOT_CASES[case]
    dims, tdims, jp, tp = trees[which]
    temps = TEMPS[temps]
    jc, tc, jfirst, _, n_valid, seqs = _prefilled_slots(
        which, trees, C, temps, jdt, tdt)
    last, pos, active, st = _slot_state(jfirst, n_valid, temps)
    hist = np.full((4, 32), -1, np.int32)
    for r in range(3):
        tail = (list(seqs[r]) + [int(jfirst[r])])[-32:]
        hist[SLOTS[r], 32 - len(tail):] = tail
    plain, *_ = tl.llm_decode_slots(
        tp, tdims, _t(last), *(c.clone() for c in tc), _t(pos),
        _t(active, torch.bool), st, trandom.PRNGKey(5), 16, EOS, dtype=tdt)
    ref, _, _, jpos, _ = _jitted(
        jl.llm_decode_slots_spec, dims=dims, n_steps=16, eos_id=EOS,
        spec_k=4, dtype=jdt)(
        jp, history=jnp.asarray(hist), cache_k=jc[0], cache_v=jc[1],
        pos=jnp.asarray(pos), active=jnp.asarray(active),
        temps=jnp.asarray(st, jnp.float32), rng=jax.random.PRNGKey(5))
    got, _, _, tpos, _ = tl.llm_decode_slots_spec(
        tp, tdims, _t(hist), *tc, _t(pos), _t(active, torch.bool), st,
        trandom.PRNGKey(5), 16, EOS, spec_k=4, dtype=tdt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for s, t in enumerate(st):
        if active[s] and t <= 0:
            np.testing.assert_array_equal(got[s].numpy(), plain[s].numpy())
