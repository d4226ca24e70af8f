"""The PyTorch port's LLM against the JAX package's, on the CPU: the llama
layers (rms_norm, silu, swiglu, apply_rope) at f32 and bf16, the forward
at the ``test`` preset in f32, the decode step against the forward, the
int8 / int4 / int8 + int4-head weight quantizer bit for bit against the
jitted JAX function, and ``llm_generate`` on the committed trained asset
(``llm_small.npz``, bf16 storage): the same greedy tokens unquantized,
under ``decoder_int8`` and under ``lm_head_int4``, and the same sampled
tokens at temperature 0.7 from the same key, on left-padded prompts of
unequal length. Inputs come from numpy seeds; JAX trees reach the port
through ``weights.convert_llm``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.engine.engine import bf16_storage
from audio_rag_tpu.models import layers as jL
from audio_rag_tpu.models import llm as jl
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.models import layers as tL
from audio_rag_tpu_torch.models import llm as tl
from audio_rag_tpu_torch.ops import random as trandom
from audio_rag_tpu_torch.weights import convert_llm, load_llm_small
from torch_llm_common import one_torch_thread, rag_prompts  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _t(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def _ulps(a, b):
    """|a − b| in bf16 ulps of the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1))) - 7)
    return np.abs(a - b) / ulp


# -- the layers ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_llama_layers_match_jax(name):
    """bf16: rms_norm, rope and silu bit for bit (their roundings and
    XLA:CPU's sum order); swiglu within one ulp, in ≥ 99 % of places
    exactly (its products sum in another order). f32: within 1e-5, relative
    and of the largest magnitude (sums in other orders)."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 7, 256)).astype(np.float32) * 3
    g = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    tx, tg = _t(jx, tdt), _t(jg, tdt)
    w = {k: {"w": jnp.asarray(rng.standard_normal(s).astype(np.float32)
                              * 0.06).astype(jdt)}
         for k, s in (("gate", (256, 512)), ("up", (256, 512)),
                      ("down", (512, 256)))}
    tw = {k: {"w": _t(v["w"], tdt)} for k, v in w.items()}
    cos, sin = jL.rope_frequencies(32, 64, 10000.0)
    tcos, tsin = tL.rope_frequencies(32, 64, 10000.0)
    np.testing.assert_array_equal(tcos, cos)
    np.testing.assert_array_equal(tsin, sin)
    xr = jnp.asarray(rng.standard_normal((2, 4, 7, 32)).astype(np.float32)
                     ).astype(jdt)
    u = jnp.asarray(rng.standard_normal((64, 512)).astype(np.float32) * 3
                    ).astype(jdt)
    pairs = {
        "rms_norm": (jax.jit(jL.rms_norm)({"g": jg}, jx),
                     tL.rms_norm({"g": tg}, tx)),
        "rope": (jax.jit(lambda a: jL.apply_rope(a, cos[:7], sin[:7]))(xr),
                 tL.apply_rope(_t(xr, tdt), torch.from_numpy(tcos[:7]),
                               torch.from_numpy(tsin[:7]))),
        "silu": (jax.jit(jax.nn.silu)(u), tL.silu(_t(u, tdt))),
        "swiglu": (jax.jit(lambda p, a: jL.swiglu(p, a, jdt))(w, jx),
                   tL.swiglu(tw, tx, tdt)),
    }
    for what, (ref, got) in pairs.items():
        assert got.dtype == tdt, what
        ref, got = _np(ref), _np(got)
        if name == "f32":
            np.testing.assert_allclose(got, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=what)
        elif what == "swiglu":
            assert _ulps(got, ref).max() <= 1 and (got == ref).mean() > 0.99
        else:
            np.testing.assert_array_equal(got, ref, err_msg=what)


# -- the model at the test preset, f32 -----------------------------------------------

@pytest.fixture(scope="module")
def test_preset():
    dims = jl.LLM_PRESETS["test"]
    jp = jax.jit(lambda k: jl.init_llm(k, dims))(jax.random.PRNGKey(0))
    tp = convert_llm(jax.tree.map(np.asarray, jp), tl.LLM_PRESETS["test"],
                     dtype=torch.float32)
    return dims, jp, tp


def _left_padded(rng, lengths, P, vocab):
    toks = np.full((len(lengths), P), 2, np.int32)
    mask = np.zeros((len(lengths), P), bool)
    for i, n in enumerate(lengths):
        toks[i, P - n:] = rng.integers(4, vocab, n)
        mask[i, P - n:] = True
    return toks, mask


def test_forward_matches_jax_at_f32(test_preset):
    """Full-sequence logits, and a left-padded prefill into a cache with
    true rope positions and only the last position projected, rtol 1e-5."""
    dims, jp, tp = test_preset
    tdims = tl.LLM_PRESETS["test"]
    rng = np.random.default_rng(3)
    toks = rng.integers(4, dims.vocab, (2, 12)).astype(np.int32)
    ref, _ = jax.jit(lambda p, t: jl.llm_forward(p, dims, t,
                                                 dtype=jnp.float32))(
        jp, jnp.asarray(toks))
    got, cache = tl.llm_forward(tp, tdims, torch.from_numpy(toks).long(),
                                dtype=torch.float32)
    assert cache is None and got.shape == (2, 12, dims.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)

    toks, mask = _left_padded(rng, (10, 6, 1), 10, dims.vocab)
    C, hd = 16, dims.d_model // dims.n_heads
    valid = np.concatenate([mask, np.ones((3, C - 10), bool)], 1)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    jc = (jnp.zeros((dims.n_layers, 3, dims.n_kv_heads, C, hd)),) * 2
    ref, jc = jax.jit(lambda p, t, c: jl.llm_forward(
        p, dims, t, 0, c, jnp.float32, kv_valid=jnp.asarray(valid),
        pos_ids=jnp.asarray(pos), last_pos=jnp.full((3,), 9, jnp.int32)))(
        jp, jnp.asarray(toks), jc)
    tc = tuple(torch.zeros((dims.n_layers, 3, dims.n_kv_heads, C, hd))
               for _ in range(2))
    got, tc = tl.llm_forward(tp, tdims, torch.from_numpy(toks).long(), 0, tc,
                             torch.float32,
                             kv_valid=torch.from_numpy(valid),
                             pos_ids=torch.from_numpy(pos),
                             last_pos=torch.full((3,), 9))
    assert got.shape == (3, 1, dims.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for g, r in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_decode_step_matches_forward(test_preset):
    """Prefill, then decode steps (left-padded rows, per-row rope
    positions): each step's logits equal the full forward's at that
    position (rtol 1e-5), and the JAX decode step's."""
    dims, jp, tp = test_preset
    tdims = tl.LLM_PRESETS["test"]
    rng = np.random.default_rng(4)
    P, steps, C = 8, 4, 16
    hd = dims.d_model // dims.n_heads
    toks, mask = _left_padded(rng, (8, 5), P, dims.vocab)
    ext = np.concatenate([toks, rng.integers(4, dims.vocab, (2, steps))
                          .astype(np.int32)], 1)
    valid = np.concatenate([mask, np.ones((2, C - P), bool)], 1)
    offset = P - mask.sum(1)
    full_mask = np.concatenate([mask, np.ones((2, steps), bool)], 1)
    full_pos = np.maximum(np.cumsum(full_mask, 1) - 1, 0)
    full, _ = tl.llm_forward(
        tp, tdims, torch.from_numpy(ext).long(), dtype=torch.float32,
        kv_valid=torch.from_numpy(full_mask), pos_ids=torch.from_numpy(
            full_pos))
    tc = [torch.zeros((dims.n_layers, 2, dims.n_kv_heads, C, hd))
          for _ in range(2)]
    tl.llm_forward(tp, tdims, torch.from_numpy(toks).long(), 0, tuple(tc),
                   torch.float32, kv_valid=torch.from_numpy(valid),
                   pos_ids=torch.from_numpy(full_pos[:, :P]))
    jc = [jnp.asarray(c.numpy()) for c in tc]
    jstep = jax.jit(lambda p, t, i, ck, cv, rp: jl.llm_decode_step(
        p, dims, t, i, ck, cv, kv_valid=jnp.asarray(valid),
        dtype=jnp.float32, rope_pos=rp))
    for s in range(steps):
        i = P + s
        got, *tc = tl.llm_decode_step(
            tp, tdims, torch.from_numpy(ext[:, i]).long(), i, *tc,
            kv_valid=torch.from_numpy(valid), dtype=torch.float32,
            rope_pos=torch.from_numpy(i - offset))
        ref, *jc = jstep(jp, jnp.asarray(ext[:, i]), jnp.int32(i), *jc,
                         jnp.asarray(i - offset, jnp.int32))
        np.testing.assert_allclose(got.numpy(), full[:, i].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# -- the trained asset ---------------------------------------------------------------

@pytest.fixture(scope="module")
def asset():
    tree = load_npz_asset(ASSETS_DIR / "llm_small.npz")
    if tree is None:
        pytest.skip("trained LLM asset not built")
    dims = jl.LLM_PRESETS["eval-small"]
    # the JAX generator's load: f32 from the f16 asset, then bf16 storage
    jp = bf16_storage(jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                                   tree))
    tp = load_llm_small()
    return dims, jp, tp


#: profile → (weight bits, head bits)
QUANT = {"int8": (8, None), "int4": (4, None), "int8+lm4": (8, 4)}


@pytest.mark.parametrize("profile", list(QUANT))
def test_quantizer_is_bit_exact(asset, profile):
    """The fused QKV and gate/up concatenations, the int8 per-column and
    int4 group scales and the head, equal to the jitted JAX function's."""
    dims, jp, tp = asset
    bits, lm_bits = QUANT[profile]
    ref = jax.jit(lambda p: jl.quantize_llm_weights(
        p, dims, bits, lm_head_bits=lm_bits))(jp)
    got = tl.quantize_llm_weights(tp, tl.LLM_PRESETS["eval-small"], bits,
                                  lm_head_bits=lm_bits)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, g), (_, r) in zip(flat_got, flat_ref):
        assert g.dtype == np.asarray(r).dtype, path
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=str(path))
    n_bytes = sum(g.nbytes for _, g in flat_got)
    assert n_bytes == tl.q8_param_bytes(tl.LLM_PRESETS["eval-small"], bits,
                                        lm_bits) == jl.q8_param_bytes(
        dims, bits, lm_bits)


#: case → (weight bits or 0, head bits, temperature)
GENERATE = {"greedy": (0, None, 0.0), "int8": (8, None, 0.0),
            "int8+lm4": (8, 4, 0.0), "sampled": (0, None, 0.7)}


@pytest.mark.parametrize("case", list(GENERATE))
def test_generate_matches_jax_on_the_asset(asset, case):
    """Four RAG prompts of unequal length, left-padded to 256 tokens, up to
    48 new tokens: the same tokens as the JAX package's jitted wave
    program, greedy in bf16 storage unquantized, under int8 weights, under
    int8 weights with an int4 head, and sampled at temperature 0.7 from
    ``PRNGKey(7)``. Greedy rows end in EOS before the window fills."""
    from audio_rag_tpu_torch.text.tokenizer import get_tokenizer

    dims, jp, tp = asset
    tdims = tl.LLM_PRESETS["eval-small"]
    bits, lm_bits, temp = GENERATE[case]
    tok = get_tokenizer(vocab_size=dims.vocab)
    seqs = [tok.encode(t) for t in rag_prompts(4)]
    assert len({len(s) for s in seqs}) == 4 and max(map(len, seqs)) <= 256
    P = 256
    toks = np.full((4, P), 2, np.int32)
    mask = np.zeros((4, P), bool)
    for i, s in enumerate(seqs):
        toks[i, P - len(s):] = s
        mask[i, P - len(s):] = True
    jq8 = tq8 = None
    if bits:
        jq8 = jax.jit(lambda p: jl.quantize_llm_weights(
            p, dims, bits, lm_head_bits=lm_bits))(jp)
        tq8 = tl.quantize_llm_weights(tp, tdims, bits, lm_head_bits=lm_bits)
    fn = jax.jit(functools.partial(jl.llm_generate, dims=dims,
                                   max_new_tokens=48, eos_id=2,
                                   temperature=temp))
    ref = np.asarray(fn(jp, prompt=jnp.asarray(toks),
                        rng=jax.random.PRNGKey(7),
                        prompt_mask=jnp.asarray(mask), decoder_q8=jq8))
    stats = {}
    got = tl.llm_generate(tp, tdims, torch.from_numpy(toks).long(), 48, 2,
                          temperature=temp, rng=trandom.PRNGKey(7),
                          prompt_mask=torch.from_numpy(mask),
                          decoder_q8=tq8, stats=stats)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 1 <= stats["steps"] <= 47
    new = ref[:, P:]
    assert (new != 2).any()  # the model writes
    if temp == 0.0:
        assert (new == 2).any(axis=1).all()  # and stops
