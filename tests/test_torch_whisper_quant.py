"""The PyTorch port's Whisper against the JAX package's on the CPU, on the
committed trained tiny model, part 2 (see ``test_torch_whisper.py``): the
int8 and int4 cross K/V, the int4 and mixed decoder trees, the int8 self
cache and a decoder step on it, and greedy tokens in the decode profiles
with int4 weights, int4 cross K/V or the int8 self cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import (
    whisper_cross_kv,
    whisper_params,
    whisper_q8_params,
    whisper_self_cache_q8,
)
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_whisper_common import (  # noqa: F401
    DIMS,
    NEEDS_ASSET,
    TDIMS,
    _jax_q8,
    check_greedy_decode,
    encoded,
    mel,
    models,
)

pytestmark = NEEDS_ASSET


def _exact_cross_inputs():
    """The test preset with cross K/V weights and encoder states whose
    products and sums are exact in f32, so both packages feed the quantizer
    the same numbers."""
    dims = jw.WHISPER_PRESETS["test"]
    rng = np.random.default_rng(6)
    tree = jax.tree.map(np.asarray, jw.init_whisper(jax.random.PRNGKey(1),
                                                    dims))
    for blk in ("k", "v"):
        cross = tree["decoder"]["blocks"]["cross"][blk]
        cross["w"] = rng.integers(-32, 33, cross["w"].shape).astype(
            np.float32) / 64
        if "b" in cross:
            cross["b"] = rng.integers(-8, 9, cross["b"].shape).astype(
                np.float32) / 64
    enc = rng.integers(-32, 33, (2, dims.n_audio_ctx, dims.n_text_state)
                       ).astype(np.float32) / 8
    return dims, tree, enc


def test_int8_cross_kv_is_bit_exact():
    """The int8 K/V in the transposed (L, B, H, D, Ta) layout and the
    per-(L, B, H) scales are identical, rounding ties included."""
    dims, tree, enc = _exact_cross_inputs()
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jw.precompute_cross_kv(jp, dims, jnp.asarray(enc), jnp.float32,
                                 quantize=True)
    tp = whisper_params(tree, tw.WHISPER_PRESETS["test"], "cpu")
    got = tw.precompute_cross_kv(tp, tw.WHISPER_PRESETS["test"],
                                 torch.from_numpy(enc), torch.float32,
                                 quantize=True)
    for g, r, dtype in zip(got, ref, (torch.int8, torch.int8,
                                      torch.float32, torch.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_int4_cross_kv_is_bit_exact():
    """The int4 K/V nibble-packed along D in half-split order
    (L, B, H, D/2, Ta) and the per-channel (L, B, H, 1, D) scales are
    identical, rounding ties included; the teacher-forced path's unpacking
    is the JAX package's."""
    dims, tree, enc = _exact_cross_inputs()
    tdims = tw.WHISPER_PRESETS["test"]
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jw.precompute_cross_kv(jp, dims, jnp.asarray(enc), jnp.float32,
                                 quantize=True, bits=4)
    tp = whisper_params(tree, tdims, "cpu")
    got = tw.precompute_cross_kv(tp, tdims, torch.from_numpy(enc),
                                 torch.float32, quantize=True, bits=4)
    hd = dims.n_text_state // dims.n_text_head
    assert got[0].shape == (dims.n_text_layer, 2, dims.n_text_head, hd // 2,
                            dims.n_audio_ctx)
    assert got[2].shape == (dims.n_text_layer, 2, dims.n_text_head, 1, hd)
    for g, r, dtype in zip(got, ref, (torch.int8, torch.int8,
                                      torch.float32, torch.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tw._unpack_kv4(got[0]).numpy(),
                                  np.asarray(jw._unpack_kv4(ref[0])))
    with pytest.raises(ValueError, match="bits"):
        tw.precompute_cross_kv(tp, tdims, torch.from_numpy(enc),
                               torch.float32, quantize=True, bits=2)


@pytest.mark.parametrize("bits,lm_head_bits", [(4, None), (8, 4)])
def test_int4_and_mixed_decoder_trees_are_bit_exact(models, bits,
                                                    lm_head_bits):
    """The all-int4 tree and the int8-blocks + int4-head tree carry the
    JAX package's packed bytes and scales exactly."""
    jp, tp = models
    ref = whisper_q8_params(jax.tree.map(np.asarray, _jax_q8(
        jp, DIMS, bits, lm_head_bits)), TDIMS, "cpu")
    got = tw.quantize_decoder_weights(tp, TDIMS, bits, lm_head_bits)
    assert set(got["logits"]) == {"w4", "s"}
    assert set(got["blocks"][0]["mlp_up"]) == ({"w4", "s"} if bits == 4
                                               else {"w8", "s"})
    for g, r in zip(got["blocks"] + [{"logits": got["logits"]}],
                    ref["blocks"] + [{"logits": ref["logits"]}]):
        for name in r:
            assert g[name].keys() == r[name].keys()
            for key in r[name]:
                assert g[name][key].dtype == r[name][key].dtype
                assert torch.equal(g[name][key], r[name][key]), (name, key)
    with pytest.raises(ValueError, match="lm_head_bits"):
        tw.quantize_decoder_weights(tp, TDIMS, 8, lm_head_bits=2)


def test_self_cache_quantization_is_bit_exact():
    """``quantize_self_cache`` (per-position scales, the pad to a multiple
    of 128, the packed scales + mask operand) and ``pack_self_scales``
    give the JAX package's arrays exactly, as the backend computes them:
    under ``jax.jit`` (the primed cache is quantized inside its compiled
    decode, where the scale is a product with the f32 reciprocal of 127).
    On this input the jitted scales differ from an eager call's."""
    rng = np.random.default_rng(8)
    L, B, H, C, hd = 2, 3, 4, 20, 32
    sk, sv = (rng.standard_normal((L, B, H, C, hd)).astype(np.float32)
              for _ in range(2))
    sk[0, 0, 0, 3] = 0.0  # an all-zero position: scale 1
    ref = jax.jit(jw.quantize_self_cache, static_argnums=2)(
        jnp.asarray(sk), jnp.asarray(sv), 7)
    eager = jw.quantize_self_cache(jnp.asarray(sk), jnp.asarray(sv), 7)
    assert (np.asarray(eager[2]) != np.asarray(ref[2])).any()
    got = tw.quantize_self_cache(torch.from_numpy(sk), torch.from_numpy(sv),
                                 7)
    assert got[0].shape == (L, B, H, hd, 128) and got[2].shape == (
        L, B, 128, 128)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    from audio_rag_tpu.ops.pallas_kernels import pack_self_scales

    ks, vs = (rng.random((B, H, 128)).astype(np.float32) for _ in range(2))
    valid = np.arange(128)[None, :] < np.array([[0], [5], [128]])
    np.testing.assert_array_equal(
        tw.pack_self_scales(torch.from_numpy(ks), torch.from_numpy(vs),
                            torch.from_numpy(valid)).numpy(),
        np.asarray(pack_self_scales(jnp.asarray(ks), jnp.asarray(vs),
                                    jnp.asarray(valid))))


def test_decoder_step_on_int8_self_cache_matches_jax(models, encoded):
    """Fed the same quantized state (the JAX package's int4 cross K/V and
    int8 self cache, carried across by ``weights``), three decode steps on
    the int8 self cache give the same logits, and the positions they write
    hold the same int8 K/V (a value one step apart where the two packages'
    f32 projections straddle a rounding tie) and the same packed scales."""
    jp, tp = models
    jenc, _ = encoded
    st = jw.SpecialTokens.for_dims(DIMS)
    jkv = jw.precompute_cross_kv(jp, DIMS, jnp.asarray(jenc), jnp.float32,
                                 quantize=True, bits=4)
    jq8 = _jax_q8(jp, DIMS, 4)
    jcache = (jnp.zeros((DIMS.n_text_layer, 2, DIMS.n_text_head, 20, 32),
                        jnp.float32),) * 2
    toks = np.array([[st.sot, 5, 9, 12], [st.sot, 6, 10, 13]], np.int32)
    for t in range(2):  # prime two positions in the bf16/f32 cache
        _, jcache = jw.decoder_step(jp, DIMS, jnp.asarray(toks[:, t:t + 1]),
                                    jkv, t, jcache, jnp.float32, q8=jq8)
    jcache = jax.jit(jw.quantize_self_cache, static_argnums=2)(*jcache, 2)
    tkv = whisper_cross_kv(jax.tree.map(np.asarray, jkv), TDIMS)
    tq8 = whisper_q8_params(jax.tree.map(np.asarray, jq8), TDIMS)
    tcache = whisper_self_cache_q8(jax.tree.map(np.asarray, jcache), TDIMS)
    for t in range(2, 4):
        ref, jcache = jw.decoder_step(
            jp, DIMS, jnp.asarray(toks[:, t:t + 1]), jkv, t, jcache,
            jnp.float32, q8=jq8, self_kv_int8=True)
        got, tcache = tw.decoder_step(
            tp, TDIMS, torch.from_numpy(toks[:, t:t + 1]).long(), tkv, t,
            tcache, torch.float32, q8=tq8, self_kv_int8=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    for g, r in zip(tcache[:2], jcache[:2]):
        diff = np.abs(g.numpy().astype(np.int32) - np.asarray(r, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_allclose(tcache[2].numpy(), np.asarray(jcache[2]),
                               rtol=1e-6)


@pytest.mark.parametrize("profile", ["int8+dec4+skv8", "kv4+int8+lm4",
                                     "kv4+dec4+skv8"])
def test_greedy_decode_matches_jax(models, encoded, profile):
    """Identical greedy tokens on the held-out speech in every profile. The
    quantized profiles' sums differ by design (the port's int8 matmul
    follows the TPU kernel and rounds activations to bf16; the JAX
    package's CPU fallback does not), so log-probabilities are compared at
    fp32 only. Under int4 weights or int4 cross K/V (per-channel scales over
    tiny-synth's 32-dim heads) the JAX package itself loses letters of
    these held-out words ("ybrid seaerch", "leaarns fas"), so the full
    spoken-word check applies where it keeps them."""
    check_greedy_decode(models, encoded, profile)
