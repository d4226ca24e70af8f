"""The PyTorch port's transformer blocks (``audio_rag_tpu_torch.models.layers``)
against the JAX package's ``models/layers.py`` at f32 on the CPU, on the same
seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import layers as jl
from audio_rag_tpu.ops import pallas_kernels as pk
from audio_rag_tpu_torch.models import layers as tl

ATOL = 1e-5  # f32 sums in another order


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _lin(rng, din, dout, bias=True):
    p = {"w": (rng.standard_normal((din, dout)) * din ** -0.5)
         .astype(np.float32)}
    if bias:
        p["b"] = rng.standard_normal(dout).astype(np.float32) * 0.1
    return p


def _ln(rng, d):
    return {"g": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(d)).astype(np.float32)}


def _tree(fn, p):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _both(p):
    return _tree(jnp.asarray, p), _tree(torch.from_numpy, p)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    rng = np.random.default_rng(0)
    p = _lin(rng, 48, 40, bias)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    jp, tp = _both(p)
    ref = jl.linear(jp, jnp.asarray(x), jnp.float32)
    got = tl.linear(tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL)


def test_layer_norm_and_gelu_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 32)) * 3 + 1).astype(np.float32)
    ln = _ln(rng, 32)
    mlp = {"up": _lin(rng, 32, 128), "down": _lin(rng, 128, 32)}
    (jln, tln), (jmlp, tmlp) = _both(ln), _both(mlp)
    np.testing.assert_allclose(
        _np(tl.layer_norm(tln, torch.from_numpy(x))),
        _np(jl.layer_norm(jln, jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(
        _np(tl.mlp(tmlp, torch.from_numpy(x), torch.float32)),
        _np(jl.mlp(jmlp, jnp.asarray(x), jnp.float32)), atol=ATOL)


def _mha_params(rng, d):
    return {"q": _lin(rng, d, d), "k": _lin(rng, d, d, bias=False),
            "v": _lin(rng, d, d), "o": _lin(rng, d, d)}


@pytest.mark.parametrize("masked", [False, True])
def test_mha_matches_jax(masked):
    """Unmasked self-attention takes the flash route (its plain version on
    the CPU); masked attention takes the einsum."""
    rng = np.random.default_rng(2)
    B, T, d, H = 2, 300, 64, 4
    p = _mha_params(rng, d)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    jp, tp = _both(p)
    jmask = jl.make_causal_mask(T, T) if masked else None
    tmask = tl.make_causal_mask(T, T) if masked else None
    ref, _ = jl.mha(jp, jnp.asarray(x), H, mask=jmask, dtype=jnp.float32)
    got, _ = tl.mha(tp, torch.from_numpy(x), H, mask=tmask,
                    dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL)


def test_mha_with_cache_writes_in_place_and_matches_jax():
    rng = np.random.default_rng(3)
    B, Tq, Tc, d, H = 2, 3, 10, 32, 2
    p = _mha_params(rng, d)
    x = rng.standard_normal((B, Tq, d)).astype(np.float32)
    ck = rng.standard_normal((B, H, Tc, d // H)).astype(np.float32)
    cv = rng.standard_normal((B, H, Tc, d // H)).astype(np.float32)
    off = 4
    jmask = jl.make_causal_mask(Tq, Tc, offset=off)
    jp, tp = _both(p)
    ref, (rk, rv) = jl.mha(jp, jnp.asarray(x), H, mask=jmask,
                           cache=(jnp.asarray(ck), jnp.asarray(cv)),
                           cache_index=off, dtype=jnp.float32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = tl.mha(tp, torch.from_numpy(x), H,
                           mask=tl.make_causal_mask(Tq, Tc, offset=off),
                           cache=(tk, tv), cache_index=off,
                           dtype=torch.float32)
    assert gk is tk and gv is tv  # updated in place
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL)
    np.testing.assert_allclose(_np(gk), _np(rk), atol=ATOL)
    np.testing.assert_allclose(_np(gv), _np(rv), atol=ATOL)


def test_masks_and_positions_match_jax():
    np.testing.assert_array_equal(
        _np(tl.make_causal_mask(5, 9, offset=3)),
        _np(jl.make_causal_mask(5, 9, offset=3)))
    np.testing.assert_array_equal(_np(tl.sinusoid_positions(300, 128)),
                                  jl.sinusoid_positions(300, 128))


@pytest.mark.parametrize("din,dout", [(64, 96), (1280, 1280)])
def test_quantize_linear_is_bit_exact(din, dout):
    """Same rounding (half to even) and clipping as the JAX function run
    under ``jax.jit``, as the backend runs it (the scale a product with the
    f32 reciprocal of 127): identical int8 values and scales, ties included
    (columns whose values sit on .5 steps). At 1280×1280 the jitted scales
    differ from an eager call's, so the case tells the two apart."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((din, dout)) * 0.3).astype(np.float32)
    w[:, 0] = np.arange(din) % 64 - 31.5    # amax 32.5: many exact .5 ratios
    w[:, 1] = 0.0                           # all-zero column: the 1e-9 floor
    ref = jax.jit(jl.quantize_linear)(jnp.asarray(w))
    if din == 1280:
        eager = jl.quantize_linear(jnp.asarray(w))
        assert (np.asarray(eager["s"]) != np.asarray(ref["s"])).any()
    got = tl.quantize_linear(torch.from_numpy(w))
    assert got["w8"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(_np(got["w8"]), np.asarray(ref["w8"]))
    np.testing.assert_array_equal(_np(got["s"]), np.asarray(ref["s"]))


def test_linear_q8_is_the_tpu_kernels_function():
    """``linear_q8`` computes what the TPU kernel computes (x rounded to
    bf16, f32 sums, scale on the output) plus the bias, for any leading
    shape; held against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    p = _lin(rng, 256, 128)
    x = rng.standard_normal((2, 8, 256)).astype(np.float32)
    p8 = tl.quantize_linear(torch.from_numpy(p["w"]))
    got = tl.linear_q8({"b": torch.from_numpy(p["b"])}, p8,
                       torch.from_numpy(x), dtype=torch.float32)
    ref = np.asarray(pk.matmul_q8w(
        jnp.asarray(x.reshape(16, 256)), jnp.asarray(_np(p8["w8"])),
        jnp.asarray(_np(p8["s"])), interpret=True)) + p["b"]
    assert got.shape == (2, 8, 128)
    np.testing.assert_allclose(_np(got).reshape(16, 128), ref, atol=ATOL,
                               rtol=1e-5)


@pytest.mark.parametrize("din,dout", [(128, 96), (1280, 24), (48, 40),
                                      (1280, 1280)])
def test_quantize_linear_q4_is_bit_exact(din, dout):
    """Same groups, rounding (half to even), clipping and row-pair nibble
    packing as the JAX function run under ``jax.jit``, as the backend runs
    it (the scale a product with the f32 reciprocal of 7): identical packed
    bytes and scales, ties included. At 1280×1280 the jitted scales differ
    from an eager call's, so the case tells the two apart."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((din, dout)) * 0.3).astype(np.float32)
    w[:, 0] = (np.arange(din) % 16 - 7.5)   # many exact .5 ratios to 7
    w[:, 1] = 0.0                           # all-zero groups: the 1e-9 floor
    ref = jax.jit(jl.quantize_linear_q4)(jnp.asarray(w))
    if (din, dout) == (1280, 1280):
        eager = jl.quantize_linear_q4(jnp.asarray(w))
        assert (np.asarray(eager["s"]) != np.asarray(ref["s"])).any()
    got = tl.quantize_linear_q4(torch.from_numpy(w))
    assert got["w4"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(_np(got["w4"]), np.asarray(ref["w4"]))
    np.testing.assert_array_equal(_np(got["s"]), np.asarray(ref["s"]))


def test_q4_group_and_tiles_match_jax():
    """The group size fixes the stored format; the port's choice is the
    JAX package's for every even din up to 8192 (and it refuses odd din)."""
    for din in range(2, 8194, 2):
        assert tl.q4_tiles(din) == pk.q4_tiles(din), din
        assert tl.q4_group(din) == pk.q4_group(din), din
    assert (tl.q4_group(128), tl.q4_group(512), tl.q4_group(1280),
            tl.q4_group(5120)) == (128, 64, 80, 128)
    with pytest.raises(ValueError, match="even"):
        tl.q4_group(63)


@pytest.mark.parametrize("din", [48, 256])
def test_linear_q8_routes_int4_by_key(din):
    """``{"w4", "s"}`` goes to the int4 matmul: the JAX package's off-TPU
    ``linear_q8`` result (bf16(x) · dequantized weight, bias in f32)."""
    rng = np.random.default_rng(7)
    p = _lin(rng, din, 40)
    x = rng.standard_normal((2, 3, din)).astype(np.float32)
    jp4 = jl.quantize_linear_q4(jnp.asarray(p["w"]))
    tp4 = tl.quantize_linear_q4(torch.from_numpy(p["w"]))
    ref = jl.linear_q8({"b": jnp.asarray(p["b"])}, jp4, jnp.asarray(x),
                       dtype=jnp.float32)
    got = tl.linear_q8({"b": torch.from_numpy(p["b"])}, tp4,
                       torch.from_numpy(x), dtype=torch.float32)
    assert got.shape == (2, 3, 40)
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL, rtol=1e-5)
