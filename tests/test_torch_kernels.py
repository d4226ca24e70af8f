"""The PyTorch port's kernel wrappers (``audio_rag_tpu_torch.ops.kernels``).

On the CPU each wrapper runs its plain PyTorch version; these tests hold the
plain versions against the JAX package's Pallas kernels run in interpret
mode, at the shapes the JAX package's own kernel tests use. The CUDA
kernels themselves are held against the plain versions on a card by
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.ops import pallas_kernels as pk
from audio_rag_tpu_torch.ops import kernels as K


@pytest.fixture
def no_launches():
    """The CPU route never counts a launch."""
    before = dict(K.LAUNCHES)
    yield
    assert K.LAUNCHES == before


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# -- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("T,D", [(256, 64), (384, 128)])
def test_flash_plain_matches_pallas(T, D, no_launches):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, (1, 2, T, D))
    ref = np.asarray(pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
        block_k=128, interpret=True))
    got = K.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (1, 2, T, D)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_flash_plain_bf16_matches_pallas(no_launches):
    """bf16 in, f32 inside, one rounding to bf16 out: at most one bf16 ulp
    apart where the two f32 results straddle a rounding boundary."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, (2, 2, 256, 64))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(pk.flash_attention(jq, jk, jv, interpret=True)
                     .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = K.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=2.0 ** -8, rtol=2.0 ** -8)


def test_flash_large_logits_stay_finite(no_launches):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 1, 128, 64)).astype(np.float32) * 30
    k = rng.standard_normal((1, 1, 128, 64)).astype(np.float32) * 30
    v = rng.standard_normal((1, 1, 128, 64)).astype(np.float32)
    ref = np.asarray(pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = K.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_flash_kv_len_masks_trailing_keys(no_launches):
    """Keys at index ≥ kv_len take no probability mass: the same result as
    attention over the first kv_len keys only (any T, no padding trick)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, (2, 3, 300, 32)))
    got = K.flash_attention(q, k, v, kv_len=217)
    ref = K.flash_attention(q, k[:, :, :217], v[:, :, :217])
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_flash_rejects_bad_input(no_launches):
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="q/k/v"):
        K.flash_attention(q, q[0], q[0])
    with pytest.raises(ValueError, match="kv_len"):
        K.flash_attention(q, q, q, kv_len=9)
    meta = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        K.flash_attention(meta, meta, meta)


# -- int8-weight matmul ---------------------------------------------------------

def _q8w_inputs(rng, B, din, dout):
    x = rng.standard_normal((B, din)).astype(np.float32)
    w8 = rng.integers(-127, 128, (din, dout), dtype=np.int8)
    s = rng.uniform(0.005, 0.02, (dout,)).astype(np.float32)
    return x, w8, s


def _q8w_sum_bound(x, w8, s):
    """Two f32 summation orders of din exact products differ by at most
    2·din·2⁻²⁴·Σ|x·w| (times the column scale)."""
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    mag = np.abs(xb).astype(np.float64) @ np.abs(w8).astype(np.float64)
    return 2 * x.shape[1] * 2.0 ** -24 * mag * s


@pytest.mark.parametrize("B,din,dout", [
    (16, 256, 128),
    (16, 1280, 1280),   # whisper large-v3 attention projection
    (32, 256, 640),
])
def test_matmul_q8w_plain_matches_pallas(B, din, dout, no_launches):
    rng = np.random.default_rng(0)
    x, w8, s = _q8w_inputs(rng, B, din, dout)
    ref = np.asarray(pk.matmul_q8w(jnp.asarray(x), jnp.asarray(w8),
                                   jnp.asarray(s), interpret=True))
    got = K.matmul_q8w(*map(torch.from_numpy, (x, w8, s)))
    assert got.dtype == torch.float32 and got.shape == (B, dout)
    assert (np.abs(got.numpy() - ref) <= _q8w_sum_bound(x, w8, s)).all()


@pytest.mark.parametrize("B,din,dout", [(1, 64, 96), (3, 200, 72),
                                        (5, 130, 17)])
def test_matmul_q8w_plain_ragged_matches_bf16_dot(B, din, dout, no_launches):
    """Shapes the Pallas kernel refuses (no 16-row or 128-column tiling):
    the function is still bf16(x) · W8 in f32, then × s."""
    rng = np.random.default_rng(4)
    x, w8, s = _q8w_inputs(rng, B, din, dout)
    ref = np.asarray(jnp.dot(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(w8).astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)) * s
    got = K.matmul_q8w(*map(torch.from_numpy, (x, w8, s)))
    assert (np.abs(got.numpy() - ref) <= _q8w_sum_bound(x, w8, s)).all()


def test_matmul_q8w_rejects_bad_input(no_launches):
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="int8"):
        K.matmul_q8w(x, torch.zeros((8, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="shape mismatch"):
        K.matmul_q8w(x, torch.zeros((9, 4), dtype=torch.int8),
                     torch.zeros(4))


# -- int8 decode cross-attention ---------------------------------------------------

def _cross_inputs(rng, B, H, M, hd, Ta):
    q = rng.standard_normal((B, H, M, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, H, hd, Ta)).astype(np.int8)
    v8 = rng.integers(-127, 128, (B, H, hd, Ta)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, H, 1, 1)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, H, 1, 1)).astype(np.float32)
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("B,H,M,hd,Ta", [
    (2, 4, 1, 64, 256),
    (1, 2, 1, 64, 128),
    (2, 4, 2, 64, 128),   # beams ride the query axis
    (2, 4, 5, 64, 128),
    (3, 5, 1, 64, 128),   # B ≠ H
])
def test_cross_q8_plain_matches_pallas(B, H, M, hd, Ta, no_launches):
    rng = np.random.default_rng(0)
    args = _cross_inputs(rng, B, H, M, hd, Ta)
    ref = np.asarray(pk.decode_cross_attention_q8(
        *map(jnp.asarray, args), interpret=True))
    got = K.decode_cross_attention_q8(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, H, M, hd)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_cross_q8_rejects_bad_input(no_launches):
    q = torch.zeros((1, 2, 1, 8))
    k8 = torch.zeros((1, 2, 8, 10), dtype=torch.int8)
    sc = torch.ones((1, 2, 1, 1))
    with pytest.raises(ValueError, match="scales"):
        K.decode_cross_attention_q8(q, k8, k8, sc[..., 0], sc)
    with pytest.raises(ValueError, match="does not match"):
        K.decode_cross_attention_q8(q, k8[:, :, :4], k8[:, :, :4], sc, sc)
    with pytest.raises(ValueError, match="int8"):
        K.decode_cross_attention_q8(q, k8.float(), k8, sc, sc)

