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
from torch_llm_common import one_torch_thread  # noqa: F401


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



# -- int4-weight matmul --------------------------------------------------------------

def _q4w_inputs(rng, B, din, dout):
    from audio_rag_tpu.models.layers import quantize_linear_q4

    w = rng.standard_normal((din, dout)).astype(np.float32) * 0.05
    p4 = quantize_linear_q4(jnp.asarray(w))
    x = rng.standard_normal((B, din)).astype(np.float32)
    return x, np.array(p4["w4"]), np.array(p4["s"])


def _q4w_sum_bound(x, w4, s):
    """Exact products (bf16 × int4·bf16 fits f32): two f32 summation orders
    over din terms differ by at most 2·din·2⁻²⁴·Σ|x·w|."""
    w = np.abs(K.dequant_q4w(torch.from_numpy(w4), torch.from_numpy(s))
               .numpy()).astype(np.float64)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return 2 * x.shape[1] * 2.0 ** -24 * (np.abs(xb).astype(np.float64) @ w)


@pytest.mark.parametrize("B,din,dout", [
    (16, 1280, 1280),   # whisper large-v3 attention projection, group 80
    (16, 512, 256),     # group 64
    (32, 256, 640),     # group 32; window batch 32
])
def test_matmul_q4w_plain_matches_pallas(B, din, dout, no_launches):
    """The Pallas kernel in interpret mode multiplies the same int4 values
    by the same bf16-rounded scales; only the f32 summation order differs
    (the JAX kernel test's tolerance)."""
    rng = np.random.default_rng(0)
    x, w4, s = _q4w_inputs(rng, B, din, dout)
    ref = np.asarray(pk.matmul_q4w(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w4), jnp.asarray(s),
                                   interpret=True))
    got = K.matmul_q4w(*map(torch.from_numpy, (x, w4, s)))
    assert got.dtype == torch.float32 and got.shape == (B, dout)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("B,din,dout", [(1, 48, 40), (3, 128, 72),
                                        (5, 200, 17)])
def test_matmul_q4w_plain_ragged_matches_jax_fallback(B, din, dout,
                                                      no_launches):
    """Shapes the Pallas kernel refuses: the JAX package's off-TPU path,
    bf16(x) · _dequant_q4 in f32."""
    from audio_rag_tpu.models.layers import _dequant_q4

    rng = np.random.default_rng(4)
    x, w4, s = _q4w_inputs(rng, B, din, dout)
    ref = np.asarray(jnp.dot(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32),
        _dequant_q4({"w4": jnp.asarray(w4), "s": jnp.asarray(s)}),
        preferred_element_type=jnp.float32))
    got = K.matmul_q4w(*map(torch.from_numpy, (x, w4, s)))
    assert (np.abs(got.numpy() - ref) <= _q4w_sum_bound(x, w4, s)).all()


@pytest.mark.parametrize("din,dout", [(256, 96), (1280, 40), (48, 8)])
def test_dequant_q4w_is_bit_exact(din, dout):
    from audio_rag_tpu.models.layers import _dequant_q4, quantize_linear_q4

    rng = np.random.default_rng(1)
    p4 = quantize_linear_q4(jnp.asarray(
        rng.standard_normal((din, dout)).astype(np.float32)))
    ref = np.asarray(_dequant_q4(p4))
    got = K.dequant_q4w(torch.from_numpy(np.array(p4["w4"])),
                        torch.from_numpy(np.array(p4["s"])))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_matmul_q4w_rejects_bad_input(no_launches):
    x = torch.zeros((2, 8))
    w4 = torch.zeros((4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        K.matmul_q4w(x, w4.float(), torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="shape mismatch"):
        K.matmul_q4w(x, w4, torch.zeros((3, 3)))  # 3 groups do not divide 8
    with pytest.raises(ValueError, match="shape mismatch"):
        K.matmul_q4w(x, w4[:3], torch.zeros((1, 3)))
    with pytest.raises(ValueError, match="din/group"):
        K.matmul_q4w(x, w4, torch.zeros(3))


# -- int4 decode cross-attention ---------------------------------------------------

def _pack_kv4(rng, B, H, hd, Ta):
    """Random K or V quantized as the JAX package's quant4 does, no L axis."""
    x = rng.standard_normal((B, H, Ta, hd)).astype(np.float32)
    s = np.maximum(np.abs(x).max(axis=2, keepdims=True), 1e-9) / 7.0
    qt = np.clip(np.round(x / s), -7, 7).astype(np.int8).transpose(0, 1, 3, 2)
    packed = (qt[:, :, :hd // 2] & np.int8(0x0F)) | (qt[:, :, hd // 2:] << 4)
    return packed.astype(np.int8), s.astype(np.float32)


@pytest.mark.parametrize("B,H,M,hd,Ta", [
    (2, 20, 1, 64, 512),  # large-v3 heads
    (2, 4, 5, 64, 256),   # beams ride the query axis
    (3, 2, 1, 32, 300),
])
def test_cross_q4_plain_matches_pallas(B, H, M, hd, Ta, no_launches):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, M, hd)).astype(np.float32)
    k4, ks = _pack_kv4(rng, B, H, hd, Ta)
    v4, vs = _pack_kv4(rng, B, H, hd, Ta)
    args = (q, k4, v4, ks, vs)
    ref = np.asarray(pk.decode_cross_attention_q4(
        *map(jnp.asarray, args), interpret=True))
    got = K.decode_cross_attention_q4(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, H, M, hd)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_cross_q4_plain_takes_every_byte(no_launches):
    """All 256 byte values, the extreme nibbles -8 and 7 included, unpack
    as the Pallas kernel unpacks them."""
    rng = np.random.default_rng(4)
    B, H, M, hd, Ta = 2, 3, 4, 64, 256
    q = rng.standard_normal((B, H, M, hd)).astype(np.float32)
    k4, v4 = (rng.integers(-128, 128, (B, H, hd // 2, Ta)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.01, 0.1, (B, H, 1, hd)).astype(np.float32)
              for _ in range(2))
    args = (q, k4, v4, ks, vs)
    ref = np.asarray(pk.decode_cross_attention_q4(
        *map(jnp.asarray, args), interpret=True))
    got = K.decode_cross_attention_q4(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_cross_q4_rejects_bad_input(no_launches):
    q = torch.zeros((1, 2, 1, 8))
    k4 = torch.zeros((1, 2, 4, 10), dtype=torch.int8)
    sc = torch.ones((1, 2, 1, 8))
    with pytest.raises(ValueError, match="scales"):
        K.decode_cross_attention_q4(q, k4, k4, sc[..., :1], sc)
    with pytest.raises(ValueError, match="does not match"):
        K.decode_cross_attention_q4(q, k4[:, :, :3], k4[:, :, :3], sc, sc)
    with pytest.raises(ValueError, match="int8"):
        K.decode_cross_attention_q4(q, k4.float(), k4, sc, sc)


# -- int8 decode self-attention ------------------------------------------------------

def _self_case(rng, B=2, H=4, hd=32, Cp=128, n_valid=37):
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (B, H, hd, Cp), dtype=np.int8)
    v8 = rng.integers(-127, 128, (B, H, hd, Cp), dtype=np.int8)
    ks = (0.01 + rng.random((B, H, Cp))).astype(np.float32)
    vs = (0.01 + rng.random((B, H, Cp))).astype(np.float32)
    valid = np.broadcast_to(np.arange(Cp) < n_valid, (B, Cp))
    sc = np.array(pk.pack_self_scales(jnp.asarray(ks), jnp.asarray(vs),
                                      jnp.asarray(valid)))
    return q, k8, v8, sc


@pytest.mark.parametrize("B,H,hd,Cp,n_valid", [
    (2, 4, 32, 128, 37),
    (3, 20, 64, 256, 130),  # large-v3 heads
    (1, 4, 32, 128, 1),     # the first decode position
])
def test_self_q8_plain_matches_pallas(B, H, hd, Cp, n_valid, no_launches):
    """The JAX kernel test's tolerance: scale-after-dot against the
    kernel's order, relative to the output's scale."""
    rng = np.random.default_rng(0)
    args = _self_case(rng, B, H, hd, Cp, n_valid)
    ref = np.asarray(pk.decode_self_attention_q8(
        *map(jnp.asarray, args), interpret=True))
    got = K.decode_self_attention_q8(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, H, 1, hd)
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=1e-5)


def test_self_q8_mask_excludes_invalid_positions(no_launches):
    rng = np.random.default_rng(2)
    q, k8, v8, sc = _self_case(rng, n_valid=9)
    base = K.decode_self_attention_q8(*map(torch.from_numpy,
                                           (q, k8, v8, sc)))
    k8[:, :, :, 9:] = 77
    v8[:, :, :, 9:] = -55
    pert = K.decode_self_attention_q8(*map(torch.from_numpy,
                                           (q, k8, v8, sc)))
    assert torch.equal(base, pert)


def test_self_q8_all_masked_row_stays_finite(no_launches):
    """-1e30, not -inf, past the write head: a row with no valid position
    takes a uniform softmax instead of NaN, in both packages."""
    rng = np.random.default_rng(5)
    args = _self_case(rng, n_valid=0)
    ref = np.asarray(pk.decode_self_attention_q8(
        *map(jnp.asarray, args), interpret=True))
    got = K.decode_self_attention_q8(*map(torch.from_numpy, args)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_self_q8_rejects_bad_input(no_launches):
    q = torch.zeros((1, 2, 1, 8))
    k8 = torch.zeros((1, 2, 8, 128), dtype=torch.int8)
    sc = torch.zeros((1, 128, 128))
    with pytest.raises(ValueError, match="packed scales"):
        K.decode_self_attention_q8(q, k8, k8, sc[:, :, :64])
    with pytest.raises(ValueError, match="does not match"):
        K.decode_self_attention_q8(q, k8[:, :, :4], k8[:, :, :4], sc)
    with pytest.raises(ValueError, match="int8"):
        K.decode_self_attention_q8(q, k8.float(), k8, sc)
    big = torch.zeros((1, 64, 1, 8))
    with pytest.raises(ValueError, match="2H"):
        K.decode_self_attention_q8(big, torch.zeros((1, 64, 8, 128),
                                                    dtype=torch.int8),
                                   torch.zeros((1, 64, 8, 128),
                                               dtype=torch.int8), sc)


# every cache the port sends: Whisper's self caches pad to a multiple of 128
# (n_text_ctx 448 → 512), heads of 32 (tiny-synth), 64 (large-v3) and 128;
# Cp 2048 and an unpadded 448 beyond them
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("Cp", [128, 256, 384, 448, 512, 2048])
@pytest.mark.parametrize("M", [1, 2, 5, 8])
def test_self_plan_covers_the_call(hd, Cp, M):
    """Every port shape: K and V in 16-row slices, each one bulk copy of
    16·Cp bytes that starts at a multiple of 16 from a 16-byte-aligned base,
    every slice in flight from the block's start wherever Whisper's caches
    (Cp ≤ 512) go with one query a row (the port's call) and wherever the
    slices fit; else two slots of a multiple of 16 rows dividing hd; score
    rows that the P.V lanes split evenly; the slots, the scores, the
    columns and q's pieces fit shared memory."""
    p = K.self_plan(hd, Cp, M)
    assert p.bulk and p.ldk == Cp
    lanes = 4 * 256 // hd
    assert p.ldp % lanes == 0 and p.ldk <= p.ldp < p.ldk + lanes
    whole = p.slots == 2 * p.stages
    if Cp <= 512 and (M == 1 or hd <= 64):
        assert whole
    assert p.rows == 16 if whole else (p.slots == 2 and p.rows % 16 == 0)
    assert p.stages * p.rows == hd
    assert all((bh * hd + p.rows * stage) * Cp % 16 == 0
               and p.rows * Cp % 16 == 0
               for bh in (0, 1, 319) for stage in range(p.stages))
    parts = 4 * hd // 16 * M * p.ldp if whole and M > 4 else 0
    assert p.smem == (p.slots * p.rows * p.ldk + K.SELF_SLACK + parts
                      + 8 * M * p.ldp + 12 * p.ldp + 3 * M * hd)
    assert p.smem <= K.SELF_SMEM_MAX


def test_self_plan_refuses_what_the_kernel_cannot_take():
    """A base off 16 bytes or Cp % 16 != 0 leaves the bulk copies for the
    threads' copies into word-multiple rows; M outside 1–8, head dims other
    than 16, 32, 64 and 128, and caches whose slots, scores and columns
    outgrow shared memory raise."""
    assert not K.self_plan(64, 256, 1, aligned=False).bulk
    for Cp in (1, 127, 129, 130):
        p = K.self_plan(64, Cp, 1)
        assert not p.bulk and p.ldk % 4 == 0 and Cp <= p.ldk < Cp + 4
    for M in (0, 9):
        with pytest.raises(ValueError, match="queries per row"):
            K.self_plan(64, 256, M)
    for hd in (8, 40, 80, 256):
        with pytest.raises(ValueError, match="head dim"):
            K.self_plan(hd, 256, 1)
    assert K.self_plan(64, 2128, 8).rows == 16
    assert K.self_plan(64, 4432, 1).rows == 16
    for M, Cp in ((8, 2144), (1, 4448)):
        with pytest.raises(ValueError, match="shared memory"):
            K.self_plan(64, Cp, M)


def _self_integer_design(q, k8, v8, sc):
    """The self kernel's arithmetic on the CPU: q/sqrt(hd) as a 23-bit
    fixed-point integer per query (the largest |value| within [2^21,
    2^22)), exact integer scores per 16-row slice made f32 as the kernel's
    FMA chain of its three pieces does, added in slice order, scaled and
    masked in f32; p * vs / max|vs| as round(2^22 x), an exact integer P.V,
    one scaling in f64 to f32. (dp4a's sums are exact integers, so only the
    f32 steps can differ from the card, by their rounding.)"""
    B, H, M, hd = q.shape
    f32 = torch.float32
    qf = q.float() * hd ** -0.5
    amax = qf.abs().amax(-1, keepdim=True)
    ex = torch.frexp(amax)[1] - 1  # amax in [2^ex, 2^(ex + 1))
    sh = torch.where(amax > 0, torch.clamp(21 - ex, max=126),
                     torch.zeros_like(ex))
    qi = torch.round(torch.ldexp(qf, sh.to(f32))).long()
    pieces = (qi >> 16, (qi >> 8) & 255, qi & 255)
    kk = k8.long()
    s = torch.zeros(B, H, M, kk.shape[-1], dtype=f32)
    for lo in range(0, hd, 16):  # a slice: 16 rows
        p0, p1, p2 = (torch.matmul(pc[..., lo:lo + 16], kk[..., lo:lo + 16, :])
                      .double() for pc in pieces)
        inner = (p1 * 256 + p2).to(f32).double()
        s = s + (p0 * 65536 + inner).to(f32)
    ks = sc[:, :, :H].transpose(1, 2)[:, :, None, :]  # (B, H, 1, Cp)
    vs = sc[:, :, H:2 * H].transpose(1, 2)[:, :, None, :]
    mask = sc[:, None, None, :, 2 * H]
    s = s * torch.ldexp(torch.ones(1), -sh.to(f32)) * ks + mask
    e = torch.exp(s - s.amax(-1, keepdim=True))
    vmax = vs.abs().amax(-1, keepdim=True)
    pi = torch.round(e * vs * (4194304.0 / vmax)).long()
    num = torch.matmul(pi, v8.long().transpose(-1, -2)).double()
    return (num * vmax.double() / (4194304.0 * e.sum(-1, keepdim=True)
                                   .double())).to(f32)


@pytest.mark.parametrize("B,H,M,hd,Cp,n_valid,dtype", [
    (2, 4, 1, 32, 128, 37, torch.float32),
    (1, 3, 1, 64, 256, 40, torch.bfloat16),
    (1, 2, 5, 64, 448, 448, torch.float32),
    (1, 2, 8, 128, 512, 1, torch.bfloat16),
    (1, 2, 1, 64, 2048, 2000, torch.bfloat16),
    (1, 2, 2, 32, 1, 0, torch.float32),
    (1, 2, 8, 16, 129, 129, torch.float32),
])
def test_self_integer_design_meets_the_tolerance(B, H, M, hd, Cp, n_valid,
                                                 dtype):
    """The integer design's arithmetic, replayed on the CPU, agrees with the
    plain version within the card tests' unchanged tolerance (atol 1e-5,
    rtol 1e-5), masked positions, one valid position and none included."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn((B, H, M, hd), generator=g).to(dtype)
    k8, v8 = (torch.randint(-127, 128, (B, H, hd, Cp), generator=g,
                            dtype=torch.int8) for _ in range(2))
    sc = torch.zeros((B, Cp, 128))
    sc[:, :, :2 * H] = torch.rand((B, Cp, 2 * H), generator=g) * 0.02 + 0.001
    sc[:, :, 2 * H] = torch.where(torch.arange(Cp) < n_valid, 0.0, -1e30)
    torch.testing.assert_close(_self_integer_design(q, k8, v8, sc),
                               K.decode_self_attention_q8_plain(q, k8, v8, sc),
                               atol=1e-5, rtol=1e-5)


def test_self_kernel_byte_conversions_are_exact():
    """The kernel's two conversions of an int8 value to f32 without I2F,
    replayed on the bits: a signed byte under the exponent of 2^23 + 2^22
    by an integer add, less 12582912; and a byte XORed with 0x80 placed
    under the exponent of 2^23 (the PRMT with 0x4B000000), less 2^23 + 128.
    Both give every int8 value exactly."""
    b = np.arange(-128, 128, dtype=np.int32)
    added = (b + 0x4B400000).astype(np.int32).view(np.float32)
    np.testing.assert_array_equal(added - np.float32(12582912.0), b)
    biased = ((b.astype(np.uint32) ^ 0x80) & 0xFF) | np.uint32(0x4B000000)
    np.testing.assert_array_equal(
        biased.view(np.float32) - np.float32(8388736.0), b)

# -- the launch plan of the weight-quantized matmuls ------------------------------

_LARGE_V3 = [(1280, 1280, 80), (1280, 5120, 80), (5120, 1280, 128),
             (1280, 51968, 80)]                     # (din, dout, q4 group)
_TINY_SYNTH = [(128, 128, 128), (128, 512, 128), (512, 128, 64)]
# the LLM's decode step under decoder_int8 / int4: fused q/k/v, output,
# fused gate/up, down, head (llama-3.2-3b; the trained eval-small asset)
_LLAMA_3B = [(3072, 5120, 128), (3072, 3072, 128), (3072, 16384, 128),
             (8192, 3072, 128), (3072, 128256, 128)]
_LLM_SMALL = [(256, 512, 32), (256, 256, 32), (256, 2048, 32),
              (1024, 256, 128)]
_CARD_TESTS = [(128, 512, 128), (200, 72, 40), (300, 260, 3),
               (1300, 77, 100), (256, 512, 128), (300, 512, 3)]
_PLAN_CASES = (
    [(B, din, dout, bits, grp) for B in (16, 32, 80)
     for din, dout, grp in _LARGE_V3 for bits in (8, 4)]
    + [(B, din, dout, bits, grp) for B in (1, 5, 16, 40)
       for din, dout, grp in _TINY_SYNTH for bits in (8, 4)]
    + [(B, din, dout, bits, grp) for B in (1, 3, 8, 37, 80, 129)
       for din, dout, grp in _CARD_TESTS for bits in (8, 4)]
    + [(B, din, dout, bits, grp) for B in (1, 16)
       for din, dout, grp in _LLAMA_3B for bits in (8, 4)]
    + [(B, din, dout, bits, grp) for B in (1, 4, 8)
       for din, dout, grp in _LLM_SMALL for bits in (8, 4)])


@pytest.mark.parametrize("B,din,dout,bits,group", _PLAN_CASES)
def test_wq_plan_covers_the_call(B, din, dout, bits, group):
    """Every shape the port and its card tests run: the din slices cover
    din exactly in whole ring stages (so an int4 slice starts on a byte row
    and, with per-group sums, every 16-row chunk lies in one group); every
    output tile has a block; x rows fit one block up to 128 (no row-block
    grid dimension, so the weight is read once per call); the ring, the
    warps' hand-over and the cluster's sums fit shared memory."""
    p = K.wq_plan(B, din, dout, bits=bits, group=group)
    assert p.k_per_split % K.WQ_STAGE_K == 0
    assert p.splits * p.k_per_split >= din > (p.splits - 1) * p.k_per_split
    assert p.nt in K.WQ_NT and 8 * p.nt >= min(B, K.WQ_ROWS)
    assert p.row_blocks == -(-B // K.WQ_ROWS)
    assert B > K.WQ_ROWS or p.row_blocks == 1
    bn = K.WQ_WARP_COLS * p.wn
    assert p.wn in (2, 4, 8) and p.wn * p.wk == K.WQ_WARPS
    assert p.col_tiles * bn >= dout > (p.col_tiles - 1) * bn
    assert 2 <= p.stages <= K.WQ_STAGES_MAX
    assert p.smem >= p.stages * K.wq_slot_bytes(bits, p.wn, p.nt)
    assert p.smem >= K.wq_reduce_bytes(p.wn, p.wk, p.nt)
    assert p.smem <= K.WQ_SMEM_MAX
    # int4 sums each 16-row chunk in the mma and scales it when no chunk
    # spans two groups; any other group takes the hi + lo split
    assert p.group_mode == (bits == 4 and group % 16 == 0)
    # a tile's din slices form one thread-block cluster and read each
    # other's finished sums from shared memory
    assert 1 <= p.splits <= K.WQ_SPLITS_MAX
    assert p.splits == 1 or p.smem >= K.wq_part_bytes(p.wn, p.nt)


@pytest.mark.parametrize("B,din,dout", [(16, 1280, 1280), (80, 1280, 1280),
                                        (16, 5120, 1280), (32, 1280, 5120)])
def test_wq_plan_fills_the_card_at_large_v3(B, din, dout):
    """The decode step's small weights are split in din until at least
    half the SMs have a block; the logits head keeps whole 256-column
    tiles, one block each, and no split."""
    p = K.wq_plan(B, din, dout)
    assert p.blocks >= K.WQ_SMS // 2 and p.splits > 1
    head = K.wq_plan(B, 1280, 51968, bits=4, group=80)
    assert head.wn == 8 and head.splits == 1 and head.blocks >= K.WQ_SMS


# -- the decode cross-attention: its launch plan and its integer arithmetic -------

# (hd, Ta): large-v3 (64, 1500), tiny-synth (32, 300), the test preset
# (32, 60), and Ta around the 32-key chunks and the 4-byte words
_CROSS_SHAPES = [(64, 1500), (32, 300), (32, 60), (64, 1), (64, 17),
                 (64, 301), (64, 1501), (32, 33), (128, 1500)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [1, 2, 5, 8])
@pytest.mark.parametrize("hd,Ta", _CROSS_SHAPES)
def test_cross_plan_covers_the_call(bits, hd, Ta, M):
    """Every port shape: the byte rows cut into whole 16-row stages (the
    m16 tiles), each one bulk copy of 16·Ta bytes, a multiple of 16, that
    starts at a multiple of 16 from a 16-byte-aligned base; the chunks cover
    Ta; a query's row of scores holds every key in 4-key groups a whole
    number of warps apart; two ring slots, the warps' int64 sums and M rows
    of scores fit shared memory."""
    p = K.cross_plan(bits, hd, Ta, M)
    rows = hd if bits == 8 else hd // 2
    assert rows % 16 == 0 and rows // 16 in (1, 2, 4, 8)
    assert p.chunks * K.CROSS_KEYS >= Ta > (p.chunks - 1) * K.CROSS_KEYS
    assert p.groups % 32 == 0 and 4 * p.groups >= K.CROSS_KEYS * p.chunks
    assert p.bulk == (Ta % 4 == 0)
    if p.bulk:
        assert p.ldk == Ta and 16 * Ta % 16 == 0
        assert all((bh * rows + 16 * stage) * Ta % 16 == 0
                   for bh in (0, 1, 319) for stage in range(rows // 16))
    else:
        assert p.ldk % 4 == 0 and Ta <= p.ldk < Ta + 4
    slot = -(-(16 * p.ldk + 32) // 16) * 16
    sums = K.CROSS_WARPS * rows // 16 * (8 // bits) * 4 * 32 * 8
    assert p.smem == max(K.CROSS_STAGES * slot, sums) + 16 * M * p.groups
    assert p.smem <= K.CROSS_SMEM_MAX


def test_cross_plan_refuses_what_the_kernel_cannot_take():
    """A base off 16 bytes leaves the bulk copies for the threads' copies;
    head dims the m16 tiles do not cut and scores past shared memory
    raise."""
    assert not K.cross_plan(8, 64, 1500, 1, aligned=False).bulk
    for bits, hd in ((8, 40), (4, 48), (8, 256), (4, 2)):
        with pytest.raises(ValueError, match="head dim"):
            K.cross_plan(bits, hd, 1500, 1)
    with pytest.raises(ValueError, match="shared memory"):
        K.cross_plan(8, 64, 8000, 8)


def _cross_integer_design(q, k, v, ks, vs, bits):
    """The kernel's arithmetic on the CPU: q·scale·ks as 24-bit fixed point
    per query (the max within [2^22, 2^23)), exact integer products summed
    per 16-row stage and each stage's sum added in f32, p = exp2 of the
    scaled difference as round(p·2^23), exact integer P·V and sums, one
    division. (The tensor cores' sums are exact integers, so only the f32
    steps can differ from the card, by their rounding.)"""
    B, H, M, hd = q.shape
    lo_hi = (lambda x: torch.cat(K.int4_nibbles(x), dim=-2))
    kk = (k if bits == 8 else lo_hi(k)).long()
    vv = (v if bits == 8 else lo_hi(v)).long()
    qp = q.float() * ((ks * hd ** -0.5) if bits == 8 else (hd ** -0.5 * ks))
    amax = qp.abs().amax(-1, keepdim=True)
    sh = torch.where(amax > 0, 22 - (torch.frexp(amax)[1] - 1),
                     torch.zeros_like(amax, dtype=torch.int32))
    qi = torch.round(torch.ldexp(qp.double(), sh.double())).long() \
        .clamp(-2 ** 23, 2 ** 23 - 1)
    rows = kk.shape[-2] if bits == 8 else kk.shape[-2] // 2
    s = torch.zeros(B, H, M, kk.shape[-1])
    for r in range(rows // 16):  # stage r: byte rows 16r .. 16r + 15
        d = torch.arange(16 * r, 16 * r + 16)
        if bits == 4:
            d = torch.cat([d, d + hd // 2])
        s += torch.matmul(qi[..., d], kk[..., d, :]).float()
    iv = torch.ldexp(torch.full_like(amax, 1.4426950408889634),
                     -sh.float())
    p = torch.exp2((s - s.amax(-1, keepdim=True)) * iv)
    pf = torch.round(p.double() * 2 ** 23).long()
    num = torch.matmul(pf, vv.transpose(-1, -2))
    return num.float() / pf.sum(-1, keepdim=True).float() * vs


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("B,H,M,hd,Ta,dtype", [
    (2, 3, 1, 64, 1500, torch.bfloat16),
    (2, 2, 5, 64, 1500, torch.float32),
    (1, 2, 8, 64, 1500, torch.bfloat16),
    (3, 2, 2, 32, 301, torch.float32),
    (1, 1, 8, 64, 1, torch.float32),
])
def test_cross_integer_design_meets_the_tolerance(bits, B, H, M, hd, Ta,
                                                  dtype):
    """The integer tensor-core design's arithmetic, replayed on the CPU,
    agrees with the plain version within the card tests' unchanged
    tolerance (atol 2e-5, rtol 1e-5)."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn((B, H, M, hd), generator=g).to(dtype)
    rows, lo = (hd, -127) if bits == 8 else (hd // 2, -128)
    k, v = (torch.randint(lo, 128, (B, H, rows, Ta), generator=g,
                          dtype=torch.int8) for _ in range(2))
    sc = (B, H, 1, 1) if bits == 8 else (B, H, 1, hd)
    ks, vs = (torch.rand(sc, generator=g) * (0.015 if bits == 8 else 0.09)
              + (0.005 if bits == 8 else 0.01) for _ in range(2))
    plain = getattr(K, f"decode_cross_attention_q{bits}_plain")
    torch.testing.assert_close(_cross_integer_design(q, k, v, ks, vs, bits),
                               plain(q, k, v, ks, vs), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["matmul_q8w", "matmul_q4w"])
@pytest.mark.parametrize("edited", ["wq_matmul.cuh", "common.cuh", "own"])
def test_kernel_library_name_covers_headers(tmp_path, monkeypatch, name,
                                            edited):
    """Editing any header under csrc/ or the kernel's own source renames
    its shared library, so a stale build is never loaded."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(K._CSRC, csrc)
    monkeypatch.setattr(K, "_CSRC", csrc)
    before = K._lib_path(name)
    path = csrc / (K.KERNELS[name].source if edited == "own" else edited)
    path.write_text(path.read_text() + "\n// edited\n")
    assert K._lib_path(name) != before


@pytest.mark.parametrize("defines", [("FLASH_WG_STAGES=3",),
                                     ("FLASH_WG_CONSUMERS=2",
                                      "FLASH_WG_TURNS=0")])
def test_kernel_library_name_covers_defines(defines):
    """A build with compile-time defines gets a library of its own, so the
    defaults are never replaced by a variant on disk."""
    name = "flash_attention"
    assert K._lib_path(name, defines) != K._lib_path(name)
    assert K._lib_path(name, defines) == K._lib_path(name, tuple(defines))


# -- builds, loads and counters under threads -----------------------------------

class _FakeCompiler:
    """Stands in for nvcc: writes the ``-o`` file after a pause that lets
    every thread reach the build, and counts the compiles per source."""

    def __init__(self):
        self.compiles: dict[str, int] = {}

    def __call__(self, cmd, **kw):
        import time

        src = cmd[-1].rsplit("/", 1)[-1]
        out = cmd[cmd.index("-o") + 1]
        self.compiles[src] = self.compiles.get(src, 0) + 1

        class Proc:
            returncode = 0

            def communicate(self):
                time.sleep(0.05)
                with open(out, "wb") as f:
                    f.write(b"\0")
                return "", None

        return Proc()


class _FakeLibrary:
    def __getattr__(self, fn_name):
        fn = lambda *a: 0  # noqa: E731
        setattr(self, fn_name, fn)
        return fn


@pytest.mark.parametrize("call", ["load", "_entry"])
def test_kernels_build_and_load_once_under_threads(tmp_path, monkeypatch,
                                                   call):
    """8 threads reach every kernel's first use at once: each library is
    compiled once and opened once."""
    import threading

    compiler, opened = _FakeCompiler(), []
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(K, "_libs", {})
    monkeypatch.setattr(K, "_lib_files", {}, raising=False)
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(K.subprocess, "Popen", compiler)
    monkeypatch.setattr(K.ctypes, "CDLL",
                        lambda path: opened.append(path) or _FakeLibrary())
    start, errors = threading.Barrier(8), []

    def worker():
        try:
            start.wait(timeout=10)
            for name in K.KERNELS:
                getattr(K, call)(name)
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert compiler.compiles == {k.source: 1 for k in K.KERNELS.values()}
    assert sorted(opened) == sorted(str(K._lib_path(n)) for n in K.KERNELS)
    assert not list(tmp_path.glob("*.tmp"))


def test_launch_counter_loses_no_update_under_threads(monkeypatch):
    """8 threads count 200 launches each of one kernel: the total is
    exact even when a thread switch falls inside the increment."""
    import sys
    import threading
    import time

    class SlowDict(dict):
        def __getitem__(self, key):
            value = dict.__getitem__(self, key)
            time.sleep(0)  # give the other threads the interpreter here
            return value

    monkeypatch.setattr(K, "LAUNCHES", SlowDict({n: 0 for n in K.KERNELS}))
    start = threading.Barrier(8)

    def worker():
        start.wait(timeout=10)
        for _ in range(200):
            K._launched("matmul_q8w", 0)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert K.LAUNCHES["matmul_q8w"] == 1600
