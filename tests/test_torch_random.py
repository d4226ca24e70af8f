"""The port's JAX PRNG (``audio_rag_tpu_torch/ops/random.py``) against
``jax.random`` on the CPU (threefry2x32, partitionable bits, as this JAX
runs): keys, splits and raw bits bit for bit, uniforms bit for bit, the
Gumbel noise within one ulp of max(|g|, 1), and ``categorical`` draws
identical at several batch sizes and temperatures."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu_torch.ops import random as R
from torch_llm_common import one_torch_thread  # noqa: F401

TINY = np.finfo(np.float32).tiny


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _pair(jkey):
    k = np.asarray(jax.random.key_data(jkey))
    return int(k[0]), int(k[1])


def test_jax_draws_partitionable_bits():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 20, 28, 40, 2**31 - 1, -1, -7])
def test_keys_and_splits_match_jax(seed):
    assert R.PRNGKey(seed) == _pair(_jkey(seed))
    jkey, key = _jkey(seed), R.PRNGKey(seed)
    for num in (2, 3, 5):
        jks = jax.random.split(jkey, num)
        assert R.split(key, num) == [_pair(k) for k in jks]
    for _ in range(6):  # a chain of splits, as the decode loop walks it
        jkey, jsub = jax.random.split(jkey)
        key, sub = R.split(key)
        assert (key, sub) == (_pair(jkey), _pair(jsub))


@pytest.mark.parametrize("shape", [(1,), (3,), (7, 3, 5), (16, 1024),
                                   (3, 51865)])
def test_bits_and_uniforms_match_jax_bit_for_bit(shape):
    jkey, key = _jkey(20), R.PRNGKey(20)
    jb = np.asarray(jax.random.bits(jkey, shape)).astype(np.int64)
    np.testing.assert_array_equal(R.random_bits(key, shape).numpy(), jb)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0)):  # the ranges the port draws
        ju = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                           maxval=hi))
        np.testing.assert_array_equal(R.uniform(key, shape, lo, hi).numpy(),
                                      ju)


def test_a_64_bit_seed_is_its_two_words():
    # JAX's threefry_seed with x64 on; this process runs int32 seeds
    assert R.PRNGKey(2**40 + 3) == (256, 3)


def test_threefry_on_ints_and_tensors_agree():
    x1 = torch.tensor([0, 1, 0xFFFFFFFF, 12345], dtype=torch.int64)
    x2 = torch.tensor([0, 2, 0xFFFFFFFF, 67890], dtype=torch.int64)
    t1, t2 = R.threefry2x32(0x13198A2E, 0x03707344, x1, x2)
    for j in range(4):
        i1, i2 = R.threefry2x32(0x13198A2E, 0x03707344, int(x1[j]),
                                int(x2[j]))
        assert (int(t1[j]), int(t2[j])) == (i1, i2)
    # the Threefry-2x32 (20 rounds) known-answer vector of the Random123
    # suite, as JAX's own tests pin it
    assert R.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                          0x85A308D3) == (0xC4923A9C, 0x483DF7A0)


def _ulps(a, b):
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), 1.0)
                                      .astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 1024), (4, 51866)])
def test_gumbel_within_one_ulp_of_jax(shape):
    jkey, key = _jkey(40), R.PRNGKey(40)
    ref = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, shape))(jkey))
    got = R.gumbel(key, shape).numpy()
    assert np.isfinite(got).all()
    assert _ulps(got, ref).max() <= 1.0


@pytest.mark.parametrize("V", [1024, 51865])
@pytest.mark.parametrize("B", [1, 5, 16])
@pytest.mark.parametrize("temperature", [0.2, 0.4, 1.0])
def test_categorical_draws_match_jax(V, B, temperature):
    """The decode loop's draw: ``categorical(key, logp / T)`` under jit
    (XLA multiplies by the f32 reciprocal of the constant), against the
    port's product with that reciprocal, over a chain of keys."""
    rng = np.random.default_rng(B * 7 + V)
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3.0
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    draw = jax.jit(lambda k, x: jax.random.categorical(k, x / temperature))
    inv_t = torch.tensor(1.0) / torch.tensor(temperature)
    jkey, key = _jkey(int(temperature * 100)), R.PRNGKey(
        int(temperature * 100))
    for _ in range(4):
        jkey, jsub = jax.random.split(jkey)
        key, sub = R.split(key)
        ref = np.asarray(draw(jsub, jnp.asarray(logp)))
        got = R.categorical(sub, torch.tensor(logp) * inv_t).numpy()
        np.testing.assert_array_equal(got, ref)


def test_categorical_takes_f32_only():
    with pytest.raises(ValueError, match="f32"):
        R.categorical(R.PRNGKey(0), torch.zeros((2, 3), dtype=torch.float64))
