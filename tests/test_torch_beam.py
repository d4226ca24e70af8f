"""Beam search of the PyTorch port (``audio_rag_tpu_torch.models.whisper``
and ``ops.kernels.beam_reorder_kv``) against the JAX package on the CPU:
the reorder's plain version against the Pallas kernel in interpret mode,
the one-hot reorder and top-k ties, the config's decode fields, and
``beam_decode``'s tokens on the committed trained tiny model in the
kv4 + int8 + lm4 profile, in each of the port's three reorder modes.
``decoder_step(beams=K)``, beam decoding on the ``test`` preset and the
int8 cross K/V profile are in ``test_torch_beam_step.py``; the ASR
backend's strategy choice and the fp32 and int8-weight profiles in
``test_torch_beam_asr.py``. (Three files so that none runs for long under
the suite's one-file-a-worker scheduling.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.ops.pallas_kernels import beam_reorder_kv as pallas_reorder
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.ops import kernels as K
from torch_beam_common import (  # noqa: F401
    check_beam_decode_on_trained_model,
    synth,
)
from torch_llm_common import one_torch_thread  # noqa: F401


# -- the reorder kernel's plain version ---------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(2, 6, 2, 4, 16), (3, 10, 4, 7, 32)])
def test_reorder_plain_matches_pallas(shape, dtype):
    """A permutation copies bits: the plain version equals the TPU kernel
    (interpret mode) exactly, repeats and identity rows included."""
    rng = np.random.default_rng(0)
    sk, sv = (jnp.asarray(rng.standard_normal(shape), dtype)
              for _ in range(2))
    idx = rng.integers(0, shape[1], size=(shape[1],))
    ref = pallas_reorder(sk, sv, jnp.asarray(idx, jnp.int32), interpret=True)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = K.beam_reorder_kv(
        *(torch.from_numpy(np.array(t, np.float32)).to(tdt)
          for t in (sk, sv)), torch.from_numpy(idx))
    for g, r in zip(got, ref):
        assert g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(r, np.float32))


def test_reorder_takes_shapes_the_tpu_kernel_refuses():
    """H·C·hd = 105 is no multiple of 128: the TPU kernel raises, the port
    equals a numpy take; bad indices and dtypes raise."""
    rng = np.random.default_rng(1)
    sk, sv = (rng.standard_normal((3, 10, 3, 7, 5)).astype(np.float32)
              for _ in range(2))
    idx = np.array([0, 0, 2, 9, 4, 4, 4, 1, 8, 3])
    with pytest.raises(ValueError):
        pallas_reorder(jnp.asarray(sk), jnp.asarray(sv),
                       jnp.asarray(idx, jnp.int32), interpret=True)
    got = K.beam_reorder_kv(torch.from_numpy(sk), torch.from_numpy(sv),
                            torch.from_numpy(idx))
    np.testing.assert_array_equal(got[0].numpy(), np.take(sk, idx, axis=1))
    np.testing.assert_array_equal(got[1].numpy(), np.take(sv, idx, axis=1))
    t = torch.from_numpy(sk)
    with pytest.raises(ValueError, match="outside"):
        K.beam_reorder_kv(t, t, torch.from_numpy(idx + 1))
    with pytest.raises(ValueError, match="int64"):
        K.beam_reorder_kv(t, t, torch.from_numpy(idx).int())
    with pytest.raises(ValueError, match="f32 or bf16"):
        K.beam_reorder_kv(t.half(), t.half(), torch.from_numpy(idx))


def test_onehot_reorder_equals_index_select():
    """The port's one-hot matmul reorder gives the plain version's bits."""
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        sk, sv = (torch.from_numpy(rng.standard_normal((2, 8, 2, 5, 16))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(2))
        idx = torch.from_numpy(rng.integers(0, 8, size=(8,)))
        got = tw._onehot_reorder((sk, sv), idx)
        for g, r in zip(got, K.beam_reorder_kv_plain(sk, sv, idx)):
            assert torch.equal(g, r)


def test_top_k_orders_ties_as_jax():
    """Equal candidates come out lower index first, as ``jax.lax.top_k``
    gives them."""
    x = np.array([[0.5, -1.0, 0.5, 2.0, 0.5, 2.0, -np.inf, 0.5],
                  [-np.inf, -np.inf, 1.0, -np.inf, 1.0, 1.0, 0.0, 1.0]],
                 np.float32)
    for k in (1, 3, 5, 7):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tw._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# -- beam_decode on the trained model -------------------------------------------

@pytest.mark.parametrize("mode", tw.BEAM_REORDERS)
@pytest.mark.parametrize("profile", ["kv4+int8+lm4"])
def test_beam_decode_matches_jax_on_trained_model(synth, profile, mode):
    """The port's beam-5 hypothesis equals the JAX package's in each decode
    profile and each reorder mode (the JAX package's "kernel" mode is its
    one-hot reorder off the TPU, and its lazy mode gives the one-hot
    tokens). The unquantized profiles hear the spoken words."""
    check_beam_decode_on_trained_model(synth, profile, mode)


# -- the config -----------------------------------------------------------------

def test_asr_config_checks_the_decode_fields():
    from audio_rag_tpu_torch.config import ASRConfig
    from audio_rag_tpu_torch.core.exceptions import ConfigError

    assert (ASRConfig().decode, ASRConfig().beam_size,
            ASRConfig().speculative_k) == ("greedy", 5, 0)
    for bad in ({"decode": "sample"}, {"beam_size": 0}, {"beam_size": 17},
                {"speculative_k": -1}, {"speculative_k": 9}):
        with pytest.raises(ConfigError):
            ASRConfig(**bad)
