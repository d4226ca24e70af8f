"""Speculative greedy decode of the PyTorch port against the JAX package on
the CPU, part 2 (see ``test_torch_speculative.py``): the decode loop on the
seeded ``test`` preset against the JAX package and the port's own greedy
decode at k 1 to 8 and in the quantized profiles, and in verify blocks of
8 on the committed trained tiny model in the int8 and kv4 + int8 + lm4
profiles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import whisper as tw
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_speculative_common import (  # noqa: F401
    DIMS,
    ST,
    TDIMS,
    check_speculative_on_trained_model,
    setup,
    synth,
)


@pytest.mark.parametrize("spec_k", [1, 2, 4, 8])
def test_speculative_matches_jax_and_greedy(setup, spec_k):
    jp, tp, enc, prompt = setup
    rt, rlp, rns = jw.speculative_greedy_decode(
        jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt), 10, ST.eot,
        spec_k=spec_k, dtype=jnp.float32, no_speech_id=ST.no_speech)
    args = (tp, TDIMS, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
            10, ST.eot)
    gt, glp, gns, steps = tw.speculative_greedy_decode(
        *args, spec_k=spec_k, dtype=torch.float32, no_speech_id=ST.no_speech)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_allclose(glp.numpy(), np.asarray(rlp), atol=1e-4)
    np.testing.assert_allclose(gns.numpy(), np.asarray(rns), atol=1e-6)
    greedy = tw.greedy_decode(*args, dtype=torch.float32,
                              no_speech_id=ST.no_speech)
    assert torch.equal(gt, greedy[0])
    torch.testing.assert_close(glp, greedy[1], atol=1e-5, rtol=0)
    # the verify loop's cache is k slots longer: the priming pass sums its
    # masked scores in another blocking
    torch.testing.assert_close(gns, greedy[2], atol=1e-7, rtol=1e-5)
    assert 1 <= steps <= 9


@pytest.mark.parametrize("profile", ["int8-kv", "int8-weights", "kv4+int8"])
def test_quantized_speculative_matches_greedy(setup, profile):
    """The port's speculative tokens are its greedy tokens in each profile,
    and the JAX package's where the weights stay f32. (With int8 weights
    the port rounds x to bf16 as the TPU kernel does and the JAX package's
    CPU path does not; the random-init model's near-uniform logits then
    part ways: the trained model's test below holds that profile to JAX.)"""
    jp, tp, enc, prompt = setup
    kv = {"int8-kv": 8, "int8-weights": 0, "kv4+int8": 4}[profile]
    dec = profile != "int8-kv"
    kw = dict(dtype=torch.float32, cross_kv_quantize=kv > 0,
              cross_kv_bits=kv or 8,
              decoder_q8=tw.quantize_decoder_weights(tp, TDIMS) if dec
              else None)
    args = (tp, TDIMS, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
            8, ST.eot)
    gt = tw.speculative_greedy_decode(*args, spec_k=4, **kw)[0]
    assert torch.equal(gt, tw.greedy_decode(*args, **kw)[0])
    if not dec:
        rt, _, _ = jw.speculative_greedy_decode(
            jp, DIMS, jnp.asarray(enc), jnp.asarray(prompt), 8, ST.eot,
            spec_k=4, dtype=jnp.float32, cross_kv_quantize=True,
            cross_kv_bits=kv)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))


@pytest.mark.parametrize("profile", ["int8", "kv4+int8+lm4"])
def test_speculative_matches_jax_on_trained_model(synth, profile):
    """Verify blocks of 8 on held-out speech: the JAX package's tokens (and,
    at fp32, its avg-logprob and no-speech probability) in the fp32, the
    production and the benchmark profile."""
    check_speculative_on_trained_model(synth, profile)
