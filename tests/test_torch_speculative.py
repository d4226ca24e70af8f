"""Speculative greedy decode of the PyTorch port against the JAX package on
the CPU: the n-gram drafter, the k-token verify pass, and the decode loop
in verify blocks of 8 on the committed trained tiny model in the fp32
profile, whose tokens, avg-logprob and no-speech probability are the JAX
package's. The decode loop against the port's greedy decode on the
``test`` preset, its quantized profiles, and the trained model's int8 and
kv4 + int8 + lm4 profiles are in ``test_torch_speculative_decode.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import whisper as tw
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_speculative_common import (  # noqa: F401
    DIMS,
    TDIMS,
    check_speculative_on_trained_model,
    setup,
    synth,
)
from torch_whisper_common import _jax_q8


@pytest.mark.parametrize("tokens,n_tok,draft_len", [
    ([[5, 6, 7, 8, 5, 6, 0, 0]], [5], 2),       # copies after (5, 6)
    ([[1, 2, 3, 4, 5, 0, 0, 0]], [4], 3),       # no match: repeat last
    ([[9, 9, 1, 9, 9, 2, 9, 9, 0]], [7], 1),    # the most recent match
    ([[4, 4, 4, 4, 4, 4, 4, 4, 4, 4],           # a period-1 loop, a match
      [3, 1, 3, 1, 3, 1, 0, 0, 0, 0]], [6, 5], 4),  # near the buffer's end
])
def test_ngram_draft_matches_jax(tokens, n_tok, draft_len):
    ref = jw.ngram_draft(jnp.asarray(tokens, jnp.int32),
                         jnp.asarray(n_tok, jnp.int32), draft_len)
    got = tw.ngram_draft(torch.tensor(tokens), torch.tensor(n_tok),
                         draft_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_block_verify_matches_jax(setup, quant):
    """Per-row positions, including one block that runs past the cache and
    the positional table: logits and the scattered caches agree in f32."""
    jp, tp, enc, _ = setup
    rng = np.random.default_rng(4)
    L, H = DIMS.n_text_layer, DIMS.n_text_head
    hd, C, k = DIMS.n_text_state // H, 20, 4
    sk, sv = (rng.standard_normal((L, 3, H, C, hd)).astype(np.float32) * 0.5
              for _ in range(2))
    block = rng.integers(0, DIMS.n_vocab - 10, (3, k))
    pos = np.array([4, 9, 18])
    q = quant == "int8"
    jq8 = _jax_q8(jp, DIMS) if q else None
    ref, (rk, rv) = jw.decoder_block_verify(
        jp, DIMS, jnp.asarray(block, jnp.int32),
        jw.precompute_cross_kv(jp, DIMS, jnp.asarray(enc), jnp.float32,
                               quantize=q),
        jnp.asarray(pos, jnp.int32), (jnp.asarray(sk), jnp.asarray(sv)),
        jnp.float32, q8=jq8)
    got, (gk, gv) = tw.decoder_block_verify(
        tp, TDIMS, torch.from_numpy(block),
        tw.precompute_cross_kv(tp, TDIMS, torch.from_numpy(enc),
                               torch.float32, quantize=q),
        torch.from_numpy(pos), (torch.from_numpy(sk), torch.from_numpy(sv)),
        torch.float32, q8=tw.quantize_decoder_weights(tp, TDIMS) if q
        else None)
    # int8 weights: the port rounds x to bf16 as the TPU kernel does, the
    # JAX package's CPU path does not (K/V ~1 apart by up to ~2^-7)
    atol, cache_atol = (5e-2, 2e-2) if q else (1e-4, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=cache_atol)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=cache_atol)


@pytest.mark.parametrize("profile", ["fp32"])
def test_speculative_matches_jax_on_trained_model(synth, profile):
    """Verify blocks of 8 on held-out speech: the JAX package's tokens (and,
    at fp32, its avg-logprob and no-speech probability) in the fp32, the
    production and the benchmark profile."""
    check_speculative_on_trained_model(synth, profile)
