"""Beam search of the PyTorch port against the JAX package on the CPU,
part 2 of 3 (see ``test_torch_beam.py``): ``decoder_step(beams=K)`` in
both cache layouts, the int8 self cache refused under beams, beam 1 =
greedy, the reorder mode read from the environment, ``beam_decode`` on the
``test`` preset, and ``beam_decode``'s tokens on the committed trained
tiny model in the int8 cross K/V profile, in each reorder mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import whisper_params
from torch_beam_common import (  # noqa: F401
    _prompt,
    check_beam_decode_on_trained_model,
    synth,
)
from torch_llm_common import one_torch_thread  # noqa: F401

TEST = jw.WHISPER_PRESETS["test"]


@pytest.fixture(scope="module")
def test_model():
    """The "test" preset from the JAX package's seeded init, carried over;
    encoder states of three random mels."""
    jp = jw.init_whisper(jax.random.PRNGKey(0), TEST)
    tp = whisper_params(jax.tree.map(np.asarray, jp),
                        tw.WHISPER_PRESETS["test"], "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (3, TEST.n_mels, 2 * TEST.n_audio_ctx)).astype(np.float32)
    enc = np.array(jw.encode(jp, TEST, jnp.asarray(mel), jnp.float32))
    return jp, tp, enc


def _step_inputs(jp, enc, beams, lazy, seed):
    """Random primed caches for G = 2 groups of ``beams`` beams at position
    5 of a 9-slot cache, the tokens fed, and (lazy) an ancestry mask with
    every beam's own row valid at the position."""
    rng = np.random.default_rng(seed)
    G, L, H = 2, TEST.n_text_layer, TEST.n_text_head
    hd, C, pos = TEST.n_text_state // H, 9, 5
    shape = (L, G, H, beams, C, hd) if lazy else (L, G * beams, H, C, hd)
    sk, sv = (rng.standard_normal(shape).astype(np.float32) * 0.5
              for _ in range(2))
    tok = rng.integers(0, TEST.n_vocab - 10, (G * beams, 1))
    mask = None
    if lazy:
        mask = rng.random((G, beams, beams, C)) < 0.4
        mask[:, :, 0, :pos] = True  # a birth row for every position
        mask[:, np.arange(beams), np.arange(beams), pos] = True
        mask[..., pos + 1:] = False
    return enc[:G], sk, sv, tok, pos, mask


@pytest.mark.parametrize("layout", ["physical", "lazy"])
@pytest.mark.parametrize("quant", ["fp32", "int8-kv"])
def test_decoder_step_with_beams_matches_jax(test_model, layout, quant):
    """Logits and the written caches agree in f32 (atol 1e-4: two
    summation orders of the same f32 sums)."""
    jp, tp, enc = test_model
    lazy = layout == "lazy"
    e, sk, sv, tok, pos, mask = _step_inputs(jp, enc, 3, lazy, seed=3)
    q = quant == "int8-kv"
    jkv = jw.precompute_cross_kv(jp, TEST, jnp.asarray(e), jnp.float32,
                                 quantize=q)
    ref, (rk, rv) = jw.decoder_step(
        jp, TEST, jnp.asarray(tok, jnp.int32), jkv, pos,
        (jnp.asarray(sk), jnp.asarray(sv)), jnp.float32, beams=3,
        beam_mask=None if mask is None else jnp.asarray(mask))
    tkv = tw.precompute_cross_kv(tp, tw.WHISPER_PRESETS["test"],
                                 torch.from_numpy(e), torch.float32,
                                 quantize=q)
    got, (gk, gv) = tw.decoder_step(
        tp, tw.WHISPER_PRESETS["test"], torch.from_numpy(tok), tkv, pos,
        (torch.from_numpy(sk), torch.from_numpy(sv)), torch.float32,
        beams=3, beam_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)


def test_int8_self_cache_is_greedy_only(test_model):
    _, tp, enc = test_model
    dims = tw.WHISPER_PRESETS["test"]
    tkv = tw.precompute_cross_kv(tp, dims, torch.from_numpy(enc[:1]),
                                 torch.float32, quantize=True)
    z = torch.zeros(1)
    with pytest.raises(ValueError, match="greedy-only"):
        tw.decoder_step(tp, dims, torch.zeros((2, 1), dtype=torch.long), tkv,
                        0, (z, z, z), torch.float32, self_kv_int8=True,
                        beams=2)


def test_beam1_equals_greedy_and_unknown_modes_raise(test_model):
    jp, tp, enc = test_model
    dims = tw.WHISPER_PRESETS["test"]
    st = jw.SpecialTokens.for_dims(TEST)
    prompt = torch.from_numpy(_prompt(TEST, 3)).long()
    greedy, _, _ = tw.greedy_decode(tp, dims, torch.from_numpy(enc), prompt,
                                    8, st.eot, dtype=torch.float32)
    for mode in tw.BEAM_REORDERS:
        beam, steps = tw.beam_decode(tp, dims, torch.from_numpy(enc), prompt,
                                     8, st.eot, beam_size=1,
                                     dtype=torch.float32, reorder=mode)
        assert torch.equal(beam, greedy), mode
        assert 1 <= steps <= 7
    with pytest.raises(ValueError, match="reorder"):
        tw.beam_decode(tp, dims, torch.from_numpy(enc), prompt, 4, st.eot,
                       beam_size=2, dtype=torch.float32, reorder="nope")


def test_beam_decode_reads_the_environment(test_model, monkeypatch):
    jp, tp, enc = test_model
    st = jw.SpecialTokens.for_dims(TEST)
    monkeypatch.setenv("BEAM_REORDER", "sideways")
    with pytest.raises(ValueError, match="sideways"):
        tw.beam_decode(tp, tw.WHISPER_PRESETS["test"],
                       torch.from_numpy(enc), torch.from_numpy(
                           _prompt(TEST, 3)).long(), 4, st.eot)


@pytest.fixture(scope="module")
def jax_beam_on_test_preset(test_model):
    """The JAX package's beam-5 tokens over 16 new tokens on the "test"
    preset, computed once for the three reorder modes."""
    jp, _, enc = test_model
    st = jw.SpecialTokens.for_dims(TEST)
    return np.asarray(jw.beam_decode(
        jp, TEST, jnp.asarray(enc), jnp.asarray(_prompt(TEST, 3)), 16,
        st.eot, beam_size=5, dtype=jnp.float32, reorder="onehot"))


@pytest.mark.parametrize("mode", tw.BEAM_REORDERS)
def test_beam_decode_matches_jax_on_test_preset(test_model,
                                                jax_beam_on_test_preset, mode):
    """Beam 5 over 16 new tokens (many reorders) on random-init weights:
    the JAX package's tokens in every mode of the port."""
    _, tp, enc = test_model
    st = jw.SpecialTokens.for_dims(TEST)
    got, _ = tw.beam_decode(tp, tw.WHISPER_PRESETS["test"],
                            torch.from_numpy(enc),
                            torch.from_numpy(_prompt(TEST, 3)).long(), 16,
                            st.eot, beam_size=5, dtype=torch.float32,
                            reorder=mode)
    np.testing.assert_array_equal(got.numpy(), jax_beam_on_test_preset)


@pytest.mark.parametrize("mode", tw.BEAM_REORDERS)
@pytest.mark.parametrize("profile", ["int8-kv"])
def test_beam_decode_matches_jax_on_trained_model(synth, profile, mode):
    """The port's beam-5 hypothesis equals the JAX package's in each decode
    profile and each reorder mode (the JAX package's "kernel" mode is its
    one-hot reorder off the TPU, and its lazy mode gives the one-hot
    tokens). The unquantized profiles hear the spoken words."""
    check_beam_decode_on_trained_model(synth, profile, mode)
