"""The PyTorch port's Whisper (``audio_rag_tpu_torch.models.whisper``) against
the JAX package's ``models/whisper.py`` on the CPU: the committed trained
tiny model (``asr_tiny_synth.npz``) on held-out charvoice speech, greedy
tokens in the fp32 and the int8 decode profiles, and the int8 trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import synth_text
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu.ops.mel import log_mel_batch
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import whisper_params, whisper_q8_params

DIMS = jw.WHISPER_PRESETS["tiny-synth"]
TDIMS = tw.WHISPER_PRESETS["tiny-synth"]
HELD_OUT = ["the quick model learns fast", "hybrid search finds words"]

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
    reason="trained ASR asset not built")


@pytest.fixture(scope="module")
def models():
    tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tp = whisper_params(tree, TDIMS, "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def mel():
    """Log-mel of two held-out utterances, one 6 s window each."""
    rng = np.random.default_rng(11)
    win = np.zeros((2, 2 * DIMS.n_audio_ctx * 160), np.float32)
    for j, text in enumerate(HELD_OUT):
        wav = synth_text(text, rng, noise_level=0.005)
        win[j, : wav.size] = wav[: win.shape[1]]
    return np.array(log_mel_batch(jnp.asarray(win), n_mels=DIMS.n_mels))


@pytest.fixture(scope="module")
def encoded(models, mel):
    jp, tp = models
    jenc = np.array(jw.encode(jp, DIMS, jnp.asarray(mel), jnp.float32))
    tenc = tw.encode(tp, TDIMS, torch.from_numpy(mel), torch.float32)
    return jenc, tenc


def _prompt(n):
    st = jw.SpecialTokens.for_dims(DIMS)
    return np.array([[st.sot, st.lang_base, st.transcribe,
                      st.no_timestamps]] * n, np.int32)


def test_dims_tokens_and_codec_match_jax():
    for name, dims in jw.WHISPER_PRESETS.items():
        if name in tw.WHISPER_PRESETS:
            assert tw.WHISPER_PRESETS[name].__dict__ == dims.__dict__
        assert (tw.SpecialTokens.for_dims(tw.WHISPER_PRESETS.get(name, dims))
                .__dict__ == jw.SpecialTokens.for_dims(dims).__dict__)
    text = "Hello, world: 42 tokens!"
    assert tw.char_encode(text) == jw.char_encode(text)
    assert tw.char_decode(tw.char_encode(text)) == jw.char_decode(
        jw.char_encode(text))
    assert tw.language_offset("de") == jw.language_offset("de")


def test_encoder_matches_jax(encoded):
    jenc, tenc = encoded
    assert tenc.shape == (2, DIMS.n_audio_ctx, DIMS.n_audio_state)
    np.testing.assert_allclose(tenc.numpy(), jenc, atol=1e-5)


def test_teacher_forced_decoder_matches_jax(models, encoded):
    jp, tp = models
    jenc, tenc = encoded
    toks = np.concatenate([_prompt(2), np.array(
        [tw.char_encode("the quick"), tw.char_encode("hybrid se")],
        np.int32)], axis=1)
    jkv = jw.precompute_cross_kv(jp, DIMS, jnp.asarray(jenc), jnp.float32)
    ref, _, _ = jw.decoder_forward(jp, DIMS, jnp.asarray(toks), jkv,
                                   dtype=jnp.float32)
    tkv = tw.precompute_cross_kv(tp, TDIMS, tenc, torch.float32)
    got, _ = tw.decoder_forward(tp, TDIMS, torch.from_numpy(toks).long(),
                                tkv, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_int8_cross_kv_is_bit_exact():
    """On inputs whose products and sums are exact in f32 (so both
    packages feed the quantizer the same numbers), the int8 K/V in the
    transposed (L, B, H, D, Ta) layout and the per-(L, B, H) scales are
    identical, rounding ties included."""
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


def test_int8_decoder_tree_is_bit_exact(models):
    jp, tp = models
    ref = whisper_q8_params(jax.tree.map(np.asarray,
                                         jw.quantize_decoder_weights(jp, DIMS)),
                            TDIMS, "cpu")
    got = tw.quantize_decoder_weights(tp, TDIMS)
    assert len(got["blocks"]) == DIMS.n_text_layer
    for g, r in zip(got["blocks"] + [got["logits"]],
                    ref["blocks"] + [ref["logits"]]):
        flat_g = g if "w8" in g else {f"{k}/{kk}": vv for k, v in g.items()
                                      for kk, vv in v.items()}
        flat_r = r if "w8" in r else {f"{k}/{kk}": vv for k, v in r.items()
                                      for kk, vv in v.items()}
        assert flat_g.keys() == flat_r.keys()
        for key in flat_g:
            assert flat_g[key].dtype == flat_r[key].dtype
            assert torch.equal(flat_g[key], flat_r[key]), key


@pytest.mark.parametrize("profile", ["fp32", "int8"])
def test_greedy_decode_matches_jax(models, encoded, profile):
    """Identical greedy tokens on the held-out speech in both profiles. The
    int8 profile's sums differ by design (the port's matmul follows the TPU
    kernel and rounds activations to bf16; the JAX package's CPU fallback
    does not), so its log-probabilities are only compared at fp32."""
    jp, tp = models
    jenc, tenc = encoded
    st = jw.SpecialTokens.for_dims(DIMS)
    q = profile == "int8"
    prompt = _prompt(2)
    jt, jlp, jns = jw.greedy_decode(
        jp, DIMS, jnp.asarray(jenc), jnp.asarray(prompt), 112, st.eot,
        dtype=jnp.float32, no_speech_id=st.no_speech, cross_kv_quantize=q,
        decoder_q8=jw.quantize_decoder_weights(jp, DIMS) if q else None)
    tt, tlp, tns = tw.greedy_decode(
        tp, TDIMS, tenc, torch.from_numpy(prompt).long(), 112, st.eot,
        dtype=torch.float32, no_speech_id=st.no_speech, cross_kv_quantize=q,
        decoder_q8=tw.quantize_decoder_weights(tp, TDIMS) if q else None)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    text = [tw.char_decode([i for i in row[4:] if i < st.eot])
            for row in tt.numpy()]
    for spoken, heard in zip(HELD_OUT, text):  # the model hears the speech
        assert len(set(spoken.split()) & set(heard.split())) >= 3, heard
    if not q:
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
        np.testing.assert_allclose(tns.numpy(), np.asarray(jns), atol=1e-5)
