"""The PyTorch port's Whisper (``audio_rag_tpu_torch.models.whisper``) against
the JAX package's ``models/whisper.py`` on the CPU: the committed trained
tiny model (``asr_tiny_synth.npz``) on held-out charvoice speech: the
encoder, the teacher-forced decoder, the int8 decoder tree, greedy tokens
in the fp32, int8 and int8 + int4-head decode profiles, and the prompt's
language token. The int8 and int4 cross K/V, the int4 and mixed trees,
the int8 self cache and the greedy profiles with int4 weights, int4 cross
K/V or the int8 self cache are in ``test_torch_whisper_quant.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import synth_text
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import whisper_q8_params
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_whisper_common import (  # noqa: F401
    DIMS,
    HELD_OUT,
    NEEDS_ASSET,
    TDIMS,
    _jax_q8,
    _prompt,
    check_greedy_decode,
    encoded,
    mel,
    models,
)

pytestmark = NEEDS_ASSET


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


def test_int8_decoder_tree_is_bit_exact(models):
    jp, tp = models
    ref = whisper_q8_params(jax.tree.map(np.asarray, _jax_q8(jp, DIMS)),
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


@pytest.mark.parametrize("profile", ["fp32", "int8", "int8+lm4"])
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


# -- the language token of the prompt -------------------------------------------

@pytest.fixture(scope="module")
def backends():
    """Both packages' ASR backends on tiny-synth (f32, greedy, no VAD, no
    temperature fallback), loaded once, and one held-out utterance."""
    from audio_rag_tpu.asr.whisper_jax import WhisperJaxASR
    from audio_rag_tpu.config.schema import ASRConfig as JaxASRConfig
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.config import ASRConfig

    jasr = WhisperJaxASR(JaxASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        temperature_fallback=False))
    jasr.load()
    tasr = WhisperASR(ASRConfig(model_size="tiny-synth",
                                compute_type="float32", vad_filter=False,
                                temperature_fallback=False),
                      "cpu")
    tasr.load()
    wav = synth_text(HELD_OUT[0], np.random.default_rng(11),
                     noise_level=0.005)
    return jasr, tasr, wav


def _until_eot(row, prompt_len, eot):
    out = []
    for i in row[prompt_len:].tolist():
        if i == eot:
            break
        out.append(i)
    return out


@pytest.mark.parametrize("language", ["de", "en"])
def test_explicit_language_prompt_matches_jax(backends, language,
                                              monkeypatch):
    """An explicit language puts ``lang_base + language_offset`` into the
    prompt on any vocabulary, tiny-synth's included, as the JAX backend
    does; both packages then decode the same tokens and text."""
    jasr, tasr, wav = backends
    seen = {"jax": [], "port": []}
    program = jasr._program

    def spy_program(*args, **kw):
        run = program(*args, **kw)

        def spied(params, mel, prompt):
            out = run(params, mel, prompt)
            seen["jax"].append((np.asarray(prompt), np.asarray(out[0])))
            return out
        return spied

    decode = tasr._decode

    def spy_decode(enc, prompt):
        out = decode(enc, prompt)
        seen["port"].append((prompt.numpy(), out[0].numpy()))
        return out

    monkeypatch.setattr(jasr, "_program", spy_program)
    monkeypatch.setattr(tasr, "_decode", spy_decode)
    jsegs = jasr.transcribe(wav, 16000, language=language)
    tsegs = tasr.transcribe(wav, 16000, language=language)
    st = tw.SpecialTokens.for_dims(TDIMS)
    (jprompt, jtok), = seen["jax"]
    (tprompt, ttok), = seen["port"]
    assert tprompt[0].tolist() == jprompt[0].tolist() == [
        st.sot, st.lang_base + tw.language_offset(language), st.transcribe,
        st.no_timestamps]
    P = tprompt.shape[1]
    assert (_until_eot(ttok[0], P, st.eot)
            == _until_eot(jtok[0], P, st.eot))
    assert [s.text for s in tsegs] == [s.text for s in jsegs]
    assert [s.language for s in tsegs] == [s.language for s in jsegs]
