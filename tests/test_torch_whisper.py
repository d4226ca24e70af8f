"""The PyTorch port's Whisper (``audio_rag_tpu_torch.models.whisper``) against
the JAX package's ``models/whisper.py`` on the CPU: the committed trained
tiny model (``asr_tiny_synth.npz``) on held-out charvoice speech, greedy
tokens in the fp32 and the quantized decode profiles, and the quantized
trees, cross K/V and self caches."""

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
from audio_rag_tpu_torch.weights import (
    whisper_cross_kv,
    whisper_params,
    whisper_q8_params,
    whisper_self_cache_q8,
)

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


def _jax_q8(jp, dims, bits=8, lm_head_bits=None):
    """The JAX backend's quantized decoder tree: ``quantize_decoder_weights``
    under ``jax.jit``, as its ASR backend runs it at load (XLA turns the
    scales' division by 127 or 7 into a product with the reciprocal)."""
    return jax.jit(lambda p: jw.quantize_decoder_weights(
        p, dims, bits, lm_head_bits=lm_head_bits))(jp)


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


def _exact_cross_inputs():
    """The test preset with cross K/V weights and encoder states whose
    products and sums are exact in f32, so both packages feed the quantizer
    the same numbers."""
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
    return dims, tree, enc


def test_int8_cross_kv_is_bit_exact():
    """The int8 K/V in the transposed (L, B, H, D, Ta) layout and the
    per-(L, B, H) scales are identical, rounding ties included."""
    dims, tree, enc = _exact_cross_inputs()
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


def test_int4_cross_kv_is_bit_exact():
    """The int4 K/V nibble-packed along D in half-split order
    (L, B, H, D/2, Ta) and the per-channel (L, B, H, 1, D) scales are
    identical, rounding ties included; the teacher-forced path's unpacking
    is the JAX package's."""
    dims, tree, enc = _exact_cross_inputs()
    tdims = tw.WHISPER_PRESETS["test"]
    jp = jax.tree.map(jnp.asarray, tree)
    ref = jw.precompute_cross_kv(jp, dims, jnp.asarray(enc), jnp.float32,
                                 quantize=True, bits=4)
    tp = whisper_params(tree, tdims, "cpu")
    got = tw.precompute_cross_kv(tp, tdims, torch.from_numpy(enc),
                                 torch.float32, quantize=True, bits=4)
    hd = dims.n_text_state // dims.n_text_head
    assert got[0].shape == (dims.n_text_layer, 2, dims.n_text_head, hd // 2,
                            dims.n_audio_ctx)
    assert got[2].shape == (dims.n_text_layer, 2, dims.n_text_head, 1, hd)
    for g, r, dtype in zip(got, ref, (torch.int8, torch.int8,
                                      torch.float32, torch.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tw._unpack_kv4(got[0]).numpy(),
                                  np.asarray(jw._unpack_kv4(ref[0])))
    with pytest.raises(ValueError, match="bits"):
        tw.precompute_cross_kv(tp, tdims, torch.from_numpy(enc),
                               torch.float32, quantize=True, bits=2)


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


@pytest.mark.parametrize("bits,lm_head_bits", [(4, None), (8, 4)])
def test_int4_and_mixed_decoder_trees_are_bit_exact(models, bits,
                                                    lm_head_bits):
    """The all-int4 tree and the int8-blocks + int4-head tree carry the
    JAX package's packed bytes and scales exactly."""
    jp, tp = models
    ref = whisper_q8_params(jax.tree.map(np.asarray, _jax_q8(
        jp, DIMS, bits, lm_head_bits)), TDIMS, "cpu")
    got = tw.quantize_decoder_weights(tp, TDIMS, bits, lm_head_bits)
    assert set(got["logits"]) == {"w4", "s"}
    assert set(got["blocks"][0]["mlp_up"]) == ({"w4", "s"} if bits == 4
                                               else {"w8", "s"})
    for g, r in zip(got["blocks"] + [{"logits": got["logits"]}],
                    ref["blocks"] + [{"logits": ref["logits"]}]):
        for name in r:
            assert g[name].keys() == r[name].keys()
            for key in r[name]:
                assert g[name][key].dtype == r[name][key].dtype
                assert torch.equal(g[name][key], r[name][key]), (name, key)
    with pytest.raises(ValueError, match="lm_head_bits"):
        tw.quantize_decoder_weights(tp, TDIMS, 8, lm_head_bits=2)


def test_self_cache_quantization_is_bit_exact():
    """``quantize_self_cache`` (per-position scales, the pad to a multiple
    of 128, the packed scales + mask operand) and ``pack_self_scales``
    give the JAX package's arrays exactly, as the backend computes them:
    under ``jax.jit`` (the primed cache is quantized inside its compiled
    decode, where the scale is a product with the f32 reciprocal of 127).
    On this input the jitted scales differ from an eager call's."""
    rng = np.random.default_rng(8)
    L, B, H, C, hd = 2, 3, 4, 20, 32
    sk, sv = (rng.standard_normal((L, B, H, C, hd)).astype(np.float32)
              for _ in range(2))
    sk[0, 0, 0, 3] = 0.0  # an all-zero position: scale 1
    ref = jax.jit(jw.quantize_self_cache, static_argnums=2)(
        jnp.asarray(sk), jnp.asarray(sv), 7)
    eager = jw.quantize_self_cache(jnp.asarray(sk), jnp.asarray(sv), 7)
    assert (np.asarray(eager[2]) != np.asarray(ref[2])).any()
    got = tw.quantize_self_cache(torch.from_numpy(sk), torch.from_numpy(sv),
                                 7)
    assert got[0].shape == (L, B, H, hd, 128) and got[2].shape == (
        L, B, 128, 128)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    from audio_rag_tpu.ops.pallas_kernels import pack_self_scales

    ks, vs = (rng.random((B, H, 128)).astype(np.float32) for _ in range(2))
    valid = np.arange(128)[None, :] < np.array([[0], [5], [128]])
    np.testing.assert_array_equal(
        tw.pack_self_scales(torch.from_numpy(ks), torch.from_numpy(vs),
                            torch.from_numpy(valid)).numpy(),
        np.asarray(pack_self_scales(jnp.asarray(ks), jnp.asarray(vs),
                                    jnp.asarray(valid))))


def test_decoder_step_on_int8_self_cache_matches_jax(models, encoded):
    """Fed the same quantized state (the JAX package's int4 cross K/V and
    int8 self cache, carried across by ``weights``), three decode steps on
    the int8 self cache give the same logits, and the positions they write
    hold the same int8 K/V (a value one step apart where the two packages'
    f32 projections straddle a rounding tie) and the same packed scales."""
    jp, tp = models
    jenc, _ = encoded
    st = jw.SpecialTokens.for_dims(DIMS)
    jkv = jw.precompute_cross_kv(jp, DIMS, jnp.asarray(jenc), jnp.float32,
                                 quantize=True, bits=4)
    jq8 = _jax_q8(jp, DIMS, 4)
    jcache = (jnp.zeros((DIMS.n_text_layer, 2, DIMS.n_text_head, 20, 32),
                        jnp.float32),) * 2
    toks = np.array([[st.sot, 5, 9, 12], [st.sot, 6, 10, 13]], np.int32)
    for t in range(2):  # prime two positions in the bf16/f32 cache
        _, jcache = jw.decoder_step(jp, DIMS, jnp.asarray(toks[:, t:t + 1]),
                                    jkv, t, jcache, jnp.float32, q8=jq8)
    jcache = jax.jit(jw.quantize_self_cache, static_argnums=2)(*jcache, 2)
    tkv = whisper_cross_kv(jax.tree.map(np.asarray, jkv), TDIMS)
    tq8 = whisper_q8_params(jax.tree.map(np.asarray, jq8), TDIMS)
    tcache = whisper_self_cache_q8(jax.tree.map(np.asarray, jcache), TDIMS)
    for t in range(2, 4):
        ref, jcache = jw.decoder_step(
            jp, DIMS, jnp.asarray(toks[:, t:t + 1]), jkv, t, jcache,
            jnp.float32, q8=jq8, self_kv_int8=True)
        got, tcache = tw.decoder_step(
            tp, TDIMS, torch.from_numpy(toks[:, t:t + 1]).long(), tkv, t,
            tcache, torch.float32, q8=tq8, self_kv_int8=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    for g, r in zip(tcache[:2], jcache[:2]):
        diff = np.abs(g.numpy().astype(np.int32) - np.asarray(r, np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    np.testing.assert_allclose(tcache[2].numpy(), np.asarray(jcache[2]),
                               rtol=1e-6)


#: profile → (cross K/V bits or 0, decoder bits or 0, logits-head bits,
#: int8 self cache, whether the JAX package keeps the spoken words)
PROFILES = {
    "fp32": (0, 0, None, False, True),
    "int8": (8, 8, None, False, True),
    "int8+lm4": (8, 8, 4, False, True),
    "int8+dec4+skv8": (8, 4, None, True, False),
    "kv4+int8+lm4": (4, 8, 4, False, False),
    "kv4+dec4+skv8": (4, 4, None, True, False),
}


@pytest.mark.parametrize("profile", list(PROFILES))
def test_greedy_decode_matches_jax(models, encoded, profile):
    """Identical greedy tokens on the held-out speech in every profile. The
    quantized profiles' sums differ by design (the port's int8 matmul
    follows the TPU kernel and rounds activations to bf16; the JAX
    package's CPU fallback does not), so log-probabilities are compared at
    fp32 only. Under int4 weights or int4 cross K/V (per-channel scales over
    tiny-synth's 32-dim heads) the JAX package itself loses letters of
    these held-out words ("ybrid seaerch", "leaarns fas"), so the full
    spoken-word check applies where it keeps them."""
    jp, tp = models
    jenc, tenc = encoded
    st = jw.SpecialTokens.for_dims(DIMS)
    kv_bits, dec_bits, lm_bits, skv8, words = PROFILES[profile]
    q = dec_bits > 0
    prompt = _prompt(2)
    # under jax.jit, as the backend runs it (the primed self cache is
    # quantized inside the compiled decode)
    jt, jlp, jns = jax.jit(lambda p, q8, enc, pr: jw.greedy_decode(
        p, DIMS, enc, pr, 112, st.eot, dtype=jnp.float32,
        no_speech_id=st.no_speech, cross_kv_quantize=kv_bits > 0,
        cross_kv_bits=kv_bits or 8, decoder_q8=q8, self_kv_int8=skv8))(
        jp, _jax_q8(jp, DIMS, dec_bits, lm_bits) if q else None,
        jnp.asarray(jenc), jnp.asarray(prompt))
    tt, tlp, tns = tw.greedy_decode(
        tp, TDIMS, tenc, torch.from_numpy(prompt).long(), 112, st.eot,
        dtype=torch.float32, no_speech_id=st.no_speech,
        cross_kv_quantize=kv_bits > 0, cross_kv_bits=kv_bits or 8,
        decoder_q8=tw.quantize_decoder_weights(
            tp, TDIMS, dec_bits, lm_bits) if q else None,
        self_kv_int8=skv8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    text = [tw.char_decode([i for i in row[4:] if i < st.eot])
            for row in tt.numpy()]
    for spoken, heard in zip(HELD_OUT, text):  # the model hears the speech
        assert len(set(spoken.split()) & set(heard.split())) >= (
            3 if words else 1), heard
    if not q:
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
        np.testing.assert_allclose(tns.numpy(), np.asarray(jns), atol=1e-5)


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
