"""Beam search of the PyTorch port (``audio_rag_tpu_torch.models.whisper``
and ``ops.kernels.beam_reorder_kv``) against the JAX package on the CPU:
the reorder's plain version against the Pallas kernel in interpret mode,
``decoder_step(beams=K)`` in both cache layouts, and ``beam_decode``'s
tokens in four decode profiles on the committed trained tiny model, for
each of the port's three reorder modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import synth_text
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu.ops.mel import log_mel_batch
from audio_rag_tpu.ops.pallas_kernels import beam_reorder_kv as pallas_reorder
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.ops import kernels as K
from audio_rag_tpu_torch.weights import whisper_params

TEST = jw.WHISPER_PRESETS["test"]
SYNTH = jw.WHISPER_PRESETS["tiny-synth"]
HELD_OUT = ["the quick model learns fast", "hybrid search finds words"]


def _jax_q8(jp, dims, bits=8, lm_head_bits=None):
    """The JAX backend's quantized decoder tree: ``quantize_decoder_weights``
    under ``jax.jit``, as its ASR backend runs it at load (XLA turns the
    scales' division by 127 or 7 into a product with the reciprocal)."""
    return jax.jit(lambda p: jw.quantize_decoder_weights(
        p, dims, bits, lm_head_bits=lm_head_bits))(jp)


def _prompt(dims, n):
    st = jw.SpecialTokens.for_dims(dims)
    return np.array([[st.sot, st.lang_base, st.transcribe,
                      st.no_timestamps]] * n, np.int32)


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


# -- decoder_step with beams --------------------------------------------------

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


# -- beam_decode --------------------------------------------------------------

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


@pytest.fixture(scope="module")
def synth():
    """The committed trained tiny model and the encoder states of two
    held-out utterances (the JAX package's, fed to both decoders)."""
    tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
    if tree is None:
        pytest.skip("trained ASR asset not built")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tp = whisper_params(tree, tw.WHISPER_PRESETS["tiny-synth"], "cpu")
    rng = np.random.default_rng(11)
    win = np.zeros((2, 2 * SYNTH.n_audio_ctx * 160), np.float32)
    for j, text in enumerate(HELD_OUT):
        wav = synth_text(text, rng, noise_level=0.005)
        win[j, : wav.size] = wav[: win.shape[1]]
    mel = log_mel_batch(jnp.asarray(win), n_mels=SYNTH.n_mels)
    enc = np.array(jw.encode(jp, SYNTH, mel, jnp.float32))
    return jp, tp, enc, {}


#: profile → (cross K/V bits or 0, decoder bits or 0, logits-head bits)
PROFILES = {
    "fp32": (0, 0, None),
    "int8-kv": (8, 0, None),
    "int8-weights": (0, 8, None),
    "kv4+int8+lm4": (4, 8, 4),
}
MAX_NEW = 40


def _jax_beam(synth, profile):
    """The JAX package's beam-5 tokens, computed once per profile."""
    jp, _, enc, memo = synth
    if profile not in memo:
        kv, dec, lm = PROFILES[profile]
        st = jw.SpecialTokens.for_dims(SYNTH)
        memo[profile] = np.asarray(jw.beam_decode(
            jp, SYNTH, jnp.asarray(enc), jnp.asarray(_prompt(SYNTH, 2)),
            MAX_NEW, st.eot, beam_size=5, dtype=jnp.float32,
            decoder_q8=_jax_q8(jp, SYNTH, dec, lm) if dec else None,
            cross_kv_quantize=kv > 0, cross_kv_bits=kv or 8,
            reorder="onehot"))
    return memo[profile]


@pytest.mark.parametrize("mode", tw.BEAM_REORDERS)
@pytest.mark.parametrize("profile", list(PROFILES))
def test_beam_decode_matches_jax_on_trained_model(synth, profile, mode):
    """The port's beam-5 hypothesis equals the JAX package's in each decode
    profile and each reorder mode (the JAX package's "kernel" mode is its
    one-hot reorder off the TPU, and its lazy mode gives the one-hot
    tokens). The unquantized profiles hear the spoken words."""
    _, tp, enc, _ = synth
    kv, dec, lm = PROFILES[profile]
    dims = tw.WHISPER_PRESETS["tiny-synth"]
    st = jw.SpecialTokens.for_dims(SYNTH)
    got, steps = tw.beam_decode(
        tp, dims, torch.from_numpy(enc),
        torch.from_numpy(_prompt(SYNTH, 2)).long(), MAX_NEW, st.eot,
        beam_size=5, dtype=torch.float32,
        decoder_q8=(tw.quantize_decoder_weights(tp, dims, dec, lm)
                    if dec else None),
        cross_kv_quantize=kv > 0, cross_kv_bits=kv or 8, reorder=mode)
    np.testing.assert_array_equal(got.numpy(), _jax_beam(synth, profile))
    assert 1 <= steps <= MAX_NEW - 1
    if kv != 4:
        heard = [tw.char_decode([i for i in row[4:] if i < st.eot])
                 for row in got.numpy()]
        for spoken, text in zip(HELD_OUT, heard):
            assert len(set(spoken.split()) & set(text.split())) >= 3, text


# -- the ASR backend ----------------------------------------------------------

def test_asr_config_checks_the_decode_fields():
    from audio_rag_tpu_torch.config import ASRConfig
    from audio_rag_tpu_torch.core.exceptions import ConfigError

    assert (ASRConfig().decode, ASRConfig().beam_size,
            ASRConfig().speculative_k) == ("greedy", 5, 0)
    for bad in ({"decode": "sample"}, {"beam_size": 0}, {"beam_size": 17},
                {"speculative_k": -1}, {"speculative_k": 9}):
        with pytest.raises(ConfigError):
            ASRConfig(**bad)


@pytest.mark.parametrize("switches,decoder", [
    ({"decode": "beam", "beam_size": 3}, "beam_decode"),
    ({"speculative_k": 4}, "speculative_greedy_decode"),
    ({"speculative_k": 4, "decode": "beam"}, "beam_decode"),
])
def test_asr_picks_the_strategy_and_counts_its_iterations(monkeypatch,
                                                          switches, decoder):
    """Beam wins over speculative; ``decode_steps`` sums the iterations
    the decode loops report (for beam: until every hypothesis finished);
    beam's zero no-speech probability keeps every window."""
    from audio_rag_tpu_torch.asr import whisper as aw
    from audio_rag_tpu_torch.config import ASRConfig

    calls = []
    orig = getattr(aw, decoder)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append(out[-1])
        return out

    monkeypatch.setattr(aw, decoder, spy)
    asr = aw.WhisperASR(ASRConfig(model_size="test", compute_type="float32",
                                  window_batch_size=2, vad_filter=False,
                                  **switches), "cpu")
    audio = 0.05 * np.random.default_rng(0).standard_normal(
        16000 * 4).astype(np.float32)
    segs = asr.transcribe(audio, 16000)
    assert calls and asr.timings["decode_steps"] == sum(calls)
    if decoder == "beam_decode":
        assert len(segs) == asr.timings["windows"]
