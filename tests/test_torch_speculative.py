"""Speculative greedy decode of the PyTorch port against the JAX package on
the CPU: the n-gram drafter, the k-token verify pass, and the decode loop,
whose tokens, avg-logprob and no-speech probability are the JAX package's
and the port's own greedy decode's."""

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
from audio_rag_tpu_torch.weights import whisper_params

DIMS = jw.WHISPER_PRESETS["test"]
TDIMS = tw.WHISPER_PRESETS["test"]
ST = jw.SpecialTokens.for_dims(DIMS)
HELD_OUT = ["the quick model learns fast", "hybrid search finds words"]


def _jax_q8(jp, dims, bits=8, lm_head_bits=None):
    """The JAX backend's quantized decoder tree: ``quantize_decoder_weights``
    under ``jax.jit``, as its ASR backend runs it at load (XLA turns the
    scales' division by 127 or 7 into a product with the reciprocal)."""
    return jax.jit(lambda p: jw.quantize_decoder_weights(
        p, dims, bits, lm_head_bits=lm_head_bits))(jp)


@pytest.fixture(scope="module")
def setup():
    """The JAX package's seeded "test" model carried over, the encoder
    states of three random mels (the JAX package's, fed to both) and the
    4-token prompt."""
    jp = jw.init_whisper(jax.random.PRNGKey(0), DIMS)
    tp = whisper_params(jax.tree.map(np.asarray, jp), TDIMS, "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (3, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    enc = np.array(jw.encode(jp, DIMS, jnp.asarray(mel), jnp.float32))
    prompt = np.array([[ST.sot, ST.lang_base, ST.transcribe,
                        ST.no_timestamps]] * 3, np.int32)
    return jp, tp, enc, prompt


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


@pytest.fixture(scope="module")
def synth():
    """The committed trained tiny model and the encoder states of two
    held-out utterances (the JAX package's, fed to both decoders)."""
    tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
    if tree is None:
        pytest.skip("trained ASR asset not built")
    dims = jw.WHISPER_PRESETS["tiny-synth"]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tp = whisper_params(tree, tw.WHISPER_PRESETS["tiny-synth"], "cpu")
    rng = np.random.default_rng(11)
    win = np.zeros((2, 2 * dims.n_audio_ctx * 160), np.float32)
    for j, text in enumerate(HELD_OUT):
        wav = synth_text(text, rng, noise_level=0.005)
        win[j, : wav.size] = wav[: win.shape[1]]
    mel = log_mel_batch(jnp.asarray(win), n_mels=dims.n_mels)
    enc = np.array(jw.encode(jp, dims, mel, jnp.float32))
    return jp, tp, enc


@pytest.mark.parametrize("profile", ["fp32", "int8", "kv4+int8+lm4"])
def test_speculative_matches_jax_on_trained_model(synth, profile):
    """Verify blocks of 8 on held-out speech: the JAX package's tokens (and,
    at fp32, its avg-logprob and no-speech probability) in the fp32, the
    production and the benchmark profile."""
    jp, tp, enc = synth
    dims = jw.WHISPER_PRESETS["tiny-synth"]
    tdims = tw.WHISPER_PRESETS["tiny-synth"]
    st = jw.SpecialTokens.for_dims(dims)
    kv, dec, lm = {"fp32": (0, 0, None), "int8": (8, 8, None),
                   "kv4+int8+lm4": (4, 8, 4)}[profile]
    prompt = np.array([[st.sot, st.lang_base, st.transcribe,
                        st.no_timestamps]] * 2, np.int32)
    rt, rlp, rns = jw.speculative_greedy_decode(
        jp, dims, jnp.asarray(enc), jnp.asarray(prompt), 112, st.eot,
        spec_k=8, dtype=jnp.float32, no_speech_id=st.no_speech,
        cross_kv_quantize=kv > 0, cross_kv_bits=kv or 8,
        decoder_q8=_jax_q8(jp, dims, dec, lm) if dec else None)
    gt, glp, gns, steps = tw.speculative_greedy_decode(
        tp, tdims, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
        112, st.eot, spec_k=8, dtype=torch.float32,
        no_speech_id=st.no_speech, cross_kv_quantize=kv > 0,
        cross_kv_bits=kv or 8,
        decoder_q8=(tw.quantize_decoder_weights(tp, tdims, dec, lm)
                    if dec else None))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    n_tokens = int((gt[:, 4:] != st.eot).sum(1).max())
    assert steps <= n_tokens  # each pass emits ≥ 1 token per unfinished row
    if not dec:
        np.testing.assert_allclose(glp.numpy(), np.asarray(rlp), atol=1e-4)
        np.testing.assert_allclose(gns.numpy(), np.asarray(rns), atol=1e-5)
    if kv != 4:
        heard = [tw.char_decode([i for i in row[4:] if i < st.eot])
                 for row in gt.numpy()]
        for spoken, text in zip(HELD_OUT, heard):
            assert len(set(spoken.split()) & set(text.split())) >= 3, text
