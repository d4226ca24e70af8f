"""What the Whisper test files share (``test_torch_whisper.py`` and
``test_torch_whisper_greedy.py``): the committed trained tiny model in
both packages, the log-mel and the encoder states of two held-out
utterances, the JAX backend's quantized decoder tree, the SOT prompt, and
the greedy-decode check of each decode profile."""

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

DIMS = jw.WHISPER_PRESETS["tiny-synth"]
TDIMS = tw.WHISPER_PRESETS["tiny-synth"]
HELD_OUT = ["the quick model learns fast", "hybrid search finds words"]

#: the files' module mark: their tests need the trained asset
NEEDS_ASSET = pytest.mark.skipif(
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


def check_greedy_decode(models, encoded, profile):
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
