"""What the beam-search test files share (``test_torch_beam.py`` and the
trained-model files ``test_torch_beam_trained.py``,
``test_torch_beam_trained_q.py``): the JAX backend's quantized decoder
tree, the SOT prompt, the committed trained tiny model with two held-out
utterances' encoder states, the JAX package's beam tokens per decode
profile, and the trained-model check."""

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


def check_beam_decode_on_trained_model(synth, profile, mode):
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


