"""What the speculative-decode test files share
(``test_torch_speculative.py``, ``test_torch_speculative_decode.py``): the
JAX package's seeded ``test`` model carried over with three random mels'
encoder states, the committed trained tiny model with two held-out
utterances', and the trained-model check."""

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
from torch_whisper_common import HELD_OUT, _jax_q8

DIMS = jw.WHISPER_PRESETS["test"]
TDIMS = tw.WHISPER_PRESETS["test"]
ST = jw.SpecialTokens.for_dims(DIMS)


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


def check_speculative_on_trained_model(synth, profile):
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
