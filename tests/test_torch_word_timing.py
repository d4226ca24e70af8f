"""The PyTorch port's DTW word times (``audio_rag_tpu_torch.asr.word_timing``)
and its alignment pass (``decoder_forward(collect_cross_weights=
"alignment_mean")``) against the JAX package's on the CPU: the DTW path bit
for bit on seeded random costs (ties included) and on a real cost matrix,
the word times equal, and the head-averaged cross weights of the trained
tiny model within 1e-5 at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.asr import word_timing as jwt
from audio_rag_tpu.audio.charvoice import synth_text
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu.ops.mel import log_mel_batch
from audio_rag_tpu_torch.asr import word_timing as twt
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import whisper_params
from torch_llm_common import one_torch_thread  # noqa: F401

DIMS = jw.WHISPER_PRESETS["tiny-synth"]
TDIMS = tw.WHISPER_PRESETS["tiny-synth"]
TEXTS = ["gradient descent minimizes", "hybrid search finds words"]

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
    reason="trained ASR asset not built")


@pytest.fixture(scope="module")
def aligned():
    """The trained tiny model's teacher-forced alignment weights for two
    spoken windows, from both packages (f32), and the text tokens."""
    tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tp = whisper_params(tree, TDIMS, "cpu")
    rng = np.random.default_rng(5)
    win = np.zeros((2, 2 * DIMS.n_audio_ctx * 160), np.float32)
    for j, text in enumerate(TEXTS):
        wav = synth_text(text, rng, noise_level=0.005)
        win[j, : wav.size] = wav[: win.shape[1]]
    mel = np.array(log_mel_batch(jnp.asarray(win), n_mels=DIMS.n_mels))
    st = jw.SpecialTokens.for_dims(DIMS)
    prompt = [st.sot, st.lang_base, st.transcribe, st.no_timestamps]
    T = 32
    toks = np.full((2, 4 + T), st.eot, np.int32)
    toks[:, :4] = prompt
    for j, text in enumerate(TEXTS):
        ids = jw.char_encode(text)[:T]
        toks[j, 4: 4 + len(ids)] = ids
    jenc = jw.encode(jp, DIMS, jnp.asarray(mel), jnp.float32)
    jkv = jw.precompute_cross_kv(jp, DIMS, jenc, jnp.float32)
    jlog, _, jwts = jw.decoder_forward(
        jp, DIMS, jnp.asarray(toks), jkv, dtype=jnp.float32,
        collect_cross_weights="alignment_mean")
    tenc = torch.from_numpy(np.array(jenc))  # the same encoder states
    out = {}
    for form in ("stacked", "per_layer"):
        kv = (tw.precompute_cross_kv(tp, TDIMS, tenc, torch.float32)
              if form == "stacked" else
              (lambda i: tw.cross_kv_layer(tp, TDIMS, tenc, i,
                                           torch.float32)))
        out[form] = tw.decoder_forward(
            tp, TDIMS, torch.from_numpy(toks).long(), kv,
            dtype=torch.float32, collect_cross_weights="alignment_mean")
    return (np.asarray(jlog), np.asarray(jwts), out,
            [len(jw.char_encode(t)) for t in TEXTS])


@pytest.mark.parametrize("form", ["stacked", "per_layer"])
def test_alignment_mean_matches_jax(aligned, form):
    """The (B, T, Ta) statistic, from stacked cross K/V and from K/V made
    layer by layer, within 1e-5 of the JAX package's on the same encoder
    states; the logits within the teacher-forced decoder test's 1e-4."""
    jlog, jwts, out, _ = aligned
    logits, cache, wts = out[form]
    assert cache is None
    assert wts.shape == jwts.shape == (2, 36, DIMS.n_audio_ctx)
    assert wts.dtype == torch.float32
    np.testing.assert_allclose(wts.numpy(), jwts, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), jlog, atol=1e-4)


def test_decoder_forward_keeps_its_two_outputs_by_default():
    """Without ``collect_cross_weights`` the pass returns (logits, cache)
    as before, and refuses an unknown collection mode."""
    tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
    tp = whisper_params(tree, TDIMS, "cpu")
    enc = torch.zeros((1, TDIMS.n_audio_ctx, TDIMS.n_audio_state))
    kv = tw.precompute_cross_kv(tp, TDIMS, enc, torch.float32)
    toks = torch.zeros((1, 3), dtype=torch.long)
    assert len(tw.decoder_forward(tp, TDIMS, toks, kv,
                                  dtype=torch.float32)) == 2
    with pytest.raises(ValueError, match="collect_cross_weights"):
        tw.decoder_forward(tp, TDIMS, toks, kv, dtype=torch.float32,
                           collect_cross_weights=True)


def _costs():
    rng = np.random.default_rng(42)
    out = []
    for n, m in [(1, 1), (1, 7), (6, 1), (5, 9), (17, 40), (40, 17),
                 (60, 300)]:
        out.append(rng.standard_normal((n, m)))
        # ties everywhere: few distinct values
        out.append(rng.integers(0, 3, (n, m)).astype(np.float64))
    out.append(np.zeros((8, 12)))
    return out


@pytest.mark.parametrize("case", range(len(_costs())))
def test_dtw_path_matches_jax_bit_for_bit(case):
    cost = _costs()[case]
    ti, fi = twt.dtw_path(cost)
    jti, jfi = jwt.dtw_path(cost)
    assert ti.tolist() == np.asarray(jti).tolist()
    assert fi.tolist() == np.asarray(jfi).tolist()


def test_dtw_and_word_times_on_real_weights(aligned):
    """The trained model's cross weights: the DTW path through their cost
    matrix, and the word times of every token-as-word map, equal to the
    JAX package's."""
    _, jwts, _, n_tok = aligned
    for j in range(2):
        w = jwts[j, 4: 4 + n_tok[j]]
        cost = -jwt._median_filter(
            (w - w.mean(0, keepdims=True)) / (w.std(0, keepdims=True) + 1e-9))
        ti, fi = twt.dtw_path(cost)
        jti, jfi = jwt.dtw_path(cost)
        assert ti.tolist() == np.asarray(jti).tolist()
        assert fi.tolist() == np.asarray(jfi).tolist()
        for words in (list(range(n_tok[j])),
                      [k // 3 for k in range(n_tok[j])],
                      [-1] + [k // 4 for k in range(n_tok[j] - 1)]):
            for n_frames in (DIMS.n_audio_ctx, 150):
                got = twt.attention_to_word_times(w, words, n_frames, 1.5)
                ref = jwt.attention_to_word_times(w, words, n_frames, 1.5)
                assert got == ref


def test_median_filter_and_raw_weights_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 40)).astype(np.float32)
    np.testing.assert_array_equal(twt._median_filter(x, 7),
                                  jwt._median_filter(x, 7))
    raw = rng.random((4, 3, 6, 50)).astype(np.float32)
    words = [0, 0, 1, 2, 2, 3]
    assert (twt.attention_to_word_times(raw, words, 50)
            == jwt.attention_to_word_times(raw, words, 50))
