"""The pieces of the port's training path against the JAX package's, on the
CPU: the flash call's gradient (``FlashAttentionFn``) against autograd of
the plain version and against ``jax.grad`` of the JAX einsum attention
(``audio_rag_tpu/models/layers.py::_attend``; on the CPU its
``attend_auto`` takes the einsum), the trainer's dataset
(``scripts/train_asr_torch.py`` against ``scripts/train_asr.py``),
``save_npz_asset`` both ways, the kernel wrappers that refuse a gradient,
and the ASR backend on a trained tree.

Tolerances: dq, dk and dv within 1e-5 of the largest gradient of the
reference (f32 on all sides; the backward reads the forward's output where
autograd reads its own probabilities); the dataset and the saved trees
bit-equal.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.checkpoint import load_npz_asset as jax_load_npz
from audio_rag_tpu.checkpoint import save_npz_asset as jax_save_npz
from audio_rag_tpu.models.layers import _attend as jax_attend
from audio_rag_tpu.models.whisper import WHISPER_PRESETS as JAX_PRESETS
from audio_rag_tpu.models.whisper import SpecialTokens as JaxSpecialTokens
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.checkpoint import save_npz_asset
from audio_rag_tpu_torch.ops import kernels as K
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FLASH_GRAD_TOL = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the flash call's gradient -----------------------------------------------------

@pytest.mark.parametrize("Tq,Tk,D,kv_len,strided", [
    (300, 300, 32, None, False),  # tiny-synth's encoder
    (40, 70, 16, None, False),    # Tq ≠ Tk
    (64, 64, 16, 50, False),      # keys ≥ kv_len masked
    (64, 64, 16, None, True),     # the encoder's head-strided view
])
def test_flash_gradient_matches_plain_and_jax(Tq, Tk, D, kv_len, strided):
    B, H = 2, 3
    rng = np.random.default_rng(Tq + Tk)
    qn = rng.standard_normal((B, H, Tq, D)).astype(np.float32)
    kn, vn = (rng.standard_normal((B, H, Tk, D)).astype(np.float32)
              for _ in range(2))
    don = rng.standard_normal((B, H, Tq, D)).astype(np.float32)

    def leaf(a):
        if strided:  # (B, T, H, D) storage seen as (B, H, T, D)
            base = torch.from_numpy(np.ascontiguousarray(
                a.transpose(0, 2, 1, 3))).requires_grad_(True)
            return base, base.transpose(1, 2)
        t = torch.from_numpy(a).requires_grad_(True)
        return t, t

    (qb, q), (kb, k), (vb, v) = leaf(qn), leaf(kn), leaf(vn)
    do = torch.from_numpy(don)
    out = K.flash_attention(q, k, v, kv_len)
    assert out.grad_fn is not None and "FlashAttention" in str(out.grad_fn)
    got = [g.transpose(1, 2) if strided else g
           for g in torch.autograd.grad(out, (qb, kb, vb), do)]

    qp, kp, vp = (torch.from_numpy(a).requires_grad_(True)
                  for a in (qn, kn, vn))
    plain = torch.autograd.grad(
        K.flash_attention_plain(qp, kp, vp, kv_len), (qp, kp, vp), do)

    mask = None
    if kv_len is not None:
        mask = jnp.arange(Tk)[None, None, None, :] < kv_len
    jgrads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
        jax_attend(q, k, v, mask) * don), argnums=(0, 1, 2)))(qn, kn, vn)
    for name, g, p, j in zip("qkv", got, plain, jgrads):
        j = np.asarray(j)
        for ref in (p.numpy(), j):
            np.testing.assert_allclose(
                g.numpy(), ref, rtol=0,
                atol=FLASH_GRAD_TOL * max(1.0, np.abs(ref).max()),
                err_msg=f"d{name}")


def test_flash_backward_is_chunked_over_query_rows(monkeypatch):
    """Chunks of a few query rows give what one chunk gives (dK and dV
    summed over the chunks in order)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn((2, 2, 37, 16), generator=g)
                   for _ in range(4))
    o = K.flash_attention_plain(q, k, v, 30)
    whole = K.flash_attention_backward(q, k, v, o, do, 30)
    monkeypatch.setattr(K, "FLASH_BWD_CHUNK_BYTES", 4 * 2 * 2 * 37 * 5)
    for a, b in zip(K.flash_attention_backward(q, k, v, o, do, 30), whole):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_inference_calls_stay_off_the_autograd_function():
    q = torch.randn((1, 2, 8, 16))
    assert K.flash_attention(q, q, q).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert K.flash_attention(qg, qg, qg).grad_fn is None


def test_kernels_without_a_backward_refuse_grad():
    """The other six wrappers raise when grad mode is on and an input
    requires grad (on CUDA their output would carry no gradient; the CPU
    behaves alike), and run under ``torch.no_grad()``."""
    x = torch.randn((4, 64), requires_grad=True)
    w8 = torch.ones((64, 32), dtype=torch.int8)
    w4 = torch.ones((32, 32), dtype=torch.int8)
    q = torch.randn((1, 2, 1, 64), requires_grad=True)
    kv8 = torch.ones((1, 2, 64, 16), dtype=torch.int8)
    kv4 = torch.ones((1, 2, 32, 16), dtype=torch.int8)
    s11 = torch.ones((1, 2, 1, 1))
    s1d = torch.ones((1, 2, 1, 64))
    sc = torch.zeros((1, 16, K.SELF_LANES))
    cache = torch.zeros((1, 2, 1, 4, 8), requires_grad=True)
    calls = [
        lambda: K.matmul_q8w(x, w8, torch.ones((32,))),
        lambda: K.matmul_q4w(x, w4, torch.ones((1, 32))),
        lambda: K.decode_cross_attention_q8(q, kv8, kv8, s11, s11),
        lambda: K.decode_cross_attention_q4(q, kv4, kv4, s1d, s1d),
        lambda: K.decode_self_attention_q8(q, kv8, kv8, sc),
        lambda: K.beam_reorder_kv(cache, cache, torch.tensor([1, 0])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad():
            call()


# -- the trainer's dataset ------------------------------------------------------------

def test_build_dataset_matches_jax():
    """16 utterances (2 rendered by the TTS), the same seeds: texts, audio,
    tokens, targets and mask bit-equal. Both scripts are handed the port's
    TTS: Griffin-Lim's phase search makes the two packages' renderings of
    one text different waveforms (the TTS is held on the mel in
    ``test_torch_tts.py``), so the TTS rows here check the draws around
    the rendering (gain, onset) and must be equal too."""
    from audio_rag_tpu.audio.charvoice import corpus_lexicon as jax_lexicon
    from audio_rag_tpu.audio.charvoice import (
        make_utterance_texts as jax_texts,
    )
    from audio_rag_tpu_torch.config import TTSConfig
    from audio_rag_tpu_torch.models.whisper import (
        WHISPER_PRESETS,
        SpecialTokens,
    )
    from audio_rag_tpu_torch.tts.neural import NeuralTTS

    jax_script = _script("train_asr")
    port_script = _script("train_asr_torch")
    n = 16
    dims = WHISPER_PRESETS["tiny-synth"]
    tts = NeuralTTS(TTSConfig(backend="jax"), device="cpu")
    n_tts = int(n * port_script.TTS_FRACTION)
    assert n_tts == int(n * jax_script.TTS_FRACTION) == 2
    for const in ("N_DATA", "BATCH", "STEPS", "S", "LR", "TTS_FRACTION"):
        assert getattr(port_script, const) == getattr(jax_script, const)

    rng = np.random.default_rng(0)
    texts = port_script.make_utterance_texts(
        rng, n, port_script.corpus_lexicon(), double_p=0.10)
    got = port_script.build_dataset(rng, texts, SpecialTokens.for_dims(dims),
                                    2 * dims.n_audio_ctx, tts=tts,
                                    n_tts=n_tts)
    jrng = np.random.default_rng(0)
    jtexts = jax_texts(jrng, n, jax_lexicon(), double_p=0.10)
    assert texts == jtexts
    ref = jax_script.build_dataset(
        jrng, jtexts, JaxSpecialTokens.for_dims(JAX_PRESETS["tiny-synth"]),
        2 * dims.n_audio_ctx, tts=tts, n_tts=n_tts)
    for name, a, b in zip(("audio", "tokens", "targets", "mask"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert rng.random() == jrng.random()  # the same draws, to the end
    assert np.abs(got[0][-n_tts:]).max() > 0  # the TTS rows hold audio


def test_trainer_never_writes_the_committed_asset(monkeypatch):
    script = _script("train_asr_torch")
    assert script.OUT.parent == ROOT / "build"
    monkeypatch.setattr(sys, "argv", [
        "train_asr_torch.py", "--device", "cpu",
        "--out", str(ASSETS_DIR / "asr_tiny_synth.npz")])
    with pytest.raises(SystemExit, match="not written"):
        script.main()


# -- checkpoints and the ASR backend on a trained tree --------------------------------

def test_npz_assets_carry_across_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    tree = {"encoder": {"conv1": {"w": rng.standard_normal((3, 4, 5))
                                  .astype(np.float32)},
                        "pos": rng.standard_normal((6, 5))
                        .astype(np.float16)},
            "decoder": {"ln": {"g": np.ones(5, np.float32)}}}
    as_tensors = {"encoder": {"conv1": {"w": torch.from_numpy(
        tree["encoder"]["conv1"]["w"]).requires_grad_(True)},
        "pos": torch.from_numpy(tree["encoder"]["pos"])},
        "decoder": {"ln": {"g": torch.from_numpy(tree["decoder"]["ln"]["g"])}}}
    save_npz_asset(tmp_path / "port.npz", as_tensors)
    jax_save_npz(tmp_path / "jax.npz", jax.tree.map(jnp.asarray, tree))
    for read in (jax_load_npz(tmp_path / "port.npz"),
                 load_npz_asset(tmp_path / "jax.npz")):
        flat_got = jax.tree_util.tree_leaves_with_path(read)
        flat_ref = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
        for (_, a), (_, b) in zip(flat_got, flat_ref):
            assert np.asarray(a).dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("kind", ["tree", "path"])
def test_asr_takes_a_trained_tree_or_path(kind, tmp_path):
    """``WhisperASR(weights=...)`` loads a tree or an ``.npz`` in place of
    the committed asset; the committed asset given either way loads the
    parameters the default load does."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.config import ASRConfig

    cfg = ASRConfig(model_size="tiny-synth", compute_type="float32",
                    vad_filter=False, temperature_fallback=False)
    path = ASSETS_DIR / "asr_tiny_synth.npz"
    default = WhisperASR(cfg, device="cpu")
    default.load()
    if kind == "tree":
        tree = load_npz_asset(path)
        tree["decoder"]["ln"]["g"] = torch.from_numpy(
            tree["decoder"]["ln"]["g"].astype(np.float32))
        weights = tree
    else:
        weights = path
    asr = WhisperASR(cfg, device="cpu", weights=weights)
    asr.load()
    from audio_rag_tpu_torch.weights import _flatten

    got, ref = _flatten(asr._params), _flatten(default._params)
    assert got.keys() == ref.keys()
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
    asr.unload()
    default.unload()
    missing = WhisperASR(cfg, device="cpu", weights=tmp_path / "none.npz")
    with pytest.raises(Exception, match="not found"):
        missing.load()
