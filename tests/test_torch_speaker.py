"""The PyTorch port's speaker encoder and learned VAD
(``audio_rag_tpu_torch.models.speaker``) against the JAX package's jitted
``models/speaker.py`` on the committed assets (``speaker_small.npz``,
``vad_small.npz``) at f32 within 1e-4, the dilated convolution at bf16
within one bf16 rounding, the speaker encoder's log-mel (no max − 8
clamp), and the carry-over of the JAX trees into the port's tensors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.asr import vad as jvad
from audio_rag_tpu.audio.synth import conversation, sample_voice
from audio_rag_tpu.models import speaker as js
from audio_rag_tpu.ops import mel as jmel
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.models import speaker as ts
from audio_rag_tpu_torch.ops import mel as tmel
from audio_rag_tpu_torch.weights import (
    speaker_params,
    speaker_spec,
    vad_params,
)
from torch_llm_common import one_torch_thread  # noqa: F401

SR = 16_000
ONE_ROUNDING = 2.0 ** -8  # one bf16 rounding, relative

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "speaker_small.npz").exists()
    or not (ASSETS_DIR / "vad_small.npz").exists(),
    reason="trained speaker/VAD assets not built")


@pytest.fixture(scope="module")
def clips():
    """Eight 3 s clips of a seeded 3-voice conversation, and silence."""
    rng = np.random.default_rng(21)
    voices = [sample_voice(rng) for _ in range(3)]
    audio, _ = conversation(rng, voices, duration_s=22.0)
    out = np.zeros((8, 3 * SR), np.float32)
    out[:7] = audio[: 7 * 3 * SR].reshape(7, -1)
    return out


@pytest.fixture(scope="module")
def speaker():
    dims, tree = js.load_speaker_asset()
    tdims, ttree = ts.load_speaker_asset()
    assert dataclasses.astuple(tdims) == dataclasses.astuple(dims)
    return tdims, tree, speaker_params(ttree, tdims, "cpu")


@pytest.fixture(scope="module")
def vad():
    jp = jvad._get_learned_runner()  # builds the JAX runner (and asset)
    assert jp
    tree = load_npz_asset(ASSETS_DIR / "vad_small.npz")
    return (jax.tree.map(jnp.asarray, tree), vad_params(tree, "cpu"))


def _jax_mels(clips, n, global_norm):
    return np.array(jax.jit(jax.vmap(
        lambda a: jmel.log_mel_spectrogram(a, n_mels=n,
                                           global_norm=global_norm)))(
        jnp.asarray(clips)))


@pytest.mark.parametrize("global_norm", [False, True])
def test_log_mel_matches_jax(clips, global_norm):
    win = clips[:, : int(1.5 * SR)]
    ref = _jax_mels(win, 80, global_norm)
    got = tmel.log_mel_batch(torch.from_numpy(win), n_mels=80,
                             global_norm=global_norm).numpy()
    assert got.shape == ref.shape == (8, 80, 150)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    one = tmel.log_mel_spectrogram(torch.from_numpy(win[0]), n_mels=80,
                                   global_norm=global_norm).numpy()
    np.testing.assert_allclose(one, got[0], atol=1e-6)


def test_speaker_embed_matches_jitted_jax_f32(clips, speaker):
    dims, tree, tp = speaker
    win = clips[:, : int(1.5 * SR)]
    mels = _jax_mels(win, dims.n_mels, False)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = np.asarray(jax.jit(lambda p, m: js.speaker_embed(
        p, dims, m, dtype=jnp.float32))(jp, jnp.asarray(mels)))
    got = ts.speaker_embed(tp, dims, torch.from_numpy(mels),
                           dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (8, dims.emb_dim)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_vad_scores_match_jitted_jax_f32(clips, vad):
    jp, tp = vad
    mels = _jax_mels(clips, 80, True)
    ref = np.asarray(jax.jit(lambda p, m: js.vad_scores(
        p, m, dtype=jnp.float32))(jp, jnp.asarray(mels)))
    got = ts.vad_scores(tp, torch.from_numpy(mels), dtype=torch.float32)
    assert got.shape == ref.shape == (8, 300)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # the port's learned runner: its own mel, the same probabilities
    runner = __import__("audio_rag_tpu_torch.asr.vad", fromlist=["x"])
    probs = runner._get_learned_runner("cpu")(clips)
    np.testing.assert_allclose(probs, ref, atol=1e-4)


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv1d_bf16_rounds_once(dilation):
    """bf16 operands, f32 sums, the f32 bias, one rounding: within one
    bf16 rounding of the JAX package's jitted convolution."""
    rng = np.random.default_rng(dilation)
    p = {"w": rng.standard_normal((5, 24, 16)).astype(np.float32) * 0.2,
         "b": rng.standard_normal(16).astype(np.float32)}
    x = rng.standard_normal((3, 40, 24)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: js._conv1d(
        p, x, dilation, jnp.bfloat16))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x)).astype(jnp.float32))
    got = ts._conv1d({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), dilation, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref,
                               atol=ONE_ROUNDING, rtol=ONE_ROUNDING)
    f32 = ts._conv1d({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x), dilation, torch.float32)
    np.testing.assert_allclose(f32.numpy(), np.asarray(jax.jit(
        lambda p, x: js._conv1d(p, x, dilation, jnp.float32))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))), atol=1e-5)


def test_speaker_embed_and_vad_bf16(clips, speaker, vad):
    """The whole encoder and VAD at bf16 next to the jitted JAX ones: each
    layer rounds once, and the outputs (unit-norm embeddings,
    probabilities) stay within one bf16 rounding of 1."""
    dims, tree, tp = speaker
    win = clips[:, : int(1.5 * SR)]
    mels = _jax_mels(win, dims.n_mels, False)
    jp = jax.tree.map(jnp.asarray, tree)
    ref = np.asarray(jax.jit(lambda p, m: js.speaker_embed(
        p, dims, m, dtype=jnp.bfloat16))(jp, jnp.asarray(mels)))
    got = ts.speaker_embed(tp, dims, torch.from_numpy(mels),
                           dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, ref, atol=ONE_ROUNDING)
    jv, tv = vad
    vm = _jax_mels(clips, 80, True)
    ref = np.asarray(jax.jit(lambda p, m: js.vad_scores(
        p, m, dtype=jnp.bfloat16))(jv, jnp.asarray(vm)))
    got = ts.vad_scores(tv, torch.from_numpy(vm), dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), ref, atol=ONE_ROUNDING)


def test_speaker_tree_carry_over(speaker):
    """A JAX-layout tree (blocks as a list or keyed by index) → the
    port's tensors, values kept; a wrong key or shape raises."""
    dims, tree, tp = speaker
    assert len(tp["blocks"]) == dims.n_blocks
    for i, blk in enumerate(tree["blocks"]):
        np.testing.assert_array_equal(tp["blocks"][i]["conv"]["w"].numpy(),
                                      blk["conv"]["w"])
    keyed = dict(tree, blocks={str(i): b for i, b in
                               enumerate(tree["blocks"])})
    again = speaker_params(keyed, dims, "cpu")
    np.testing.assert_array_equal(again["proj"]["w"].numpy(),
                                  tree["proj"]["w"])
    assert set(speaker_spec(dims)) == {
        f"blocks/{i}/{leaf}" for i in range(3)
        for leaf in ("conv/w", "conv/b", "ln/g", "ln/b")} | {
        "attn/w", "attn/b", "proj/w", "proj/b"}
    with pytest.raises(KeyError):
        speaker_params(dict(tree, extra={"w": np.zeros(1)}), dims, "cpu")
    bad = dict(tree, proj={"w": np.zeros((256, 7), np.float32),
                           "b": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="proj/w"):
        speaker_params(bad, dims, "cpu")
    # a seeded JAX init carries over too
    jinit = jax.tree.map(np.array, js.init_speaker_encoder(
        jax.random.PRNGKey(0), js.SPEAKER_PRESETS["test"]))
    tdims = ts.SPEAKER_PRESETS["test"]
    tinit = speaker_params(jinit, tdims, "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (2, 80, 50)).astype(np.float32)
    np.testing.assert_allclose(
        ts.speaker_embed(tinit, tdims, torch.from_numpy(mel),
                         torch.float32).numpy(),
        np.asarray(js.speaker_embed(jax.tree.map(jnp.asarray, jinit),
                                    tdims, jnp.asarray(mel), jnp.float32)),
        atol=1e-4)


def test_vad_tree_carry_over():
    """The asset's flat "c1/w" keys and a nested JAX init both load."""
    with np.load(ASSETS_DIR / "vad_small.npz") as data:
        flat = {k: data[k] for k in data.files}
    tp = vad_params(flat, "cpu")
    np.testing.assert_array_equal(tp["c2"]["w"].numpy(), flat["c2/w"])
    jinit = jax.tree.map(np.array, js.init_vad(jax.random.PRNGKey(3),
                                                 n_mels=40, channels=16))
    tinit = vad_params(jinit, "cpu")
    assert tuple(tinit["c1"]["w"].shape) == (5, 40, 16)
    with pytest.raises(KeyError):
        vad_params({"c2": flat["c2/w"]}, "cpu")


def test_resolution_refuses_what_is_not_ported(speaker):
    from audio_rag_tpu_torch.models.ecapa import init_ecapa

    dims = ts.SPEAKER_PRESETS["titanet-jax"]
    # a checkpoint path without speaker.safetensors falls back, as in JAX
    got_dims, _, source = ts.resolve_speaker_params("/some/checkpoint", dims)
    assert (got_dims, source) == (speaker[0], "asset")
    # ECAPA trees are read (models/ecapa.py is ported)
    assert ts.speaker_dims_from_params(init_ecapa()) == ts.SpeakerDims(
        80, 64, 3, 24, 5)
    got_dims, params, source = ts.resolve_speaker_params(None, dims)
    assert (got_dims, source) == (speaker[0], "asset")
    test_dims, _, source = ts.resolve_speaker_params(
        None, ts.SPEAKER_PRESETS["test"], allow_asset=False)
    assert (test_dims, source) == (ts.SPEAKER_PRESETS["test"], "random")
    a, b, c = (ts.init_speaker_encoder(
        test_dims, generator=torch.Generator().manual_seed(seed))
        for seed in (4, 4, 5))
    assert torch.equal(a["proj"]["w"], b["proj"]["w"])
    assert not torch.equal(a["proj"]["w"], c["proj"]["w"])
    assert ts.init_vad()["c1"]["w"].shape == (5, 80, 64)
