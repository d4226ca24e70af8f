"""The port's ECAPA-TDNN (``audio_rag_tpu_torch/models/ecapa.py``) against
the JAX package's ``models/ecapa.py`` and against
``tests/unit/models/test_ecapa_parity.py``'s torch ECAPA (the speechbrain
equations), and the diarizer on a converted ECAPA checkpoint against the
JAX diarizer. Tolerances: 1e-5 of the filterbank's dB range and 1e-5 on
f32 embeddings between the packages, two bf16 ulps at bf16, and
``test_ecapa_parity.py``'s 2e-4 against the torch module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu import checkpoint as jcheckpoint
from audio_rag_tpu.config.schema import DiarizationConfig as JaxDiarConfig
from audio_rag_tpu.diarization import clustering as jclustering
from audio_rag_tpu.models import ecapa as jecapa
from audio_rag_tpu.models import speaker as jspeaker
from audio_rag_tpu_torch.audio.synth import speech_like
from audio_rag_tpu_torch.checkpoint import save_params
from audio_rag_tpu_torch.config import DiarizationConfig
from audio_rag_tpu_torch.convert import convert_speaker
from audio_rag_tpu_torch.diarization import clustering as tclustering
from audio_rag_tpu_torch.models import ecapa as tecapa
from audio_rag_tpu_torch.models import speaker as tspeaker
from audio_rag_tpu_torch.weights import ecapa_params
from torch_hf_common import ecapa_module, flat_tree
from torch_ledger_common import fresh_ledger  # noqa: F401
from torch_llm_common import one_torch_thread  # noqa: F401

SR = 16_000


@pytest.fixture(scope="module")
def jax_tree():
    return jax.tree.map(np.asarray, jecapa.init_ecapa(jax.random.PRNGKey(0),
                                                      n_mels=20))


def _wavs(n: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(length)
    return (0.1 * rng.standard_normal((n, length))).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 20])
@pytest.mark.parametrize("length", [24_000, 16_037])
def test_fbank_matches_jax(n_mels, length):
    """Symmetric Hamming window, HTK filters, the 80 dB floor and the
    sentence mean, batched, against the JAX frontend under ``vmap``."""
    wav = _wavs(3, length)
    ref = np.asarray(jax.vmap(lambda a: jecapa.ecapa_fbank(
        a, n_mels=n_mels))(jnp.asarray(wav)))
    got = tecapa.ecapa_fbank(torch.from_numpy(wav), n_mels=n_mels).numpy()
    assert got.shape == ref.shape == (3, (length - 400) // 160 + 1, n_mels)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.ptp(ref))
    one = tecapa.ecapa_fbank(torch.from_numpy(wav[1]), n_mels=n_mels).numpy()
    np.testing.assert_array_equal(one, got[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_matches_jax(jax_tree, dtype):
    fb = np.array(jax.vmap(lambda a: jecapa.ecapa_fbank(a, n_mels=20))(
        jnp.asarray(_wavs(4, 24_000))))  # a writable copy
    ref = np.asarray(jecapa.ecapa_embed(jax_tree, jnp.asarray(fb),
                                        dtype=getattr(jnp, dtype)))
    params = ecapa_params(jax_tree)
    got = tecapa.ecapa_embed(params, torch.from_numpy(fb),
                             dtype=getattr(torch, dtype)).numpy()
    assert got.shape == ref.shape == (4, 24) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -8
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("prefixed", [False, True])
def test_converted_checkpoint_matches_the_speechbrain_equations(prefixed,
                                                                tmp_path):
    """``test_ecapa_parity.py``'s torch ECAPA with random BatchNorm
    statistics, saved in the release's layout (with the
    ``embedding_model.`` prefix or without), converted, then embedded by
    the port: within 2e-4 of the module's eval-mode output."""
    model = ecapa_module()
    prefix = "embedding_model." if prefixed else ""
    torch.save({prefix + k: v for k, v in model.state_dict().items()},
               tmp_path / "embedding_model.ckpt")
    tree = convert_speaker(tmp_path)
    assert tecapa.is_ecapa_params(tree) and len(tree["layers"]) == 3
    assert dataclasses.astuple(tspeaker.speaker_dims_from_params(tree)) == \
        dataclasses.astuple(jspeaker.speaker_dims_from_params(tree))
    fb = (np.random.default_rng(0).standard_normal((3, 20, 97))
          .astype(np.float32) * 2.0)
    with torch.no_grad():
        ref = model(torch.from_numpy(fb)).numpy()
    got = tecapa.ecapa_embed(ecapa_params(tree),
                             torch.from_numpy(fb.transpose(0, 2, 1).copy()),
                             dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_params_keep_the_lists_and_check_the_layout(jax_tree):
    p = ecapa_params(jax_tree)
    assert isinstance(p["layers"], list) and len(p["layers"]) == 3
    assert isinstance(p["layers"][0]["res2net"], list)
    assert len(p["layers"][0]["res2net"]) == 3
    for k, v in flat_tree(p).items():
        np.testing.assert_array_equal(v, flat_tree(jax_tree)[k])
    broken = jax.tree.map(lambda a: a, jax_tree)
    del broken["layers"][1]["se"]["c2"]["b"]
    with pytest.raises(KeyError, match="se/c2/b"):
        ecapa_params(broken)
    broken = jax.tree.map(lambda a: a, jax_tree)
    broken["mfa"]["bn"]["s"] = np.ones(5, np.float32)
    with pytest.raises(ValueError, match="mfa/bn/s"):
        ecapa_params(broken)


RELEASE = {"channels": 1024, "mfa_channels": 3072, "attn_channels": 128,
           "se_channels": 128, "emb_dim": 192}


@pytest.mark.parametrize("widths", [{}, {**RELEASE, "scale": 4}])
def test_init_has_the_jax_layout(widths):
    """The seeded tree's keys and shapes are the JAX ``init_ecapa``'s, at
    the tiny defaults and at the voxceleb release's widths."""
    ref = jax.eval_shape(lambda k: jecapa.init_ecapa(k, **widths),
                         jax.random.PRNGKey(0))
    ref = flat_tree(jax.tree.map(lambda s: np.empty(s.shape, s.dtype), ref))
    got = flat_tree(tecapa.init_ecapa(**widths))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert {v.dtype for v in got.values()} == {np.dtype(np.float32)}
    ecapa_params(tecapa.init_ecapa(**widths))  # the spec accepts it


def test_init_builds_the_release_where_jax_runs_out_of_keys():
    """The release's scale 8 needs 87 random draws; the JAX ``init_ecapa``
    splits 64 keys and stops short (a defect the port does not copy: its
    draws come from one ``torch.Generator``)."""
    with pytest.raises(StopIteration):
        jax.eval_shape(lambda k: jecapa.init_ecapa(k, **RELEASE, scale=8),
                       jax.random.PRNGKey(0))
    p = ecapa_params(tecapa.init_ecapa(**RELEASE, scale=8))
    assert len(p["layers"][2]["res2net"]) == 7
    assert tuple(p["layers"][0]["res2net"][6]["conv"]["w"].shape) == \
        (3, 128, 128)
    assert tuple(p["fc"]["w"].shape) == (6144, 192)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The torch ECAPA's checkpoint converted and saved in both formats."""
    root = tmp_path_factory.mktemp("ecapa")
    torch.save(ecapa_module().state_dict(), root / "embedding_model.ckpt")
    tree = convert_speaker(root)
    save_params(root / "port", "speaker", tree)
    jcheckpoint.save_params(root / "jax", "speaker", tree)
    return tree, str(root / "port"), str(root / "jax")


def _two_voices():
    return np.concatenate([speech_like(SR * 3, SR, f0=110.0, seed=0),
                           speech_like(SR * 3, SR, f0=250.0, seed=1)])


def test_window_embeddings_match_jax(converted):
    """The diarizers' window batches through the ECAPA path: filterbanks
    of each 1.5 s window, then the encoder in f32."""
    tree = converted[0]
    audio, spans = _two_voices(), [(0.0, 2.9), (3.1, 6.0)]
    dims = tspeaker.speaker_dims_from_params(tree)
    starts, got = tclustering.window_embeddings(
        audio, SR, spans, DiarizationConfig(), dims, ecapa_params(tree),
        torch.device("cpu"))
    jstarts, ref = jclustering.window_embeddings(
        audio, SR, spans, JaxDiarConfig(),
        jspeaker.speaker_dims_from_params(tree), tree)
    assert starts == jstarts and got.shape == ref.shape == (len(starts), 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_diarizer_with_a_converted_checkpoint_matches_jax(converted):
    """``convert_speaker`` → ``save_params`` →
    ``diarization.checkpoint_path``: the dims follow the checkpoint and
    the segments are the JAX diarizer's."""
    _, port, jaxd = converted
    audio = _two_voices()
    ref = jclustering.ClusteringDiarizer(JaxDiarConfig(
        checkpoint_path=jaxd, vad_backend="energy"))
    ref.load()
    try:
        want = [(s.start, s.end, s.speaker) for s in ref.diarize(audio, SR)]
    finally:
        ref.unload()
    d = tclustering.ClusteringDiarizer(DiarizationConfig(
        checkpoint_path=port, vad_backend="energy"), device="cpu")
    assert d.hbm_required_gb == pytest.approx(
        4 * sum(v.size for v in flat_tree(converted[0]).values()) / 1e9)
    d.load()
    assert d.source == "checkpoint" and d.dims.n_mels == 20
    got = [(s.start, s.end, s.speaker) for s in d.diarize(audio, SR)]
    assert got == want and got
    assert all(s.startswith("SPEAKER_") for _, _, s in got)
