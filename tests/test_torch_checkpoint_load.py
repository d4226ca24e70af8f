"""Every backend of the port through ``checkpoint_path`` against its JAX
backend on the same tree: the port reads ``{path}/{name}.safetensors``
(its own ``save_params``), the JAX backend an orbax directory written
with ``audio_rag_tpu.checkpoint.save_params``. Trees are seeded at the
``test`` presets (the converters are held in ``test_torch_convert.py``).
Also: a missing checkpoint falls back as in the JAX package, a checkpoint
directory with HuggingFace tokenizer files is refused, and the port's
backends load themselves where the JAX ones raise
``ModelNotLoadedError``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from audio_rag_tpu import checkpoint as jcheckpoint
from audio_rag_tpu.config.schema import (
    ASRConfig as JaxASRConfig,
    DiarizationConfig as JaxDiarizationConfig,
    EmbeddingConfig as JaxEmbeddingConfig,
    GenerationConfig as JaxGenerationConfig,
    RerankingConfig as JaxRerankingConfig,
)
from audio_rag_tpu.core.exceptions import ModelNotLoadedError
from audio_rag_tpu_torch.audio.charvoice import SR, synth_text
from audio_rag_tpu_torch.checkpoint import save_params
from audio_rag_tpu_torch.config import (
    ASRConfig,
    DiarizationConfig,
    EmbeddingConfig,
    GenerationConfig,
    RerankingConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.models.bert import BERT_PRESETS, init_bert
from audio_rag_tpu_torch.models.bgem3 import init_bgem3
from audio_rag_tpu_torch.models.cross_encoder import init_cross_encoder
from audio_rag_tpu_torch.models.ecapa import init_ecapa
from audio_rag_tpu_torch.models.llm import LLM_PRESETS, init_llm
from audio_rag_tpu_torch.models.whisper import WHISPER_PRESETS, init_whisper
from torch_hf_common import flat_tree
from torch_ledger_common import fresh_ledger  # noqa: F401
from torch_llm_common import one_torch_thread  # noqa: F401

TEXTS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure", "gradient descent loss"]
QUERY = "what minimizes the loss"
PROMPTS = ["gradient descent minimizes the loss", "spectrogram harmonic"]


def _numpy(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree)


def _nli_tree():
    """A 3-label cross-encoder at xlmr-base's heads and vocabulary (the
    JAX scorer runs any checkpoint at xlmr-base's dims), narrow and
    shallow: width 48 (12 heads of 4), one layer, 514 positions."""
    dims = dataclasses.replace(BERT_PRESETS["xlmr-base"], d_model=48,
                               n_layers=1, d_ff=96)
    return _numpy(init_cross_encoder(dims, n_out=3, seed=4))


TREES = {
    "whisper": lambda: _numpy(init_whisper(WHISPER_PRESETS["test"], seed=3)),
    "bgem3": lambda: _numpy(init_bgem3(BERT_PRESETS["test"], seed=3)),
    "e5": lambda: _numpy(init_bert(BERT_PRESETS["test"],
                                   torch.Generator().manual_seed(3), "cpu",
                                   torch.float32)),
    "reranker": lambda: _numpy(init_cross_encoder(BERT_PRESETS["test"],
                                                  seed=3)),
    "llm": lambda: _numpy(init_llm(LLM_PRESETS["test"],
                                   torch.Generator().manual_seed(3),
                                   torch.float32)),
    "nli": _nli_tree,
    "speaker": lambda: _numpy(init_ecapa(torch.Generator().manual_seed(3),
                                         n_mels=40)),
}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """name → (port directory, JAX orbax directory) of the same tree."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for name, make in TREES.items():
        tree = make()
        port, jaxd = root / f"{name}_port", root / f"{name}_jax"
        save_params(port, name, tree)
        jcheckpoint.save_params(jaxd, name, tree)
        out[name] = (str(port), str(jaxd))
    return out


def _speech(seconds: float = 3.0) -> np.ndarray:
    rng = np.random.default_rng(0)
    wav = synth_text("gradient descent loss spectrogram", rng)
    return np.resize(wav, int(seconds * SR)).astype(np.float32)


def _segs(segs):
    return [(s.text, round(s.start, 3), round(s.end, 3), s.speaker)
            for s in segs]


# -- each backend against its JAX backend -------------------------------------

def _whisper(ckpts):
    from audio_rag_tpu.asr.whisper_jax import WhisperJaxASR
    from audio_rag_tpu_torch.asr.whisper import WhisperASR

    kw = {"model_size": "test", "compute_type": "float32",
          "vad_filter": False, "temperature_fallback": False}
    port, jaxd = ckpts["whisper"]
    ref = WhisperJaxASR(JaxASRConfig(checkpoint_path=jaxd,
                                     mel_sharded=False, **kw))
    ref.load()
    try:
        want = _segs(ref.transcribe(_speech(), SR))
    finally:
        ref.unload()
    got = _segs(WhisperASR(ASRConfig(checkpoint_path=port, **kw),
                           device="cpu").transcribe(_speech(), SR))
    assert got == want and len(got) >= 2


def _embedder(ckpts, backend: str, name: str):
    from audio_rag_tpu.embeddings import bge as jbge
    from audio_rag_tpu.embeddings import e5 as je5
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.embeddings.e5 import E5Embedder

    port, jaxd = ckpts[name]
    jcls, tcls = ((jbge.BGEM3Embedder, BGEM3Embedder) if name == "bgem3"
                  else (je5.E5Embedder, E5Embedder))
    ref = jcls(JaxEmbeddingConfig(backend=backend, model="test",
                                  checkpoint_path=jaxd))
    ref.load()
    try:
        want = ref.embed(TEXTS)
    finally:
        ref.unload()
    got = tcls(EmbeddingConfig(backend=backend, model="test",
                               checkpoint_path=port),
               device="cpu").embed(TEXTS)
    for r, g in zip(want, got):
        cos = float(np.dot(r.dense, g.dense)
                    / (np.linalg.norm(r.dense) * np.linalg.norm(g.dense)))
        assert cos >= 0.9999, (g.text, cos)
        if r.sparse is not None:
            assert set(g.sparse.indices.tolist()) == set(
                r.sparse.indices.tolist())


def _reranker(ckpts):
    from audio_rag_tpu.core.types import RetrievalResult as JaxResult
    from audio_rag_tpu.reranking.bge import BGEReranker as JaxReranker
    from audio_rag_tpu_torch.reranking.bge import BGEReranker

    port, jaxd = ckpts["reranker"]
    ref = JaxReranker(JaxRerankingConfig(model="test", checkpoint_path=jaxd))
    ref.load()
    try:
        want = ref.rerank(QUERY, [JaxResult(t, 0.5, chunk_id=str(i))
                                  for i, t in enumerate(TEXTS * 3)], top_k=4)
    finally:
        ref.unload()
    got = BGEReranker(RerankingConfig(model="test", checkpoint_path=port),
                      device="cpu").rerank(
        QUERY, [RetrievalResult(t, 0.5, chunk_id=str(i))
                for i, t in enumerate(TEXTS * 3)], top_k=4)
    # bf16 scores: within two bf16 ulps of the largest
    tol = 2 * 2.0 ** -7 * max(1.0, max(abs(r.score) for r in want))
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0, atol=tol)
    assert {r.text for r in got} == {r.text for r in want}


def _generator(ckpts):
    from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxGenerator
    from audio_rag_tpu_torch.generation.llm import LLMGenerator

    port, jaxd = ckpts["llm"]
    kw = {"model": "test", "temperature": 0.0, "max_tokens": 8}
    ref = JaxGenerator(JaxGenerationConfig(checkpoint_path=jaxd, **kw))
    ref.load()
    try:
        ref.generate_batch(PROMPTS)
        want = ref.last_token_ids
    finally:
        ref.unload()
    gen = LLMGenerator(GenerationConfig(checkpoint_path=port, **kw),
                       device="cpu")
    gen.generate_batch(PROMPTS)
    assert gen.last_token_ids == want and all(want)


def _nli(ckpts):
    from audio_rag_tpu.evaluation.nli import NLIScorer as JaxNLI
    from audio_rag_tpu_torch.evaluation.nli import NLIScorer

    port, jaxd = ckpts["nli"]
    ref = JaxNLI(checkpoint_path=jaxd)
    got = NLIScorer(checkpoint_path=port, device="cpu")
    assert got.dims.n_heads == ref.dims.n_heads == 12
    np.testing.assert_allclose(got.probs(TEXTS[:2], PROMPTS),
                               ref.probs(TEXTS[:2], PROMPTS), atol=1e-5,
                               rtol=0)


def _diarizer(ckpts, backend: str):
    from audio_rag_tpu.diarization import ahc as jahc
    from audio_rag_tpu.diarization import clustering as jclustering
    from audio_rag_tpu_torch.diarization import create_diarizer

    port, jaxd = ckpts["speaker"]
    jcls = (jclustering.ClusteringDiarizer if backend == "clustering"
            else jahc.AHCDiarizer)
    audio = np.concatenate([_speech(2.5), 0.3 * _speech(2.5)[::-1]])
    ref = jcls(JaxDiarizationConfig(backend=backend, checkpoint_path=jaxd,
                                    vad_backend="energy"))
    ref.load()
    try:
        want = _segs(ref.diarize(audio, SR, num_speakers=2))
    finally:
        ref.unload()
    d = create_diarizer(DiarizationConfig(backend=backend,
                                          checkpoint_path=port,
                                          vad_backend="energy"), device="cpu")
    d.load()
    assert d.source == "checkpoint" and d.dims.n_mels == 40
    assert _segs(d.diarize(audio, SR, num_speakers=2)) == want
    assert len({s[3] for s in want}) == 2


BACKENDS = {
    "whisper": _whisper,
    "bgem3": lambda c: _embedder(c, "bge-m3", "bgem3"),
    "e5": lambda c: _embedder(c, "multilingual-e5", "e5"),
    "reranker": _reranker,
    "llm": _generator,
    "nli": _nli,
    "clustering": lambda c: _diarizer(c, "clustering"),
    "ahc": lambda c: _diarizer(c, "ahc"),
}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backend_through_checkpoint_path_matches_jax(ckpts, backend):
    BACKENDS[backend](ckpts)


def test_checkpoint_path_loads_the_saved_tree(ckpts):
    """The Whisper backend's parameters are the saved tree, leaf for
    leaf."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.checkpoint import restore_params

    port = ckpts["whisper"][0]
    asr = WhisperASR(ASRConfig(model_size="test", compute_type="float32",
                               checkpoint_path=port), device="cpu")
    asr.load()
    got, want = flat_tree(asr._params), flat_tree(
        restore_params(port, "whisper"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- a missing checkpoint -----------------------------------------------------

def _outputs(kind: str, ckpt: str | None):
    """The port backend's output with ``checkpoint_path`` ``ckpt``."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.diarization import create_diarizer
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.embeddings.e5 import E5Embedder
    from audio_rag_tpu_torch.evaluation.nli import NLIScorer
    from audio_rag_tpu_torch.generation.llm import LLMGenerator
    from audio_rag_tpu_torch.reranking.bge import BGEReranker

    if kind == "whisper":
        return _segs(WhisperASR(ASRConfig(
            model_size="tiny-synth", compute_type="float32",
            vad_filter=False, temperature_fallback=False,
            max_decode_tokens=16, checkpoint_path=ckpt),
            device="cpu").transcribe(_speech(6.0), SR))
    if kind == "bgem3":
        return [r.dense.tolist() for r in BGEM3Embedder(EmbeddingConfig(
            model="eval-small", checkpoint_path=ckpt), "cpu").embed(TEXTS)]
    if kind == "e5":
        return [r.dense.tolist() for r in E5Embedder(EmbeddingConfig(
            backend="multilingual-e5", model="test", checkpoint_path=ckpt),
            "cpu").embed(TEXTS)]
    if kind == "reranker":
        return [r.score for r in BGEReranker(RerankingConfig(
            model="eval-small", checkpoint_path=ckpt), "cpu").rerank(
            QUERY, [RetrievalResult(t, 0.5) for t in TEXTS * 3], top_k=3)]
    if kind == "llm":
        gen = LLMGenerator(GenerationConfig(
            model="eval-small", temperature=0.0, max_tokens=6,
            checkpoint_path=ckpt), "cpu")
        gen.generate_batch(PROMPTS)
        return gen.last_token_ids
    if kind == "nli":
        return NLIScorer(checkpoint_path=ckpt, device="cpu").probs(
            TEXTS[:2], PROMPTS).tolist()
    d = create_diarizer(DiarizationConfig(checkpoint_path=ckpt,
                                          vad_backend="energy"), "cpu")
    d.load()
    return [d.source, _segs(d.diarize(np.concatenate(
        [_speech(2.5), 0.3 * _speech(2.5)[::-1]]), SR))]


@pytest.mark.parametrize("kind", ["whisper", "bgem3", "e5", "reranker",
                                  "llm", "nli", "speaker"])
def test_missing_checkpoint_falls_back_as_jax(kind, tmp_path):
    """A ``checkpoint_path`` without the model's file: what the backend
    loads without one (the committed asset, or seeded weights), as the
    JAX backends fall back (Whisper and the speaker encoder with a
    warning)."""
    assert _outputs(kind, str(tmp_path)) == _outputs(kind, None)


# -- tokenizer files ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["whisper", "bgem3", "e5", "reranker",
                                  "llm", "nli"])
@pytest.mark.parametrize("name", ["tokenizer.json", "vocab.txt",
                                  "sentencepiece.bpe.model"])
def test_tokenizer_files_are_refused(ckpts, kind, name, tmp_path):
    """The JAX backends tokenize (or decode) with a checkpoint
    directory's HuggingFace tokenizer files through ``transformers``; the
    port cannot read them yet and raises ``ConfigError`` instead of
    tokenizing otherwise."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.embeddings.e5 import E5Embedder
    from audio_rag_tpu_torch.evaluation.nli import NLIScorer
    from audio_rag_tpu_torch.generation.llm import LLMGenerator
    from audio_rag_tpu_torch.reranking.bge import BGEReranker

    (tmp_path / name).write_text("{}")
    ckpt = str(tmp_path)
    make = {
        "whisper": lambda: WhisperASR(ASRConfig(
            model_size="test", checkpoint_path=ckpt), "cpu").load(),
        "bgem3": lambda: BGEM3Embedder(EmbeddingConfig(
            model="test", checkpoint_path=ckpt), "cpu"),
        "e5": lambda: E5Embedder(EmbeddingConfig(
            backend="multilingual-e5", model="test", checkpoint_path=ckpt),
            "cpu"),
        "reranker": lambda: BGEReranker(RerankingConfig(
            model="test", checkpoint_path=ckpt), "cpu"),
        "llm": lambda: LLMGenerator(GenerationConfig(
            model="test", checkpoint_path=ckpt), "cpu").load(),
        "nli": lambda: NLIScorer(checkpoint_path=ckpt, device="cpu"),
    }[kind]
    with pytest.raises(ConfigError, match="tokenizer files"):
        make()


# -- backends used before load() ----------------------------------------------

@pytest.mark.parametrize("kind", ["whisper", "reranker", "embedder",
                                  "diarizer"])
def test_port_loads_where_jax_raises_model_not_loaded(kind):
    """A deliberate departure: the JAX backends raise
    ``ModelNotLoadedError`` when used before ``load()``
    (``core/base.py::require_loaded``); the port's load themselves (since
    device-memory budgeting, an evicted backend reloads on its next use,
    and ``LLMGenerator.resident`` relies on it)."""
    from audio_rag_tpu.asr.whisper_jax import WhisperJaxASR
    from audio_rag_tpu.core.types import RetrievalResult as JaxResult
    from audio_rag_tpu.diarization.clustering import (
        ClusteringDiarizer as JaxDiarizer,
    )
    from audio_rag_tpu.embeddings.bge import BGEM3Embedder as JaxEmbedder
    from audio_rag_tpu.reranking.bge import BGEReranker as JaxReranker
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.diarization import create_diarizer
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.reranking.bge import BGEReranker

    wav = _speech(2.0)
    hits = [RetrievalResult(t, 0.5) for t in TEXTS * 3]
    jhits = [JaxResult(t, 0.5) for t in TEXTS * 3]
    jax_use, port_backend, port_use = {
        "whisper": (lambda: WhisperJaxASR(JaxASRConfig(
            model_size="test")).transcribe(wav, SR),
            WhisperASR(ASRConfig(model_size="test", vad_filter=False,
                                 temperature_fallback=False), "cpu"),
            lambda b: b.transcribe(wav, SR)),
        "reranker": (lambda: JaxReranker(JaxRerankingConfig(
            model="test")).rerank(QUERY, jhits, top_k=3),
            BGEReranker(RerankingConfig(model="test"), "cpu"),
            lambda b: b.rerank(QUERY, hits, top_k=3)),
        "embedder": (lambda: JaxEmbedder(JaxEmbeddingConfig(
            model="test")).embed(TEXTS),
            BGEM3Embedder(EmbeddingConfig(model="test"), "cpu"),
            lambda b: b.embed(TEXTS)),
        "diarizer": (lambda: JaxDiarizer(JaxDiarizationConfig(
            model="test")).diarize(wav, SR),
            create_diarizer(DiarizationConfig(model="test"), "cpu"),
            lambda b: b.diarize(wav, SR)),
    }[kind]
    with pytest.raises(ModelNotLoadedError, match="before load"):
        jax_use()
    assert not port_backend.is_loaded
    port_use(port_backend)
    assert port_backend.is_loaded
