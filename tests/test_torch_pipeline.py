"""The port's pipeline entry points against the JAX package's: the JAX
end-to-end scenarios (``tests/integration/test_pipeline_e2e.py``) on the
fake backends through both packages, ``ingest_batch`` against the per-file
loop, checkpoints and resume, ``status``, the serializers, the fixed and
semantic chunkers, PRF expansion, the E5 embedder, the positional
``ingest`` of the JAX argument order, and one trained case (tiny-synth +
eval-small, extractive headers)."""

import dataclasses
import logging
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.chunking.fixed import FixedSizeChunker as JaxFixed
from audio_rag_tpu.chunking.semantic import SemanticChunker as JaxSemantic
from audio_rag_tpu.config import loader as jloader
from audio_rag_tpu.config.schema import ChunkingConfig as JaxChunkingConfig
from audio_rag_tpu.config.schema import EmbeddingConfig as JaxEmbConfig
from audio_rag_tpu.core import types as jtypes
from audio_rag_tpu.embeddings.e5 import E5Embedder as JaxE5
from audio_rag_tpu.embeddings.fake import FakeEmbedder as JaxFakeEmbedder
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu.utils import decorators as jdecorators
from audio_rag_tpu.utils import tracing as jtracing
from audio_rag_tpu_torch.chunking import FixedSizeChunker, SemanticChunker
from audio_rag_tpu_torch.config import (
    ChunkingConfig,
    EmbeddingConfig,
    load_config,
)
from audio_rag_tpu_torch.core import types as ttypes
from audio_rag_tpu_torch.embeddings.e5 import E5Embedder
from audio_rag_tpu_torch.embeddings.fake import FakeEmbedder
from audio_rag_tpu_torch.pipeline import AudioRAG
from audio_rag_tpu_torch.utils import decorators as tdecorators
from audio_rag_tpu_torch.utils import tracing as ttracing
from audio_rag_tpu_torch.weights import e5_params
from torch_ledger_common import fresh_ledger  # noqa: F401
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import QUERIES, _jax_rag, _port_rag, _turn_audio

ROOT = Path(__file__).resolve().parents[1]
NOWHERE = ROOT / "configs" / "no-such-dir"  # no base.yaml: defaults only

#: the JAX end-to-end test's ``fake_config`` (and the port's CPU)
FAKE = {
    "asr": {"backend": "fake"},
    "diarization": {"backend": "fake"},
    "embedding": {"backend": "fake"},
    "retrieval": {"backend": "tpu", "capacity_step": 128},
    "reranking": {"backend": "fake"},
    "generation": {"backend": "fake"},
    "expansion": {"backend": "none"},
    "tts": {"backend": "null"},
    "device": "cpu",
}
#: the JAX package's class names of timed stages the port names otherwise
TIMED_NAMES = {"TPUVectorStore": "VectorStore", "WhisperJaxASR": "WhisperASR"}


def _configs(**sections):
    """The same mapping through both packages' ``load_config``."""
    data = {k: dict(v) if isinstance(v, dict) else v for k, v in FAKE.items()}
    for k, v in sections.items():
        data.setdefault(k, {}).update(v)
    return (load_config(configs_dir=NOWHERE, overrides=data),
            jloader.load_config(configs_dir=NOWHERE, overrides=data))


def _rags(**sections):
    port_cfg, jax_cfg = _configs(**sections)
    return AudioRAG(port_cfg), JaxAudioRAG(jax_cfg)


def _stored(store, collection="audio_rag"):
    """A collection's chunks, without their random ids."""
    coll = store._coll(collection)
    return [(p["text"], p["speaker"], round(float(p["start"]), 3),
             round(float(p["end"]), 3), p["metadata"])
            for p in (coll.payloads if coll is not None else [])]


def _hits(results):
    return [(r.text, r.speaker, round(r.start, 3), round(r.end, 3))
            for r in results]


def _assert_same_query(got, ref):
    assert _hits(got.results) == _hits(ref.results)
    for g, r in zip(got.results, ref.results):
        assert abs(g.score - r.score) <= 1e-5
        assert g.metadata == r.metadata
    assert got.response == ref.response
    assert got.answer == ref.answer
    assert got.expanded_query == ref.expanded_query


def _assert_same_result(got, ref):
    a, b = got.to_dict(), ref.to_dict()
    assert set(a) == set(b)
    for key in ("source", "collection", "num_segments", "num_chunks",
                "num_speakers", "duration_s"):
        assert a[key] == b[key], key
    assert set(a["stage_timings"]) == set(b["stage_timings"])


@pytest.fixture
def wav_file(tmp_path):
    sr = 16000
    rng = np.random.default_rng(0)
    audio = 0.1 * rng.standard_normal(sr * 20).astype(np.float32)
    p = tmp_path / "talk.wav"
    write_wav(p, audio, sr)
    return str(p)


@pytest.fixture
def rags():
    port, ref = _rags()
    yield port, ref
    ref.unload_all()


# -- the JAX end-to-end scenarios on fake backends ---------------------------------

@pytest.mark.parametrize("diarize", [True, False])
def test_ingest_matches_jax(rags, wav_file, diarize):
    port, ref = rags
    meta = {"course": "cs229"}
    got = port.ingest(wav_file, diarize=diarize, metadata=meta)
    want = ref.ingest(wav_file, diarize=diarize, metadata=meta)
    _assert_same_result(got, want)
    assert got.num_chunks > 0 and got.duration_s == pytest.approx(20.0,
                                                                   abs=0.5)
    assert (got.num_speakers >= 1) == diarize
    assert _stored(port.store) == _stored(ref._retriever)
    assert port.count() == got.num_chunks


@pytest.mark.parametrize("search_type", ["dense", "sparse", "hybrid"])
@pytest.mark.parametrize("rerank", [False, True])
def test_queries_match_jax(rags, wav_file, search_type, rerank):
    port, ref = rags
    for rag in (port, ref):
        rag.ingest(wav_file, metadata={"course": "cs229"})
    for q in ("word0 word1 word2", "word5 word6", "word0"):
        kw = {"search_type": search_type, "rerank": rerank, "top_k": 2}
        got, want = port.query(q, **kw), ref.query(q, **kw)
        _assert_same_query(got, want)
        assert got.results and len(got.results) <= 2
        assert set(got.stage_timings) == set(want.stage_timings)
    out = port.query("word0 word1", search_type="dense", rerank=False)
    assert out.results[0].metadata == {"course": "cs229",
                                       "source": wav_file}


def test_answer_context_and_batch_match_jax(rags, wav_file):
    port, ref = rags
    for rag in (port, ref):
        rag.ingest(wav_file)
    _assert_same_query(port.query("word0", generate_answer=True),
                       ref.query("word0", generate_answer=True))
    assert "fake answer" in port.query("word0", generate_answer=True).answer
    assert port.get_context("word0") == ref.get_context("word0")
    for g, r in zip(port.query_batch(["word0", "word7 word8"]),
                    ref.query_batch(["word0", "word7 word8"])):
        _assert_same_query(g, r)
    # the spoken answer: the null backend's WAV, byte for byte the JAX
    # pipeline's
    got = port.query("word0", generate_answer=True, speak_answer=True)
    want = ref.query("word0", generate_answer=True, speak_answer=True)
    _assert_same_query(got, want)
    assert got.audio is not None and got.audio == want.audio
    assert set(got.stage_timings) == set(want.stage_timings)
    assert "tts" in got.stage_timings


def test_status_and_clear_collection_match_jax(rags, wav_file):
    port, ref = rags
    for mod in (tdecorators, jdecorators):
        mod.reset_stage_timings()
    for mod in (ttracing, jtracing):
        mod.reset_traces()
    for rag in (port, ref):
        rag.ingest(wav_file)
        rag.ingest(wav_file, collection="other", diarize=False)
        rag.query("word0", rerank=False)
    got, want = port.status(), ref.status()
    assert set(got) == set(want) == {"config", "engine", "resources",
                                     "collections", "stage_timings",
                                     "traces"}
    assert got["config"] == want["config"]
    assert got["config"]["asr"] == "fake"
    assert got["collections"] == want["collections"]
    assert got["collections"]["audio_rag"] > 0
    assert set(got["stage_timings"]) == {
        ".".join([TIMED_NAMES.get(n.split(".")[0], n.split(".")[0]),
                  *n.split(".")[1:]]) for n in want["stage_timings"]}
    assert got["stage_timings"]["IngestionPipeline.ingest"]["count"] == 2
    assert set(got["traces"]) == set(want["traces"])
    assert {k: v["count"] for k, v in got["traces"].items()} == {
        k: v["count"] for k, v in want["traces"].items()}
    assert got["engine"]["device"]["type"] == "cpu"
    assert got["engine"]["models"] == want["engine"]["models"] == {}
    assert got["resources"]["budget_gb"] == 14.0
    assert got["resources"] == {k: v for k, v in want["resources"].items()
                                if k != "device"}
    for rag, store in ((port, port.store), (ref, ref._retriever)):
        assert rag.clear_collection()
        assert store.count() == 0
        assert not rag.clear_collection()


def test_spans_nest_per_thread_and_profile_to_a_trace(tmp_path):
    """Spans nest and aggregate per thread (each thread its own stack),
    and a profile started around them writes a Chrome trace that names
    them."""
    ttracing.reset_traces()
    assert ttracing.start_profile(tmp_path)
    assert not ttracing.start_profile(tmp_path)

    def work():
        with ttracing.span("outer"):
            with ttracing.span("inner"):
                torch.ones(4).sum()

    worker = threading.Thread(target=work)
    worker.start()
    work()
    worker.join()
    path = ttracing.stop_profile()
    assert ttracing.stop_profile() is None
    assert path.is_file() and '"outer"' in path.read_text()
    outer = ttracing.get_trace_summary()["outer"]
    assert outer["count"] == 2 and set(outer["children"]) == {"inner"}
    assert outer["children"]["inner"]["count"] == 2


def test_contextual_headers_match_jax(wav_file):
    port, ref = _rags(contextual={"enabled": True})
    try:
        for rag in (port, ref):
            rag.ingest(wav_file)
        assert _stored(port.store) == _stored(ref._retriever)
        out = port.query("word0", rerank=False)
        assert any(r.text.startswith("[Context:") for r in out.results)
        headed = [r for r in out.results if r.metadata.get("contextualized")]
        assert headed and "original_text" in headed[0].metadata
        _assert_same_query(out, ref.query("word0", rerank=False))
    finally:
        ref.unload_all()


@pytest.mark.parametrize("contextual", [True, False])
def test_staged_batch_matches_the_per_file_loop(wav_file, tmp_path,
                                                contextual):
    """Stage-grouped ``ingest_batch`` (headers on) and the per-file loop
    (headers off) store what the per-file ``ingest`` loop stores, in both
    packages, and the same as each other; per-file ``metadatas`` land on
    top of ``metadata``."""
    wav2 = str(tmp_path / "two.wav")
    shutil.copy(wav_file, wav2)
    files = [wav_file, wav2]
    port, ref = _rags(contextual={"enabled": contextual})
    try:
        kw = {"metadatas": [{"tenant": "a"}, None],
              "metadata": {"course": "x", "tenant": "z"}}
        got = port.ingest_batch(files, collection="staged", **kw)
        want = ref.ingest_batch(files, collection="staged", **kw)
        for g, w in zip(got, want):
            _assert_same_result(g, w)
        for rag in (port, ref):
            for f, m in zip(files, kw["metadatas"]):
                rag.ingest(f, collection="perfile",
                           metadata={**kw["metadata"], **(m or {})})
        staged = _stored(port.store, "staged")
        assert staged == _stored(port.store, "perfile")
        assert staged == _stored(ref._retriever, "staged")
        assert {c[4]["tenant"] for c in staged} == {"a", "z"}
        if contextual:
            assert "contextualize" in got[0].stage_timings
            assert any(c[0].startswith("[Context:") for c in staged)
    finally:
        ref.unload_all()


def test_ingest_segments_and_results_match_jax(rags):
    port, ref = rags
    segs = [("alpha beta gamma delta", 0.0, 2.0, "SPEAKER_00"),
            ("epsilon zeta eta theta", 2.0, 4.5, "SPEAKER_01")]
    got = port.ingestion.ingest_segments(
        [ttypes.TranscriptSegment(t, s, e, sp) for t, s, e, sp in segs],
        metadata={"k": 1})
    want = ref.ingestion.ingest_segments(
        [jtypes.TranscriptSegment(t, s, e, sp) for t, s, e, sp in segs],
        metadata={"k": 1})
    _assert_same_result(got, want)
    assert _stored(port.store) == _stored(ref._retriever)


# -- checkpoints and resume ---------------------------------------------------------

@pytest.mark.parametrize("contextual", [False, True])
def test_resume_from_each_stage_skips_it(wav_file, contextual):
    """Checkpoints fire as in the JAX package ("aligned" also without
    diarization); resuming from each skips the finished stages (the ASR,
    then the chunker, raise if called), keeps the checkpoint's chunk ids,
    and stores what the first run stored."""
    port, ref = _rags(contextual={"enabled": contextual})
    try:
        seen, jax_seen = {}, {}
        port.ingestion.ingest(wav_file, collection="first", diarize=False,
                              checkpoint_cb=lambda s, d: seen.__setitem__(
                                  s, d))
        ref.ingestion.ingest(wav_file, collection="first", diarize=False,
                             checkpoint_cb=lambda s, d: jax_seen.__setitem__(
                                 s, d))
        last = "contextualized" if contextual else "chunked"
        assert list(seen) == list(jax_seen) == ["aligned", last]
        assert seen["aligned"] == jax_seen["aligned"]
        first = _stored(port.store, "first")

        def boom(*a, **k):
            raise AssertionError("a finished stage ran again")

        port.ingestion.asr.transcribe_with_words = boom
        for stage in ("aligned", last):
            res = port.ingestion.ingest(
                wav_file, collection=stage, diarize=False,
                resume={"stage": stage, **seen[stage]})
            assert _stored(port.store, stage) == first
            assert "transcribe" not in res.stage_timings
            if stage == last:
                assert "chunk" not in res.stage_timings
                assert [p["id"] for p in port.store._coll(stage).payloads] \
                    == [c["chunk_id"] for c in seen[stage]["chunks"]]
            jres = ref.ingestion.ingest(
                wav_file, collection=stage, diarize=False,
                resume={"stage": stage, **jax_seen[stage]})
            _assert_same_result(res, jres)
            assert _stored(ref._retriever, stage) == _stored(
                ref._retriever, "first")
    finally:
        ref.unload_all()


def test_failing_checkpoint_is_logged_and_progress_matches_jax(
        rags, wav_file, caplog):
    port, ref = rags
    steps, jax_steps = [], []
    port.ingestion.progress_callback = lambda s, f: steps.append((s, f))
    ref.ingestion.progress_callback = lambda s, f: jax_steps.append((s, f))

    def failing(stage, data):
        raise OSError("disk full")

    with caplog.at_level(logging.WARNING):
        res = port.ingestion.ingest(wav_file, checkpoint_cb=failing)
    ref.ingestion.ingest(wav_file, checkpoint_cb=failing)
    assert res.num_chunks == port.count() > 0
    assert sum("checkpoint" in r.getMessage() and "disk full" in
               r.getMessage() for r in caplog.records
               if r.name.startswith("audio_rag_tpu_torch")) == 2
    assert steps == jax_steps and steps[-1] == ("done", 1.0)


# -- serializers ------------------------------------------------------------------------

def test_serializers_round_trip_as_jax():
    word = ("w", 0.5, 0.75, 0.9, "SPEAKER_01")
    seg = dict(text="a w", start=0.0, end=1.0, speaker="SPEAKER_01",
               language="en", avg_logprob=-0.2)
    chunk = dict(text="a w", start=0.0, end=1.0, speaker=None,
                 chunk_id="c-1", metadata={"source": "x", "n": [1, 2]})
    for mod_a, mod_b in ((ttypes, jtypes), (jtypes, ttypes)):
        w = mod_a.Word(*word)
        s = mod_a.TranscriptSegment(**seg, words=[w])
        c = mod_a.AudioChunk(**chunk)
        r = mod_a.RetrievalResult(text="a", score=0.5, start=1.0, end=2.0,
                                  speaker="S", chunk_id="c-2",
                                  metadata={"k": "v"})
        for obj, cls in ((w, "Word"), (s, "TranscriptSegment"),
                         (c, "AudioChunk"), (r, "RetrievalResult")):
            d = obj.to_dict()
            other = getattr(mod_b, cls).from_dict(d)
            assert other.to_dict() == d
            assert getattr(mod_a, cls).from_dict(d) == obj
    sv = {7: 0.5, 3: 1.25}
    assert ttypes.SparseVector.from_dict(sv).to_dict() == \
        jtypes.SparseVector.from_dict(sv).to_dict() == {3: 1.25, 7: 0.5}


# -- chunkers, PRF, E5 ------------------------------------------------------------------

def _segments(mod, with_words: bool):
    rng = np.random.default_rng(3)
    topics = [("gradient descent loss spectrogram harmonic attention "
               "token layer").split(),
              "river valley mountain forest glacier meadow".split()]
    out, t = [], 0.0
    for i in range(14):
        vocab = topics[(i // 4) % 2]  # the topic changes every 4 segments
        words = list(rng.choice(vocab, int(rng.integers(3, 12))))
        dur = 0.4 * len(words)
        ws = ([mod.Word(w, round(t + 0.4 * k, 3), round(t + 0.4 * k + 0.3,
                                                         3),
                        speaker=f"SPEAKER_0{i % 2}")
               for k, w in enumerate(words)] if with_words else [])
        out.append(mod.TranscriptSegment(" ".join(words), round(t, 3),
                                         round(t + dur, 3),
                                         speaker=f"SPEAKER_0{i % 2}",
                                         words=ws))
        t += dur + 0.2
    return out


def _chunk_rows(chunks):
    return [(c.text, c.start, c.end, c.speaker) for c in chunks]


@pytest.mark.parametrize("with_words", [True, False])
@pytest.mark.parametrize("sizes", [(50, 10, 1), (60, 0, 30), (80, 20, 5)])
def test_fixed_and_semantic_chunks_match_jax(with_words, sizes):
    max_tokens, overlap, min_chunk = sizes
    kw = dict(max_tokens=max_tokens, overlap_tokens=overlap,
              min_chunk_tokens=min_chunk)
    for port_cls, jax_cls in ((FixedSizeChunker, JaxFixed),
                              (SemanticChunker, JaxSemantic)):
        got = port_cls(ChunkingConfig(**kw)).chunk(
            _segments(ttypes, with_words))
        want = jax_cls(JaxChunkingConfig(**kw)).chunk(
            _segments(jtypes, with_words))
        assert _chunk_rows(got) == _chunk_rows(want)
        assert len(got) > 1


def test_fake_embedder_is_bit_exact():
    texts = ["gradient descent loss", "", "the the THE", "naïve café 42"]
    got = FakeEmbedder(EmbeddingConfig(backend="fake")).embed(texts)
    want = JaxFakeEmbedder(JaxEmbConfig(backend="fake")).embed(texts)
    for g, w in zip(got, want):
        assert g.dense.dtype == w.dense.dtype == np.float32
        assert np.array_equal(g.dense, w.dense)
        assert g.sparse.to_dict() == w.sparse.to_dict()


PRF_DOCS = (
    ["quantum tunnelling barrier electron wavefunction decay"] * 2
    + ["quantum barrier electron spin resonance tunnelling"]
    + [f"common filler topic {i} lecture notes words" for i in range(21)])


def test_prf_expansion_matches_jax():
    """PRF in both pipelines on the same corpus (the default collection):
    the same appended terms, and the same expanded query's results."""
    port, ref = _rags(expansion={"backend": "prf", "prf_terms": 3},
                      chunking={"min_chunk_tokens": 1, "overlap_tokens": 0})
    try:
        for rag, mod in ((port, ttypes), (ref, jtypes)):
            rag.ingestion.ingest_segments([  # one chunk a segment
                mod.TranscriptSegment(t, float(i), float(i) + 1.0,
                                      speaker=f"SPEAKER_0{i % 2}")
                for i, t in enumerate(PRF_DOCS)])
        assert port.store.term_stats() == ref._retriever.term_stats()
        for q in ("quantum tunnelling", "electron spin", "lecture notes"):
            got, want = port.query(q, rerank=False), ref.query(
                q, rerank=False)
            _assert_same_query(got, want)
        assert port.query("quantum tunnelling",
                          rerank=False).expanded_query != "quantum tunnelling"
    finally:
        ref.unload_all()


def test_e5_vectors_match_jax():
    """E5 at the ``test`` preset on the JAX embedder's weights: prefixes,
    mean pooling and norms as the JAX embedder's (bf16: the tolerance of
    the BGE-M3 dense vectors' test)."""
    texts = ["gradient descent minimizes the loss function",
             "the spectrogram shows harmonic structure", "short",
             " ".join(f"tok{i}" for i in range(40))]
    jax_emb = JaxE5(JaxEmbConfig(backend="multilingual-e5", model="test"))
    jax_emb.load()
    try:
        ref = jax_emb.embed(texts) + [jax_emb.embed_query(texts[0])]
        tree = jax_emb._params
    finally:
        jax_emb.unload()
    port = E5Embedder(EmbeddingConfig(backend="multilingual-e5",
                                      model="test"), device="cpu")
    port._params = e5_params(tree, port.dims, "cpu", torch.bfloat16)
    got = port.embed(texts) + [port.embed_query(texts[0])]
    for g, r in zip(got, ref):
        assert g.sparse is None and g.text == r.text
        assert abs(float(np.linalg.norm(g.dense)) - 1.0) < 1e-5
        cos = float(np.dot(r.dense, g.dense) / (
            np.linalg.norm(r.dense) * np.linalg.norm(g.dense)))
        assert cos >= 0.9999, (g.text, cos)
    # the query prefix moves the vector
    assert float(np.dot(got[0].dense, got[-1].dense)) < 0.9999


def test_config_backends_build_their_components():
    """Each backend name of the config builds the component the JAX
    registries map it to."""
    port_cfg, _ = _configs(asr={"backend": "streaming-whisper",
                                "model_size": "test"},
                           chunking={"strategy": "semantic"},
                           embedding={"backend": "multilingual-e5",
                                      "model": "test"})
    rag = AudioRAG(port_cfg)
    assert type(rag.ingestion._asr or rag.ingestion.asr).__name__ == \
        "WhisperASR"
    assert type(rag.ingestion.chunker).__name__ == "SemanticChunker"
    assert type(rag.embedder).__name__ == "E5Embedder"
    assert rag.query_engine is None  # only BGE-M3 has the batched engine
    assert type(rag.diarizer).__name__ == "FakeDiarizer"
    rag.unload_all()
    assert rag.status()["engine"]["models"] == {}


def test_from_config_reads_a_profile_file(tmp_path, monkeypatch, wav_file):
    path = tmp_path / "fake.yaml"
    path.write_text("asr:\n  backend: fake\ndiarization:\n  backend: fake\n"
                    "embedding:\n  backend: fake\nreranking:\n"
                    "  backend: fake\ngeneration:\n  backend: fake\n"
                    "retrieval:\n  capacity_step: 128\n")
    monkeypatch.setenv("AUDIO_RAG__DEVICE", "cpu")
    rag = AudioRAG.from_config(path, configs_dir=ROOT / "configs")
    assert rag.device == torch.device("cpu")
    assert rag.config.asr.window_batch_size == 16  # base.yaml's
    assert rag.ingest(wav_file).num_chunks == rag.count() > 0


# -- the JAX argument order and the trained case ------------------------------------------

@pytest.fixture(scope="module")
def trained_rags():
    from audio_rag_tpu_torch.checkpoint import ASSETS_DIR

    if not (ASSETS_DIR / "asr_tiny_synth.npz").exists():
        pytest.skip("trained ASR asset not built")
    jax_rag, port = _jax_rag({}), _port_rag({})
    yield jax_rag, port
    jax_rag.unload_all()


def test_positional_ingest_takes_the_jax_order(trained_rags, tmp_path):
    """``ingest(audio, sample_rate)`` and ``ingest(path, sample_rate)``
    as written for the JAX package: the sample rate is the second
    argument (ROADMAP §3 fault 12), the chunks go to the default
    collection, and they are the JAX package's."""
    jax_rag, port = trained_rags
    audio = _turn_audio()
    path = tmp_path / "turns.wav"
    write_wav(path, audio, SR)
    port.delete_collection()
    jax_rag._retriever.delete_collection()
    for rag in (jax_rag, port):
        rag.ingest(audio, 16000)
    got = port.store._coll("audio_rag").payloads
    want = jax_rag._retriever._coll("audio_rag").payloads
    assert [(p["text"], p["speaker"]) for p in got] == [
        (p["text"], p["speaker"]) for p in want]
    assert port.count() == len(want) > 0
    n = port.count()
    res = port.ingest(str(path), 44100)
    assert res.collection == "audio_rag" and port.count() == 2 * n
    assert port.count("44100") == 0
    assert not port.store.collection_exists("44100")


#: two spoken files; a turn that repeats its words gives its neighbours
#: an extractive header (a term must occur twice in the window)
BATCH_TURNS = [["gradient descent gradient descent",
                "the spectrogram shows harmonic structure",
                "attention layers mix token information"],
               ["window audio window audio", "speech chunk query vector"]]


def _spoken(turns, seed):
    """Each turn 0.3 s into a 6 s window of its own (tiny-synth's)."""
    from audio_rag_tpu.audio.charvoice import synth_text

    rng = np.random.default_rng(seed)
    win, lead = 6 * SR, int(0.3 * SR)
    out = np.zeros(len(turns) * win, np.float32)
    for i, text in enumerate(turns):
        wav = synth_text(text, rng, noise_level=0.005)
        out[i * win + lead: i * win + lead + wav.size] = wav
    return out


def test_trained_staged_batch_matches_jax(trained_rags, tmp_path):
    """Two spoken files through ``ingest_batch`` with extractive headers
    (stage-grouped) in both packages: the same headed chunks, and the
    same top hits for both spine queries."""
    jax_rag, port = trained_rags
    files = []
    for i, turns in enumerate(BATCH_TURNS):
        files.append(str(tmp_path / f"part{i}.wav"))
        write_wav(files[-1], _spoken(turns, 11 + i), SR)
    saved = port.config.contextual, jax_rag.config.contextual
    port.config.contextual = dataclasses.replace(
        port.config.contextual, enabled=True, backend="extractive")
    jax_rag.config.contextual = jax_rag.config.contextual.model_copy(
        update={"enabled": True, "backend": "extractive"})
    port.ingestion._contextual = jax_rag.ingestion._contextual = None
    try:
        got = port.ingest_batch(files, collection="batch", diarize=False)
        want = jax_rag.ingest_batch(files, collection="batch",
                                    diarize=False)
    finally:
        port.config.contextual, jax_rag.config.contextual = saved
        port.ingestion._contextual = jax_rag.ingestion._contextual = None
    for g, w in zip(got, want):
        _assert_same_result(g, w)
        assert "contextualize" in g.stage_timings
    rows = _stored(port.store, "batch")
    assert rows == _stored(jax_rag._retriever, "batch")
    assert any(r[0].startswith("[Context:") for r in rows), rows
    for q in QUERIES:
        assert [r.text for r in port.query(q, collection="batch",
                                           top_k=2).results] == [
            r.text for r in jax_rag.query(q, collection="batch",
                                          top_k=2).results]
