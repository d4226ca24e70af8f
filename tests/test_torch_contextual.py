"""The PyTorch port's contextual chunk headers against the JAX package's,
on the CPU: ``extractive_headers`` and both backends of
``ContextualProcessor.process_chunks`` (the LLM's headers from the
committed trained generator, ``llm_small.npz``), and ``AudioRAG.ingest``
with ``contextual.enabled`` on the tiny-synth spine — the JAX pipeline's
chunk texts (``[Context: ...]`` headers, the original text in the
metadata) and top hits, and a ``contextualize`` stage time — with each
backend. Sampled headers are held as the generation tests hold answers
(``test_torch_generation._follow_calls``: after a near-tie, the JAX
pipeline is replayed on the port's generations). The deliberate
departures: a failing generator raises (the JAX processor writes no
header), with no retry after running out of device memory."""

import pytest

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import ContextualConfig as JaxCtxConfig
from audio_rag_tpu.config.schema import GenerationConfig as JaxGenConfig
from audio_rag_tpu.contextual.processor import (
    ContextualProcessor as JaxProcessor,
)
from audio_rag_tpu.contextual.processor import (
    extractive_headers as jax_extractive,
)
from audio_rag_tpu.core.types import AudioChunk as JaxChunk
from audio_rag_tpu.generation.llm_jax import LLMGenerator as JaxLLM
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import ContextualConfig, GenerationConfig
from audio_rag_tpu_torch.contextual import (
    CONTEXT_PROMPT,
    ContextualProcessor,
    extractive_headers,
)
from audio_rag_tpu_torch.contextual import processor as proc_module
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import AudioChunk
from audio_rag_tpu_torch.generation.fake import FakeGenerator
from audio_rag_tpu_torch.generation.llm import LLMGenerator
from test_torch_generation import _Calls, _follow_calls, _replayed
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import QUERIES, _jax_rag, _port_rag, _turn_audio

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "llm_small.npz").exists(),
    reason="trained LLM asset not built")

#: a lecture's chunks: neighbours name what a chunk only refers to
LECTURE = [
    "gradient descent updates the weights. gradient descent needs a step",
    "it converges quadratically near the optimum when it is convex",
    "newton method uses curvature. newton method needs the hessian",
    "the spectrogram shows harmonic structure in the audio",
    "attention layers mix token information across the sequence",
    "attention heads weigh tokens; attention scales with length squared",
    "it is the transformer's core. it replaced recurrence",
]
GEN_KW = {"model": "eval-small", "max_tokens": 48, "use_scheduler": False}


def _chunks(cls, texts):
    return [cls(t, 10.0 * i, 10.0 * i + 10, speaker=f"SPEAKER_0{i % 2}",
                chunk_id=f"c{i}", metadata={"source": "lecture"})
            for i, t in enumerate(texts)]


def _as_tuples(chunks):
    return [(c.text, c.start, c.end, c.speaker, c.chunk_id,
             dict(c.metadata)) for c in chunks]


@pytest.mark.parametrize("window,terms", [(1, 4), (2, 2), (0, 4)])
def test_extractive_headers_match_jax(window, terms):
    """The same headers (or none) and the same headed chunks."""
    got = extractive_headers(_chunks(AudioChunk, LECTURE), window, terms)
    ref = jax_extractive(_chunks(JaxChunk, LECTURE), window, terms)
    assert got == ref and any(got) == (window > 0)
    cfg = {"enabled": True, "backend": "extractive", "window_size": window,
           "extractive_terms": terms}
    out = ContextualProcessor(ContextualConfig(**cfg)).process_chunks(
        _chunks(AudioChunk, LECTURE))
    want = JaxProcessor(JaxCtxConfig(**cfg)).process_chunks(
        _chunks(JaxChunk, LECTURE))
    assert _as_tuples(out) == _as_tuples(want)


@pytest.fixture(scope="module")
def gens():
    jax_gen = JaxLLM(JaxGenConfig(backend="llm-jax", **GEN_KW))
    jax_gen.load()
    gen = LLMGenerator(GenerationConfig(**GEN_KW), device="cpu")
    gen.load()
    yield jax_gen, gen
    jax_gen.unload()
    gen.unload()


def test_llm_headers_match_jax(gens):
    """Seven chunks (one batch of 16 prompts at most, 96 tokens at 0.3):
    the JAX processor's prompts, headers and headed chunks, the original
    text kept in the metadata."""
    jax_gen, gen = gens
    ref_calls, got_calls = _Calls(jax_gen), _Calls(gen)
    cfg = {"enabled": True, "backend": "llm", "window_size": 1}
    try:
        want = JaxProcessor(JaxCtxConfig(**cfg), jax_gen).process_chunks(
            _chunks(JaxChunk, LECTURE))
        out = ContextualProcessor(ContextualConfig(**cfg),
                                  gen).process_chunks(
            _chunks(AudioChunk, LECTURE))
    finally:
        ref_calls.close()
        got_calls.close()
    assert got_calls.seen[0][1] == {"max_tokens": 96, "temperature": 0.3}
    if not _follow_calls(jax_gen, ref_calls, got_calls):
        want = _replayed(jax_gen, got_calls, 0, lambda: JaxProcessor(
            JaxCtxConfig(**cfg), jax_gen).process_chunks(
            _chunks(JaxChunk, LECTURE)))
    assert _as_tuples(out) == _as_tuples(want)
    headed = [c for c in out if c.metadata.get("contextualized")]
    assert headed and all(
        c.text.startswith("[Context: ") and c.text.endswith(
            "]\n" + c.metadata["original_text"]) for c in headed)
    prompt = got_calls.seen[0][0][1]
    assert prompt.startswith(CONTEXT_PROMPT[:40]) and LECTURE[0] in prompt


def test_disabled_absent_and_batchless_generators():
    """Disabled, or the llm backend without a generator: the chunks as
    they are; a generator without ``generate_batch`` writes one header a
    chunk, as the JAX processor asks it."""
    chunks = _chunks(AudioChunk, LECTURE[:2])
    assert ContextualProcessor(ContextualConfig()).process_chunks(
        chunks) is chunks
    assert ContextualProcessor(ContextualConfig(enabled=True)).process_chunks(
        chunks) is chunks
    out = ContextualProcessor(ContextualConfig(enabled=True),
                              FakeGenerator()).process_chunks(chunks)
    want = JaxProcessor(JaxCtxConfig(enabled=True), FakeGenerator()
                        ).process_chunks(_chunks(JaxChunk, LECTURE[:2]))
    assert _as_tuples(out) == _as_tuples(want)
    with pytest.raises(ConfigError):
        ContextualConfig(backend="ollama")
    with pytest.raises(ConfigError):
        ContextualConfig(window_size=4)


class _Failing:
    """A generator whose batches fail as a device out of memory does."""

    is_loaded = True

    def __init__(self):
        self.calls = 0

    def load(self):
        pass

    def generate_batch(self, prompts, **kw):
        self.calls += 1
        raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")


def test_header_failures_raise_without_retry(monkeypatch):
    """Deliberate departure: where the JAX processor retries an
    out-of-memory batch once after 2 s and then writes no header, the
    port's raises at once, and a generator that cannot load raises too."""
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    jax_failing, failing = _Failing(), _Failing()
    chunks = _chunks(JaxChunk, LECTURE[:2])
    assert JaxProcessor(JaxCtxConfig(enabled=True), jax_failing
                        ).process_chunks(chunks) == chunks
    assert jax_failing.calls == 2 and slept == [2.0]
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        ContextualProcessor(ContextualConfig(enabled=True),
                            failing).process_chunks(
            _chunks(AudioChunk, LECTURE[:2]))
    assert failing.calls == 1 and slept == [2.0]
    assert not hasattr(proc_module, "time")

    class Unloadable(_Failing):
        is_loaded = False

        def load(self):
            raise ConfigError("no weights")

    with pytest.raises(ConfigError, match="no weights"):
        ContextualProcessor(ContextualConfig(enabled=True),
                            Unloadable()).process_chunks(
            _chunks(AudioChunk, LECTURE[:2]))


# -- AudioRAG.ingest with headers ---------------------------------------------------

def _ingest_both(path, backend, jax_rag, rag):
    """Ingest ``path`` into collection ``backend`` with that header
    backend in both pipelines: (JAX chunks, port chunks, JAX ranks, port
    ranks, port stage timings)."""
    jax_rag.config.contextual.backend = backend
    rag.config.contextual.backend = backend
    jax_rag.ingest(str(path), collection=backend, diarize=False)
    res = rag.ingest(str(path), collection=backend, diarize=False)

    def chunks(store):
        return [(p["text"], p["metadata"].get("original_text"))
                for p in store._coll(backend).payloads]

    def ranks(q):
        return [[r.text for r in q(x, top_k=2, search_type="hybrid",
                                   collection=backend).results]
                for x in QUERIES]

    return (chunks(jax_rag._retriever), chunks(rag.store),
            lambda: ranks(jax_rag.query), ranks(rag.query),
            res.stage_timings)


def test_ingest_with_headers_matches_jax(tmp_path):
    """The spine's three turns (one chunk each) with llm headers, then
    extractive ones, in both pipelines: the same chunk texts (headed where
    a header was written, the turn in ``original_text``), the same top
    two hits for both queries, and ``stage_timings["contextualize"]``."""
    path = tmp_path / "turns.wav"
    write_wav(path, _turn_audio(), SR)
    jax_rag, rag = _jax_rag({}), _port_rag({})
    jax_rag.config.contextual = JaxCtxConfig(enabled=True)
    rag.config.contextual = ContextualConfig(enabled=True)
    jax_gen = JaxLLM(JaxGenConfig(backend="llm-jax", **GEN_KW))
    jax_gen.load()
    jax_rag.ingestion._generator = jax_gen
    gen = LLMGenerator(GenerationConfig(**GEN_KW), device="cpu")
    rag._generator, rag._generator_built = gen, True
    ref_calls, got_calls = _Calls(jax_gen), _Calls(gen)
    try:
        ref, got, jax_ranks, ranks, timings = _ingest_both(
            path, "llm", jax_rag, rag)
        if not _follow_calls(jax_gen, ref_calls, got_calls):
            ref = _replayed(jax_gen, got_calls, 0, lambda: _ingest_both(
                path, "llm2", jax_rag, rag)[0])
        assert got == ref and len(got) == 3
        assert any(t.startswith("[Context: ") for t, _ in got)
        assert all(o is None or t.endswith("\n" + o) for t, o in got)
        assert ranks == jax_ranks()
        assert "contextualize" in timings
        ref, got, jax_ranks, ranks, timings = _ingest_both(
            path, "extractive", jax_rag, rag)
        assert got == ref and ranks == jax_ranks()
        assert "contextualize" in timings
    finally:
        ref_calls.close()
        got_calls.close()
        jax_rag.unload_all()
        rag.unload_all()
