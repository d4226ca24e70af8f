"""The PyTorch port's ingest → query slice as a whole: the same audio through
the port's ``AudioRAG`` and the JAX package's gives identical segment texts,
chunk texts and top-2 rankings; the port's entry points refuse a missing
card instead of running on the CPU; the port and ``chip_smoke.py`` import
nothing of JAX or of the JAX package."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.pipeline.orchestrator import AudioRAG as JaxAudioRAG
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    ASRConfig,
    AudioRAGConfig,
    ChunkingConfig,
    EmbeddingConfig,
    RetrievalConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.pipeline import AudioRAG

ROOT = Path(__file__).resolve().parents[1]
TURNS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure",
         "attention layers mix token information"]
QUERIES = ["gradient descent loss", "spectrogram harmonic"]
WINDOW_S = 6.0  # tiny-synth's audio context


def _turn_audio():
    """The JAX trained end-to-end test's turns (rng 7), each 0.3 s into a
    6 s window of its own, so that each turn is one segment and one chunk
    when diarization is off."""
    rng = np.random.default_rng(7)
    win, lead = int(WINDOW_S * SR), int(0.3 * SR)
    out = np.zeros(len(TURNS) * win, np.float32)
    for i, text in enumerate(TURNS):
        wav = synth_text(text, rng, noise_level=0.005)
        out[i * win + lead: i * win + lead + wav.size] = wav
    return out


def _spy(monkeypatch, obj, name, seen):
    orig = getattr(obj, name)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen.extend(out)
        return out

    monkeypatch.setattr(obj, name, spy)


#: profile → the ASR quantization switches both packages take
PROFILES = {
    "fp32": {},
    "int8": {"cross_kv_int8": True, "decoder_int8": True},
    "int8+dec4+skv8": {"cross_kv_int8": True, "decoder_int4": True,
                       "self_kv_int8": True},
    "kv4+int8+lm4": {"cross_kv_int4": True, "decoder_int8": True,
                     "lm_head_int4": True},
    # beam search (the port's default lazy reorder) and speculative greedy
    # decoding in the production profile
    "beam5+int8": {"cross_kv_int8": True, "decoder_int8": True,
                   "decode": "beam", "beam_size": 5},
    "spec8+int8": {"cross_kv_int8": True, "decoder_int8": True,
                   "speculative_k": 8},
}


def _run_jax(path, switches, monkeypatch):
    cfg = JaxConfig(**{
        "asr": {"backend": "whisper-jax", "model_size": "tiny-synth",
                "compute_type": "float32", "vad_filter": False,
                "temperature_fallback": False, **switches},
        "embedding": {"backend": "bge-m3", "model": "eval-small"},
        "retrieval": {"backend": "tpu", "capacity_step": 128},
        "reranking": {"backend": "none"},
        "generation": {"backend": "none"},
        "tts": {"backend": "null"},
        "chunking": {"min_chunk_tokens": 1, "overlap_tokens": 0},
    })
    cfg.chunking.max_tokens = 8  # one chunk per window (schema floor: 50)
    rag = JaxAudioRAG(cfg)
    try:
        segments = []
        _spy(monkeypatch, rag.ingestion.asr, "transcribe_with_words",
             segments)
        rag.ingest(str(path), collection="slice", diarize=False)
        chunks = [p["text"] for p in
                  rag._retriever._coll("slice").payloads]
        ranks = [[r.text for r in rag.query(
            q, top_k=2, search_type="hybrid", collection="slice").results]
            for q in QUERIES]
    finally:
        rag.unload_all()
    return [s.text for s in segments], chunks, ranks


def _run_port(path, switches, monkeypatch):
    rag = AudioRAG(AudioRAGConfig(
        asr=ASRConfig(model_size="tiny-synth", compute_type="float32",
                      **switches),
        embedding=EmbeddingConfig(model="eval-small"),
        retrieval=RetrievalConfig(capacity_step=128),
        chunking=ChunkingConfig(max_tokens=8, min_chunk_tokens=1,
                                overlap_tokens=0),
        device="cpu"))
    segments = []
    _spy(monkeypatch, rag.asr, "transcribe_with_words", segments)
    res = rag.ingest(str(path), collection="slice", diarize=False)
    chunks = [p["text"] for p in rag.store._coll("slice").payloads]
    ranks = [[r.text for r in rag.query(
        q, top_k=2, search_type="hybrid", collection="slice").results]
        for q in QUERIES]
    assert res.num_chunks == len(chunks) == rag.count("slice")
    assert all(w.end >= w.start for s in segments for w in s.words)
    return [s.text for s in segments], chunks, ranks


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", list(PROFILES))
def test_slice_matches_jax(profile, tmp_path, monkeypatch):
    """Both packages give the same segments, chunks and rankings in each
    decode profile. Under int4 cross K/V the JAX package garbles the turns'
    words on tiny-synth ("gradint descescent"), so there the port is held
    to it and not to the spoken words."""
    path = tmp_path / "turns.wav"
    write_wav(path, _turn_audio(), SR)
    switches = PROFILES[profile]
    jax_segments, jax_chunks, jax_ranks = _run_jax(path, switches,
                                                   monkeypatch)
    segments, chunks, ranks = _run_port(path, switches, monkeypatch)
    assert segments == jax_segments
    assert chunks == jax_chunks
    assert ranks == jax_ranks
    assert len(chunks) == 3
    if not switches.get("cross_kv_int4"):
        # the spoken content is what the queries find
        assert "gradient" in ranks[0][0] and "spectrogram" in ranks[1][0]


# -- entry points ---------------------------------------------------------------

@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_refuse_a_missing_card(no_cuda):
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.device import resolve_device
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    for make in (lambda: AudioRAG(), lambda: AudioRAG(AudioRAGConfig()),
                 lambda: WhisperASR(), lambda: BGEM3Embedder(),
                 lambda: VectorStore(), lambda: resolve_device("cuda:0")):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ConfigError, match="unsupported"):
        resolve_device("meta")


def test_diarization_is_refused():
    rag = AudioRAG(AudioRAGConfig(device="cpu"))
    with pytest.raises(ConfigError, match="diariz"):
        rag.ingest(np.zeros(SR, np.float32), sample_rate=SR, diarize=True)


# -- import isolation ---------------------------------------------------------------

def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import audio_rag_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from audio_rag_tpu_torch.config import AudioRAGConfig
        from audio_rag_tpu_torch.pipeline import AudioRAG
        AudioRAG(AudioRAGConfig(device="cpu"))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "audio_rag_tpu"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_of_port_and_chip_smoke_import_no_jax():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "audio_rag_tpu_torch").rglob("*.py"))]
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "audio_rag_tpu"}
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# -- chip_smoke.py without a card -------------------------------------------------

@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(no_cuda, alone, tmp_path):
    """Without a card, and beside nothing of the repository, the script
    exits non-zero and prints no result line."""
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        cwd = ROOT
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
