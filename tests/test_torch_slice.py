"""The PyTorch port's ingest → query slice as a whole: the same audio through
the port's ``AudioRAG`` and the JAX package's gives identical segment texts,
chunk texts and top-2 rankings, the same DTW word times and segment bounds
within 0.02 s (three decode profiles here: fp32, int8, and int4 cross K/V
with an int4 head; the other four and the query half with reranking in
``test_torch_slice_profiles.py``), diarized the same speakers and chunk
bounds, and the same segments through the VAD filter; the port's entry
points refuse a missing card instead of running on the CPU; the port and
``chip_smoke.py`` import nothing of JAX or of the JAX package."""

import ast
import subprocess
import sys
import textwrap

import pytest
import torch

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import (
    ASRConfig,
    AudioRAGConfig,
    DiarizationConfig,
)
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.pipeline import AudioRAG
from torch_llm_common import one_torch_thread  # noqa: F401
from torch_slice_common import (
    PROFILES,
    ROOT,
    TIME_TOL,
    _assert_same_times,
    _gap_audio,
    _run_jax,
    _run_port,
    check_slice_profile,
)


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", ["fp32", "int8", "kv4+int8+lm4"])
def test_slice_matches_jax(profile, tmp_path, monkeypatch):
    """Both packages give the same segments, word times (DTW, within
    0.02 s), chunks and rankings in each decode profile
    (:func:`check_slice_profile`)."""
    check_slice_profile(profile, tmp_path, monkeypatch)


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
def test_vad_filtered_transcribe_matches_jax(tmp_path, monkeypatch):
    """With the VAD filter on (the default, learned backend under
    "auto"), both packages transcribe the same speech spans: the same
    segments, word times within 0.02 s, chunks and rankings."""
    path = tmp_path / "lecture.wav"
    write_wav(path, _gap_audio(), SR)
    switches = {"vad_filter": True, "vad_backend": "auto"}
    jax_segments, jax_chunks, jax_ranks = _run_jax(path, switches,
                                                   monkeypatch)
    segments, chunks, ranks = _run_port(path, switches, monkeypatch)
    _assert_same_times(segments, jax_segments)
    assert len(segments) >= 2 and segments[0][1] > 0.3  # spans, not 0 s
    assert [c[0] for c in chunks] == [c[0] for c in jax_chunks]
    assert ranks == jax_ranks
    assert ASRConfig().vad_filter and ASRConfig().vad_backend == "auto"

@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
def test_diarized_slice_matches_jax(tmp_path, monkeypatch):
    """The twin of the JAX package's trained end-to-end test on its own
    0.5 s-gap layout and configuration (f32, no VAD filter), diarizing by
    default (clustering, learned VAD, at most 2 speakers): the same chunk
    texts, speakers, start and end, the same top-2 rankings, and the
    spoken words in each query's top hit. (``chip_smoke.py`` runs the int8
    profile of it on the card against this CPU path.)"""
    path = tmp_path / "lecture.wav"
    write_wav(path, _gap_audio(), SR)
    switches = PROFILES["fp32"]
    jax_out = _run_jax(path, switches, monkeypatch, diarize=True,
                       diarization={"backend": "clustering",
                                    "max_speakers": 2}, max_tokens=256)
    port_out = _run_port(path, switches, monkeypatch, diarize=True,
                         diarization=DiarizationConfig(max_speakers=2),
                         max_tokens=256)
    _assert_same_times(port_out[0], jax_out[0])
    (segments, chunks, ranks), (_, jax_chunks, jax_ranks) = port_out, jax_out
    assert [c[:2] for c in chunks] == [c[:2] for c in jax_chunks]
    for got, ref in zip(chunks, jax_chunks):
        assert abs(got[2] - ref[2]) <= TIME_TOL
        assert abs(got[3] - ref[3]) <= TIME_TOL
    assert ranks == jax_ranks
    assert chunks and all(c[1] for c in chunks)
    assert "gradient" in ranks[0][0] or "descent" in ranks[0][0]
    assert "spectrogram" in ranks[1][0] or "harmonic" in ranks[1][0]


# -- entry points ---------------------------------------------------------------

@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_refuse_a_missing_card(no_cuda):
    from audio_rag_tpu_torch.asr.streaming import StreamingASR
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.device import resolve_device
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.retrieval.store import VectorStore

    for make in (lambda: AudioRAG(), lambda: AudioRAG(AudioRAGConfig()),
                 lambda: WhisperASR(), lambda: StreamingASR(),
                 lambda: BGEM3Embedder(),
                 lambda: VectorStore(), lambda: resolve_device("cuda:0")):
        with pytest.raises(ConfigError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ConfigError, match="unsupported"):
        resolve_device("meta")


# -- import isolation ---------------------------------------------------------------

#: what the port, ``chip_smoke.py`` and the helpers it shares with the
#: tests never import: JAX, the JAX package, and what the card's machine
#: lacks (PyYAML: the port reads its profiles with its own reader; the web
#: stack the JAX API's reference was built on: the port's server is the
#: standard library's; the checkpoint stack the JAX converters use: the
#: port reads and writes safetensors itself and has no HF tokenizer)
FORBIDDEN = {"jax", "jaxlib", "audio_rag_tpu", "yaml", "pydantic", "httpx",
             "websockets", "fastapi", "uvicorn", "starlette", "safetensors",
             "transformers", "tokenizers", "orbax", "speechbrain"}


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port imports (``python -m`` entry points
    included: ``api/__main__.py`` starts nothing when imported) and
    leaves nothing of :data:`FORBIDDEN` in ``sys.modules``."""
    code = f"FORBIDDEN = {sorted(FORBIDDEN)!r}\n" + textwrap.dedent("""
        import importlib, pkgutil, sys
        import audio_rag_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from audio_rag_tpu_torch.config import AudioRAGConfig, load_config
        from audio_rag_tpu_torch.pipeline import AudioRAG
        AudioRAG(AudioRAGConfig(device="cpu"))
        load_config(env="production", overrides={"device": "cpu"})
        assert "audio_rag_tpu_torch.api.__main__" in names
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in FORBIDDEN)
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
    """No import of :data:`FORBIDDEN`, and no use of the JAX package's
    native library or its Makefile: the port builds its own copy of the
    C++ source."""
    files = [ROOT / "chip_smoke.py",
             ROOT / "scripts" / "run_torch.py",
             ROOT / "scripts" / "eval_torch.py",
             ROOT / "scripts" / "train_asr_torch.py",
             ROOT / "scripts" / "load_real_torch.py",
             ROOT / "tests" / "torch_api_client.py",
             ROOT / "tests" / "torch_hf_layout.py",
             *sorted((ROOT / "audio_rag_tpu_torch").rglob("*.py"))]
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    for path in [*files, *sorted(
            (ROOT / "audio_rag_tpu_torch" / "csrc").glob("*.cpp"))]:
        text = path.read_text()
        for name in ("libaudiorag_audio", "Makefile"):
            assert name not in text, f"{path.relative_to(ROOT)} names {name}"


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
