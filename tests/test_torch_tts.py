"""The port's speech output against the JAX package's, on the CPU: the
trained TTS model (``tts_small.npz``) on three texts (log-durations within
two bf16 ulps, durations equal but at a named half-integer tie, mel within
0.0625, eight bf16 ulps below 2, and 2e-3 on average), the Griffin-Lim
vocoder on the JAX package's mel (audio within 1e-3 and correlated to
0.99999), the segment splitter, ``NullTTS``'s bytes (equal), the JAX
``test_tts_backend.py`` and ``test_tts_external.py`` scenarios on the
port's backends (stub ``piper`` binary, stub ``edge_tts`` package), the
pipeline's fallback chain and ``speak_answer`` with the neural backend.

Griffin-Lim is not held end to end: its phase search turns a mel that
differs in a few bf16 ulps into another waveform of the same spectrum, so
the vocoder is held on the same mel instead."""

import dataclasses
import io
import os
import stat
import sys
import types
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.config.schema import TTSConfig as JaxTTSConfig
from audio_rag_tpu.models import tts as jtts
from audio_rag_tpu.tts.jax_tts import _split_segments as jax_split
from audio_rag_tpu.tts.null import NullTTS as JaxNullTTS
from audio_rag_tpu_torch.config import AudioRAGConfig, TTSConfig, load_config
from audio_rag_tpu_torch.core.exceptions import TTSError
from audio_rag_tpu_torch.models import tts as ttts
from audio_rag_tpu_torch.tts import TTS_BACKENDS, create_tts
from audio_rag_tpu_torch.tts.external import EDGE_VOICES, EdgeTTS, PiperTTS
from audio_rag_tpu_torch.tts.neural import (
    NeuralTTS,
    _split_segments,
    bucket_dims,
)
from audio_rag_tpu_torch.tts.null import NullTTS
from audio_rag_tpu_torch.weights import load_tts_small
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["hello world", "the gradient descent model",
         "seven 42 quick tests."]
BUCKET = 32
MEL_MAX = 0.0625   # eight bf16 ulps of a log-mel value below 2
MEL_MEAN = 2e-3
AUDIO_MAX = 1e-3   # of a waveform peak-scaled to 0.9
AUDIO_CORR = 0.99999


def _decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data)) as wf:
        sr = wf.getframerate()
        pcm = np.frombuffer(wf.readframes(wf.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32767.0, sr


@pytest.fixture(scope="module")
def ref():
    """The JAX model on the asset: the TEXTS in a 16-row batch at bucket
    32 (the backend's program), its mel's audio, and Griffin-Lim of a
    random magnitude."""
    with np.load(ROOT / "audio_rag_tpu" / "assets" / "tts_small.npz") as d:
        flat = {k: d[k] for k in d.files}
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parts, leaf = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value, jnp.float32)
    dims = dataclasses.replace(jtts.TTS_PRESETS["small"], max_text=BUCKET,
                               max_frames=16 * BUCKET, max_dur=16)
    toks = np.zeros((16, BUCKET), np.int32)
    for i, t in enumerate(TEXTS):
        toks[i] = jtts.text_to_ids(t, BUCKET)
    mel, valid, log_dur = jtts.apply_tts(tree, dims, jnp.asarray(toks))
    dur = jtts.predict_durations(dims, log_dur, jnp.asarray(toks))
    audio = jax.vmap(lambda m: jtts.mel_to_audio(m, n_iter=32))(mel[:3])
    mag = np.abs(np.random.default_rng(0).standard_normal(
        (100, 201))).astype(np.float32)
    return {"toks": toks, "mel": np.asarray(mel), "valid": np.asarray(valid),
            "log_dur": np.asarray(log_dur), "dur": np.asarray(dur),
            "audio": np.asarray(audio), "mag": mag,
            "gl": np.asarray(jtts.griffin_lim(jnp.asarray(mag)))}


@pytest.fixture(scope="module")
def tts():
    backend = NeuralTTS(TTSConfig(backend="jax", sample_rate=16000),
                        device="cpu")
    backend.load()
    return backend


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), 2.0 ** -100)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_apply_tts_matches_jax(ref):
    dims = bucket_dims(ttts.TTS_PRESETS["small"], BUCKET)
    toks = torch.from_numpy(ref["toks"])
    mel, valid, log_dur = ttts.apply_tts(load_tts_small(), dims, toks)
    dur = ttts.predict_durations(dims, log_dur, toks).numpy()
    real = ref["toks"] != ttts.PAD_ID
    gap = np.abs(log_dur.numpy() - ref["log_dur"])[real]
    assert (gap <= 2 * _bf16_ulp(ref["log_dur"][real])).all(), gap.max()
    parted = np.argwhere(dur != ref["dur"])
    for b, s in parted:  # only at a half-integer within bf16 error
        frames = float(np.exp(ref["log_dur"][b, s]))
        print(f"duration tie at row {b} symbol {s}: JAX exp(log_dur) "
              f"{frames:.5f}, {ref['dur'][b, s]} against {dur[b, s]}")
        assert abs(frames - np.floor(frames) - 0.5) <= 2 * frames * 2 ** -8
    if not len(parted):
        assert np.array_equal(valid.numpy(), ref["valid"])
        diff = np.abs(mel.numpy() - ref["mel"])
        assert diff.max() <= MEL_MAX and diff.mean() <= MEL_MEAN, \
            (diff.max(), diff.mean())
    assert ref["valid"][:3].sum(1).tolist() == (dur[:3].sum(1)).tolist()
    assert (dur[3:] == 0).all() and not valid[3:].any()


def test_vocoder_matches_jax_on_the_same_mel(ref):
    audio = ttts.mel_to_audio(torch.tensor(ref["mel"][:3])).numpy()
    for row in range(3):
        n = int(ref["valid"][row].sum()) * ttts.HOP_LENGTH
        a, b = audio[row, :n], ref["audio"][row, :n]
        assert np.abs(a - b).max() <= AUDIO_MAX
        assert np.corrcoef(a, b)[0, 1] >= AUDIO_CORR
    one = ttts.mel_to_audio(torch.tensor(ref["mel"][1])).numpy()
    assert np.array_equal(one, audio[1])  # a row alone = the row in a batch
    gl = ttts.griffin_lim(torch.from_numpy(ref["mag"])[None])[0].numpy()
    assert gl.shape == ref["gl"].shape == (100 * ttts.HOP_LENGTH,)
    assert np.abs(gl - ref["gl"]).max() <= 1e-4


@pytest.mark.parametrize("text,max_len", [
    ("First sentence. Second one!  Third?", 64),
    ("word " * 30, 32),
    ("a" * 70 + " tail", 32),
    ("", 32),
    ("   ", 256),
    ("Is it? Yes. " * 40, 256),
])
def test_split_segments_match_jax(text, max_len):
    got = _split_segments(text, max_len)
    assert got == jax_split(text, max_len)
    assert all(len(s) <= max_len for s in got)


@pytest.mark.parametrize("sr", [16000, 22050])
@pytest.mark.parametrize("text", ["", "hello", "one two three four",
                                  "word " * 200],
                         ids=["empty", "one", "four", "capped"])
def test_null_tts_bytes_match_jax(text, sr, tmp_path):
    port = NullTTS(TTSConfig(sample_rate=sr))
    data = port.synthesize(text, output_path=str(tmp_path / "n.wav"))
    assert data == JaxNullTTS(JaxTTSConfig(sample_rate=sr)).synthesize(text)
    assert (tmp_path / "n.wav").read_bytes() == data
    assert port.is_loaded


# -- the neural backend: the JAX backend tests' scenarios ----------------------------

def test_registered_and_creatable():
    assert set(TTS_BACKENDS) == {"null", "jax", "piper", "edge-tts"}
    backend = create_tts(TTSConfig(backend="jax"), device="cpu")
    assert isinstance(backend, NeuralTTS) and not backend.is_loaded
    assert isinstance(create_tts(TTSConfig()), NullTTS)


def test_synthesize_returns_valid_wav(tts, ref, tmp_path):
    out = tmp_path / "a.wav"
    data = tts.synthesize("hello world", output_path=str(out))
    pcm, sr = _decode_wav(data)
    assert sr == 16000
    assert pcm.size > 1000 and np.max(np.abs(pcm)) > 0.01
    assert out.read_bytes() == data
    # the JAX model's frame count for the same text
    assert pcm.size == int(ref["valid"][0].sum()) * ttts.HOP_LENGTH


def test_duration_scales_with_text(tts):
    short, _ = _decode_wav(tts.synthesize("hi"))
    long, _ = _decode_wav(tts.synthesize(
        "this is a much longer sentence with many more words in it"))
    assert long.size > 2 * short.size


def test_empty_text_raises(tts):
    with pytest.raises(TTSError):
        tts.synthesize("   ")


def test_resampling_and_reload():
    backend = NeuralTTS(TTSConfig(backend="jax", sample_rate=22050),
                        device="cpu")
    assert not backend.is_loaded
    pcm, sr = _decode_wav(backend.synthesize("ok"))  # loads on first use
    assert sr == 22050 and backend.is_loaded
    backend.unload()
    assert not backend.is_loaded and backend._params is None
    backend.load()
    assert backend.is_loaded


def test_trained_voice(tts):
    """Lone vowels put their energy near each vowel's band (at least 4 of
    5), vowels outlast consonants, and synthesis is deterministic."""
    peaks = {}
    for c in "aeiou":
        pcm, _ = _decode_wav(tts.synthesize(c))
        spec = np.abs(np.fft.rfft(pcm * np.hanning(pcm.size)))
        peaks[c] = np.fft.rfftfreq(pcm.size, 1 / 16000)[int(np.argmax(spec))]
    band = {c: 450.0 + 220.0 * "aeiou".index(c) for c in "aeiou"}
    assert sum(0.4 * band[c] <= peaks[c] <= 2.5 * band[c]
               for c in "aeiou") >= 4, peaks
    v, _ = _decode_wav(tts.synthesize("aaaaaaaa"))
    k, _ = _decode_wav(tts.synthesize("tttttttt"))
    assert v.size > k.size
    assert tts.synthesize("determinism check") == \
        tts.synthesize("determinism check")


def test_entry_point_refuses_a_missing_card(monkeypatch):
    from audio_rag_tpu_torch.core.exceptions import ConfigError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        NeuralTTS(TTSConfig(backend="jax"))


# -- the external engines: the JAX external tests' scenarios --------------------------

PIPER_STUB = f"""#!{sys.executable}
import struct, sys
args = sys.argv[1:]
model = args[args.index("--model") + 1] if "--model" in args else ""
out = args[args.index("--output_file") + 1]
text = sys.stdin.read()
if not text:
    sys.stderr.write("no text\\n"); sys.exit(1)
if model == "fail.onnx":
    sys.stderr.write("model load failed\\n"); sys.exit(3)
pcm = b"\\x01\\x02\\x03\\x04"
hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt "
       + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
       + b"data" + struct.pack("<I", len(pcm)))
open(out, "wb").write(hdr + pcm)
"""


@pytest.fixture
def piper_on_path(tmp_path, monkeypatch):
    exe = tmp_path / "piper"
    exe.write_text(PIPER_STUB)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    return exe


def test_piper_cli(piper_on_path, tmp_path):
    tts = PiperTTS(TTSConfig(backend="piper", model="voice.onnx"))
    tts.load()
    out = tmp_path / "o.wav"
    data = tts.synthesize("hello world", output_path=str(out))
    assert data.startswith(b"RIFF") and b"WAVE" in data[:16]
    assert out.read_bytes() == data
    assert tts.synthesize("hello").startswith(b"RIFF")  # temp file path
    failing = PiperTTS(TTSConfig(backend="piper", model="fail.onnx"))
    failing.load()
    with pytest.raises(TTSError, match="model load failed"):
        failing.synthesize("hello")


def test_piper_absent_fails_at_load(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))  # empty dir: no piper
    monkeypatch.setitem(sys.modules, "piper", None)
    tts = PiperTTS(TTSConfig(backend="piper"))
    with pytest.raises(TTSError, match="not installed"):
        tts.load()
    with pytest.raises(Exception, match="before load"):
        tts.synthesize("x")


def test_edge_tts(monkeypatch, tmp_path):
    mod = types.ModuleType("edge_tts")

    class Communicate:
        def __init__(self, text, voice):
            assert voice in EDGE_VOICES.values()

        async def stream(self):
            for piece in (b"\x01\x02", b"\x03"):
                yield {"type": "audio", "data": piece}
            yield {"type": "WordBoundary", "offset": 0}

    mod.Communicate = Communicate
    monkeypatch.setitem(sys.modules, "edge_tts", mod)
    tts = EdgeTTS(TTSConfig(backend="edge-tts"), language="fr")
    tts.load()
    out = tmp_path / "e.mp3"
    assert tts.synthesize("bonjour", output_path=str(out)) == b"\x01\x02\x03"
    assert out.read_bytes() == b"\x01\x02\x03"
    monkeypatch.setitem(sys.modules, "edge_tts", None)
    with pytest.raises(TTSError, match="not installed"):
        EdgeTTS(TTSConfig(backend="edge-tts")).load()


# -- the pipeline ------------------------------------------------------------------

@pytest.mark.parametrize("backend,fallback,want", [
    ("piper", "jax", NeuralTTS),   # the JAX test's chain
    ("piper", "null", NullTTS),
    ("edge-tts", "none", type(None)),
    ("jax", "null", NeuralTTS),
    ("edge-tts", "jax", NeuralTTS),
])
def test_pipeline_tts_fallback_chain(backend, fallback, want, monkeypatch,
                                     tmp_path):
    from audio_rag_tpu_torch.pipeline.query import QueryPipeline

    monkeypatch.setenv("PATH", str(tmp_path))  # no piper binary
    monkeypatch.setitem(sys.modules, "piper", None)
    monkeypatch.setitem(sys.modules, "edge_tts", None)
    pipe = QueryPipeline(AudioRAGConfig(
        tts=TTSConfig(backend=backend, fallback_backend=fallback),
        device="cpu"))
    got = pipe.tts
    assert isinstance(got, want)
    assert got is None or got.is_loaded
    assert pipe.tts is got  # built once
    pipe.unload()
    assert pipe._tts is None and not pipe._tts_built


def test_speak_answer_with_the_neural_backend():
    """``query(generate_answer=True, speak_answer=True)`` with tts.backend
    "jax" on the fake backends: a 22,050 Hz WAV of the answer and a "tts"
    timing; ``unload_all`` drops the backend."""
    from audio_rag_tpu_torch.core.types import TranscriptSegment
    from audio_rag_tpu_torch.pipeline import AudioRAG

    rag = AudioRAG(load_config(
        configs_dir=ROOT / "configs" / "no-such-dir", overrides={
            "asr": {"backend": "fake"}, "diarization": {"backend": "fake"},
            "embedding": {"backend": "fake"},
            "reranking": {"backend": "none"},
            "generation": {"backend": "fake"}, "tts": {"backend": "jax"},
            "device": "cpu"}))
    rag.ingestion.ingest_segments([TranscriptSegment(
        text="gradient descent converges", start=0.0, end=5.0,
        speaker="A")])
    rag.generator.generate = lambda prompt, **kw: "it converges."
    out = rag.query("gradient descent", generate_answer=True,
                    speak_answer=True)
    pcm, sr = _decode_wav(out.audio)
    assert sr == 22050 and out.answer == "it converges."
    assert 0.3 * sr < pcm.size < 3 * sr and np.abs(pcm).max() > 0.01
    assert "tts" in out.stage_timings and out.to_dict()["has_audio"]
    assert isinstance(rag.querying.tts, NeuralTTS)
    rag.unload_all()
    assert rag.querying._tts is None
