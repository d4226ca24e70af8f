"""The port's native audio runtime (``audio_rag_tpu_torch/native.py``, its
own copy of the C++ source) against the JAX package on the CPU: the
resampler from 8, 22.05, 44.1 and 48 kHz, WAV decoding of every sample
format the C decoder takes, the DTW path, the median filter, and
``get_duration``; each numpy fallback against the C path; the build into
``build/native/``."""

import shutil
import struct
import subprocess
import sys
import textwrap
import wave
from pathlib import Path

import numpy as np
import pytest

from audio_rag_tpu.asr import word_timing as jwt
from audio_rag_tpu.audio import io as jio
from audio_rag_tpu_torch import native
from audio_rag_tpu_torch.asr import word_timing as twt
from audio_rag_tpu_torch.audio import io as tio
from audio_rag_tpu_torch.core.exceptions import AudioProcessingError
from torch_llm_common import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
RATES = [8000, 22050, 44100, 48000]


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "the native runtime did not build"
    return lib


def test_library_builds_into_build_native_from_the_port_source(lib):
    path = native.lib_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert native.SOURCE == ROOT / "audio_rag_tpu_torch" / "csrc" / \
        "audio_native.cpp"
    assert lib._name == str(path)


def test_processes_started_together_build_once(tmp_path):
    """Four processes building into an empty directory at once leave one
    library and no temporary files (the lock and the rename)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from audio_rag_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        assert native.get_lib() is not None
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(4)]
    assert [p.wait(timeout=300) for p in procs] == [0] * 4
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == [".lock", native.lib_path().name]


def _signal(sr, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("sr", RATES)
def test_resample_matches_jax(lib, sr):
    """Lengths that are not whole multiples of the rate ratio, down to a
    few samples: the same length and the same samples as the JAX
    package's (its committed library), through the C path and the numpy
    fallback."""
    for n, seed in ((3 * sr + 7, 0), (sr // 3 + 1, 1), (5, 2)):
        x = _signal(sr, n, seed)
        ref = jio.resample(x, sr)
        got = tio.resample(x, sr)
        fallback = tio._resample_np(x, sr, 16000)
        assert got.shape == ref.shape == fallback.shape
        assert got.dtype == fallback.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(fallback, got)


def test_decode_audio_resamples_files_as_jax(tmp_path):
    """A 44.1 kHz file cut 3 samples short of a whole second: the FFT
    resampler the port had gave a different length (ROADMAP fault 7)."""
    x = _signal(44100, 44100 * 2 - 3, 5)
    path = tmp_path / "a.wav"
    jio.write_wav(path, x, 44100)
    got, sr = tio.decode_audio(path)
    ref, rsr = jio.decode_audio(path)
    assert sr == rsr == 16000 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _wav(samples: np.ndarray, sr: int, code: int, bits: int,
         extra_chunk: bool = False) -> bytes:
    """A RIFF/WAVE file written by hand: ``samples`` (frames, channels)
    already in the sample type, format ``code`` (1 PCM, 3 float)."""
    frames, ch = samples.shape
    width = bits // 8
    if bits == 24:
        v = samples.astype(np.int32).reshape(-1)
        raw = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)],
                       axis=1).astype(np.uint8).tobytes()
    else:
        raw = samples.tobytes()
    fmt = struct.pack("<HHIIHH", code, ch, sr, sr * ch * width, ch * width,
                      bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if extra_chunk:  # an odd-sized chunk before the data: word alignment
        body += b"LIST" + struct.pack("<I", 3) + b"abc\x00"
    body += b"data" + struct.pack("<I", len(raw)) + raw
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _formats():
    rng = np.random.default_rng(9)
    n = 1601
    yield "pcm8", 1, 8, rng.integers(0, 256, (n, 1)).astype(np.uint8)
    yield "pcm16", 1, 16, rng.integers(-32768, 32768, (n, 1)).astype("<i2")
    yield "pcm24", 1, 24, rng.integers(-2**23, 2**23, (n, 1))
    yield "pcm32", 1, 32, rng.integers(-2**31, 2**31, (n, 1)).astype("<i4")
    yield "float32", 3, 32, rng.uniform(-1, 1, (n, 1)).astype("<f4")
    yield "stereo16", 1, 16, rng.integers(-32768, 32768, (n, 2)).astype("<i2")
    yield "stereo_float", 3, 32, rng.uniform(-1, 1, (n, 2)).astype("<f4")
    yield "5ch24", 1, 24, rng.integers(-2**23, 2**23, (n, 5))


@pytest.mark.parametrize("name,code,bits,samples", list(_formats()),
                         ids=[f[0] for f in _formats()])
def test_wav_decode_matches_jax_exactly(lib, tmp_path, name, code, bits,
                                        samples):
    """Every sample format the C decoder takes, at 16 kHz (no resampling):
    the JAX package's samples bit for bit, through the C path and the
    numpy fallback. A float WAV is refused by the ``wave`` module the
    port used before (ROADMAP fault 9)."""
    path = tmp_path / f"{name}.wav"
    path.write_bytes(_wav(samples, 16000, code, bits,
                          extra_chunk=name == "pcm24"))
    ref, _ = jio.decode_audio(path)
    got, sr = tio.decode_audio(path)
    assert sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    fallback, fsr = tio._wav_decode_np(path.read_bytes())
    assert fsr == 16000
    np.testing.assert_array_equal(fallback, got)
    assert got.size == samples.shape[0]


def test_float_wav_of_one_second_decodes(tmp_path):
    x = np.sin(np.arange(16000) / 10.0).astype("<f4")[:, None]
    path = tmp_path / "f.wav"
    path.write_bytes(_wav(x, 16000, 3, 32))
    got, _ = tio.decode_audio(path)
    np.testing.assert_array_equal(got, x[:, 0])
    assert tio.get_duration(path) == 1.0


def test_bad_and_unsupported_wav_files_raise(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF0000WAVEjunk" * 4)
    with pytest.raises(AudioProcessingError, match="invalid WAV"):
        tio.decode_audio(bad)
    f64 = tmp_path / "f64.wav"
    f64.write_bytes(_wav(np.zeros((10, 1), "<f8"), 16000, 3, 64))
    with pytest.raises(AudioProcessingError, match="unsupported WAV"):
        tio.decode_audio(f64)
    with pytest.raises(AudioProcessingError, match="not found"):
        tio.decode_audio(tmp_path / "missing.wav")


def _costs():
    """``test_torch_word_timing.py``'s seeded costs, as f32 (what the
    alignment pass hands the DTW)."""
    rng = np.random.default_rng(42)
    out = []
    for n, m in [(1, 1), (1, 7), (6, 1), (5, 9), (17, 40), (40, 17),
                 (60, 300)]:
        out.append(rng.standard_normal((n, m)))
        out.append(rng.integers(0, 3, (n, m)).astype(np.float64))
    out.append(np.zeros((8, 12)))
    return [c.astype(np.float32) for c in out]


def test_dtw_c_path_equals_numpy_path_and_jax(lib):
    for cost in _costs():
        ti, fi = native.dtw_path(cost)
        nti, nfi = twt._dtw_path_np(cost)
        jti, jfi = jwt.dtw_path(cost)
        assert ti.tolist() == nti.tolist() == np.asarray(jti).tolist()
        assert fi.tolist() == nfi.tolist() == np.asarray(jfi).tolist()
        assert twt.dtw_path(cost)[0].tolist() == ti.tolist()


@pytest.mark.parametrize("width", [3, 7, 63])
def test_median_filter_matches_numpy_and_jax(lib, width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((6, 97)).astype(np.float32)
    x[:, 10:20] = 0.5  # ties
    got = native.median_filter(x, width)
    np.testing.assert_array_equal(got, twt._median_filter_np(x, width))
    np.testing.assert_array_equal(twt._median_filter(x, width),
                                  jwt._median_filter(x, width))


@pytest.mark.parametrize("declared,present", [(0xFFFFFF00, 64), (8000, 16),
                                               (7, 7)])
def test_get_duration_reads_the_declared_frames_as_jax(tmp_path, declared,
                                                       present):
    """A WAV's duration is the frames its data chunk declares, as
    ``wave.getnframes`` gives them to the JAX package, also when fewer
    bytes follow (the upload validator refuses such a file as too long)."""
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
    path = tmp_path / "t.wav"
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + declared) + b"WAVE"
                     + b"fmt " + struct.pack("<I", 16) + fmt + b"data"
                     + struct.pack("<I", declared) + b"\x80" * present)
    assert tio.get_duration(path) == jio.get_duration(path) == declared / 8000


def test_get_duration_and_the_error_without_ffmpeg(tmp_path, monkeypatch):
    path = tmp_path / "d.wav"
    jio.write_wav(path, _signal(22050, 22050 * 3 + 11, 3), 22050)
    assert tio.get_duration(path) == jio.get_duration(path)
    stereo = tmp_path / "s.wav"
    with wave.open(str(stereo), "wb") as wf:
        wf.setnchannels(2)
        wf.setsampwidth(2)
        wf.setframerate(8000)
        wf.writeframes(np.zeros(2 * 1234, "<i2").tobytes())
    assert tio.get_duration(stereo) == jio.get_duration(stereo)
    mp3 = tmp_path / "x.mp3"
    mp3.write_bytes(b"\xff\xfb" + bytes(100))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(AudioProcessingError) as got:
        tio.decode_audio(mp3)
    with pytest.raises(Exception) as ref:
        jio.decode_audio(mp3)
    assert str(got.value) == str(ref.value) == \
        "cannot decode .mp3 without ffmpeg"
    assert got.value.context == {"path": str(mp3), "format": ".mp3"}


def test_without_a_compiler_the_numpy_versions_run(tmp_path, monkeypatch,
                                                   caplog):
    """No g++: one warning, and the same numbers from the numpy copies."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    x = _signal(44100, 9001, 4)
    with caplog.at_level("WARNING"):
        out = tio.resample(x, 44100)
    assert native.get_lib() is None
    assert "numpy versions run instead" in caplog.text
    np.testing.assert_array_equal(out, tio._resample_np(x, 44100, 16000))
    path = tmp_path / "f.wav"
    path.write_bytes(_wav(x[:, None].astype("<f4"), 16000, 3, 32))
    np.testing.assert_array_equal(tio.decode_audio(path)[0], x)
    cost = _costs()[8]
    assert twt.dtw_path(cost)[0].tolist() == \
        np.asarray(jwt.dtw_path(cost)[0]).tolist()
