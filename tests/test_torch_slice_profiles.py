"""The PyTorch port's ingest → query slice in five of its decode profiles
(int4 weights with an int8 self cache, int4 cross K/V with an int4 head,
beam search, speculative greedy, the fallback ladder), diarized and with
the VAD filter, apart from ``test_torch_slice.py`` so that the two files
share the test run's workers: the same audio through both packages'
``AudioRAG`` gives the same segments, word times, chunks and rankings,
and with diarization the same speakers and chunk bounds."""

import pytest

from audio_rag_tpu.audio.charvoice import SR
from audio_rag_tpu.audio.io import write_wav
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import ASRConfig, DiarizationConfig
from torch_slice_common import (
    PROFILES,
    TIME_TOL,
    _assert_same_times,
    _gap_audio,
    _run_jax,
    _run_port,
    check_slice_profile,
)


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
@pytest.mark.parametrize("profile", ["int8+dec4+skv8", "kv4+int8+lm4",
                                     "beam5+int8", "spec8+int8",
                                     "fp32+ladder"])
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
