"""The PyTorch port's diarization slice against the JAX package's on the
CPU: the learned and energy VAD spans, the spectral and AHC clustering,
the DER, the word → speaker aligner and both diarizers end to end, on the
trained end-to-end test's 0.5 s-gap audio and on the trained speaker test's
3-voice 50 s conversation (rng 2024)."""

import numpy as np
import pytest

from audio_rag_tpu.alignment import aligner as jal
from audio_rag_tpu.asr import vad as jvad
from audio_rag_tpu.audio import synth as jsynth
from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.config.schema import DiarizationConfig as JaxDiarConfig
from audio_rag_tpu.core.types import TranscriptSegment as JSeg
from audio_rag_tpu.core.types import Word as JWord
from audio_rag_tpu.diarization import ahc as jahc
from audio_rag_tpu.diarization import metrics as jmetrics
from audio_rag_tpu.diarization import spectral as jspectral
from audio_rag_tpu.diarization.ahc import AHCDiarizer as JaxAHC
from audio_rag_tpu.diarization.clustering import (
    ClusteringDiarizer as JaxClustering,
)
from audio_rag_tpu_torch.alignment import aligner as tal
from audio_rag_tpu_torch.asr import vad as tvad
from audio_rag_tpu_torch.audio import synth as tsynth
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.config import DiarizationConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.core.types import TranscriptSegment, Word
from audio_rag_tpu_torch.diarization import ahc as tahc
from audio_rag_tpu_torch.diarization import create_diarizer
from audio_rag_tpu_torch.diarization import metrics as tmetrics
from audio_rag_tpu_torch.diarization import spectral as tspectral
from audio_rag_tpu_torch.diarization.clustering import (
    ClusteringDiarizer,
    window_embeddings,
)
from audio_rag_tpu_torch.models.speaker import resolve_speaker_params

pytestmark = pytest.mark.skipif(
    not (ASSETS_DIR / "speaker_small.npz").exists()
    or not (ASSETS_DIR / "vad_small.npz").exists(),
    reason="trained speaker/VAD assets not built")

TURNS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure",
         "attention layers mix token information"]


def gap_audio():
    """The trained end-to-end test's audio: 0.3 s of silence, then each
    turn (rng 7) followed by 0.5 s of silence."""
    rng = np.random.default_rng(7)
    pieces = [np.zeros(int(0.3 * SR), np.float32)]
    for text in TURNS:
        pieces.append(synth_text(text, rng, noise_level=0.005))
        pieces.append(np.zeros(int(0.5 * SR), np.float32))
    return np.concatenate(pieces)


@pytest.fixture(scope="module")
def convo():
    """The trained speaker test's conversation, from the port's synth,
    equal to the JAX package's sample for sample."""
    rng = np.random.default_rng(2024)
    voices = [tsynth.sample_voice(rng) for _ in range(3)]
    audio, turns = tsynth.conversation(rng, voices, duration_s=50.0)
    jrng = np.random.default_rng(2024)
    jvoices = [jsynth.sample_voice(jrng) for _ in range(3)]
    jaudio, jturns = jsynth.conversation(jrng, jvoices, duration_s=50.0)
    np.testing.assert_array_equal(audio, jaudio)
    assert turns == jturns and len({k for _, _, k in turns}) == 3
    return audio, turns


@pytest.fixture(scope="module")
def audios(convo):
    return {"gap": gap_audio(), "convo": convo[0]}


def _segs(segs):
    return [(s.start, s.end, s.speaker) for s in segs]


@pytest.mark.parametrize("backend", ["learned", "energy", "auto"])
@pytest.mark.parametrize("name", ["gap", "convo"])
def test_speech_segments_match_jax(audios, name, backend):
    audio = audios[name]
    ref = jvad.speech_segments(audio, SR, jvad.VADOptions(backend=backend))
    got = tvad.speech_segments(audio, SR, tvad.VADOptions(backend=backend),
                               device="cpu")
    assert got == ref and got


def test_speech_segments_batch_and_edges_match_jax(audios):
    batch = [audios["gap"], audios["convo"][: 7 * SR],
             np.zeros(50, np.float32), audios["convo"][: 5 * SR]]
    opts = dict(backend="learned", min_silence_ms=300)
    ref = jvad.speech_segments_batch(batch, SR, jvad.VADOptions(**opts))
    got = tvad.speech_segments_batch(batch, SR, tvad.VADOptions(**opts),
                                     device="cpu")
    assert got == ref
    assert got == [tvad.speech_segments(a, SR, tvad.VADOptions(**opts),
                                        device="cpu") for a in batch]
    # not 16 kHz: the learned backend steps aside for the energy gate
    a8k = audios["gap"][::2]
    assert (tvad.speech_segments(a8k, 8000, tvad.VADOptions(backend="auto"),
                                 device="cpu")
            == jvad.speech_segments(a8k, 8000,
                                    jvad.VADOptions(backend="auto")))
    assert tvad.learned_vad(a8k, 8000, device="cpu") is None


@pytest.fixture(scope="module")
def embeddings(audios):
    """The port's window embeddings of the conversation (energy VAD)."""
    wav = audios["convo"]
    cfg = DiarizationConfig(vad_backend="energy")
    dims, params, _ = resolve_speaker_params(None, None, device="cpu")
    spans = tvad.speech_segments(wav, SR, tvad.VADOptions(), device="cpu")
    starts, emb = window_embeddings(wav, SR, spans, cfg, dims, params,
                                    __import__("torch").device("cpu"))
    return starts, emb


@pytest.mark.parametrize("num_speakers", [None, 2, 3])
def test_clustering_copies_match_jax(embeddings, num_speakers):
    """Spectral (also through its subsample path) and AHC labels on the
    same embeddings equal the JAX package's."""
    _, emb = embeddings
    kw = dict(num_speakers=num_speakers, max_speakers=8)
    np.testing.assert_array_equal(tspectral.spectral_cluster(emb, **kw),
                                  jspectral.spectral_cluster(emb, **kw))
    np.testing.assert_array_equal(
        tahc.ahc_cluster(emb, num_speakers=num_speakers),
        jahc.ahc_cluster(emb, num_speakers=num_speakers))
    if num_speakers is None:  # the subsample path, once
        big = np.repeat(emb, 30, axis=0)[: tspectral.MAX_CLUSTER_WINDOWS + 40]
        np.testing.assert_array_equal(tspectral.spectral_cluster(big, **kw),
                                      jspectral.spectral_cluster(big, **kw))


def test_der_and_aligner_copies_match_jax(convo):
    """DER of shifted, split and relabeled hypotheses, and the aligner's
    words and rebuilt transcript, equal to the JAX package's."""
    _, turns = convo
    rng = np.random.default_rng(0)
    ref = [(s, e, f"REF_{k}") for s, e, k in turns]
    hyps = [[(s + 0.1, e - 0.2, f"H{(k + 1) % 3}") for s, e, k in turns],
            [(s, e, f"H{rng.integers(0, 4)}") for s, e, _ in turns],
            [(s, (s + e) / 2, "A") for s, e, _ in turns]
            + [((s + e) / 2, e + 0.4, "B") for s, e, _ in turns], []]
    for hyp in hyps:
        for collar in (0.25, 0.0):
            got = tmetrics.diarization_error_rate(
                [TranscriptSegment("", *r) for r in ref],
                [TranscriptSegment("", *h) for h in hyp], collar)
            want = jmetrics.diarization_error_rate(
                [JSeg("", *r) for r in ref], [JSeg("", *h) for h in hyp],
                collar)
            assert got.to_dict() == want.to_dict()
    words = []
    t = 0.0
    for k in range(60):
        d = float(rng.uniform(0.1, 0.6))
        words.append((f"w{k}", round(t, 3), round(t + d, 3)))
        t += d + float(rng.choice([0.0, 0.2, 1.5]))
    diar = [(s, e, f"SPEAKER_{k:02d}") for s, e, k in turns[:6]]
    for tol in (0.5, 0.0, 3.0):
        got = tal.align_words_to_speakers(
            [Word(*w) for w in words],
            [TranscriptSegment("", *d) for d in diar], tol)
        want = jal.align_words_to_speakers(
            [JWord(*w) for w in words], [JSeg("", *d) for d in diar], tol)
        assert ([(w.text, w.start, w.end, w.speaker) for w in got]
                == [(w.text, w.start, w.end, w.speaker) for w in want])
        gt, jt = (tal.build_speaker_transcript(got),
                  jal.build_speaker_transcript(want))
        assert ([(s.text, s.start, s.end, s.speaker) for s in gt]
                == [(s.text, s.start, s.end, s.speaker) for s in jt])
    assert tal.align_words_to_speakers([], []) == []
    assert [w.speaker for w in tal.align_words_to_speakers(
        [Word("a", 0.0, 1.0)], [])] == [None]


@pytest.fixture(scope="module")
def jax_diarized(convo):
    audio, _ = convo
    out = {}
    for backend, cls in (("clustering", JaxClustering), ("ahc", JaxAHC)):
        for margin in ((0.0, 0.05) if backend == "ahc" else (0.0,)):
            d = cls(JaxDiarConfig(backend=backend, vad_backend="energy",
                                  overlap_margin=margin))
            d.load()
            try:
                out[backend, margin] = _segs(d.diarize(audio, SR,
                                                       num_speakers=3))
            finally:
                d.unload()
    return out


@pytest.mark.parametrize("backend,margin", [("clustering", 0.0),
                                            ("ahc", 0.0), ("ahc", 0.05)])
def test_diarizers_match_jax(convo, jax_diarized, backend, margin):
    """Both engines' segments on the conversation equal the JAX package's,
    and so does the DER (below the trained speaker test's 0.35)."""
    audio, turns = convo
    d = create_diarizer(DiarizationConfig(backend=backend,
                                          vad_backend="energy",
                                          overlap_margin=margin),
                        device="cpu")
    assert type(d).__name__ == {"clustering": "ClusteringDiarizer",
                                "ahc": "AHCDiarizer"}[backend]
    segs = d.diarize(audio, SR, num_speakers=3)
    assert _segs(segs) == jax_diarized[backend, margin]
    ref = [TranscriptSegment("", s, e, f"REF_{k}") for s, e, k in turns]
    jref = [JSeg("", s, e, f"REF_{k}") for s, e, k in turns]
    der = tmetrics.diarization_error_rate(ref, segs).der
    jder = jmetrics.diarization_error_rate(
        jref, [JSeg("", *s) for s in jax_diarized[backend, margin]]).der
    assert abs(der - jder) <= 0.01 and der < 0.35
    assert d.timings["windows"] > 0 and d.source == "asset"
    assert sum(t["talk_time"] for t in d.get_speaker_timeline(segs)) > 0


def test_diarizer_on_the_gap_audio_and_refusals(audios):
    """The learned-VAD-gated diarizer on the end-to-end audio gives the
    JAX package's segments; empty audio gives none; an unknown backend, a
    checkpoint path and an absent card are refused."""
    jd = JaxClustering(JaxDiarConfig(max_speakers=2))
    jd.load()
    try:
        ref = _segs(jd.diarize(audios["gap"], SR))
    finally:
        jd.unload()
    d = ClusteringDiarizer(DiarizationConfig(max_speakers=2), device="cpu")
    assert _segs(d.diarize(audios["gap"], SR)) == ref
    assert d.diarize(np.zeros(0, np.float32), SR) == []
    assert d.diarize(np.zeros(SR, np.float32), SR) == []
    with pytest.raises(ConfigError, match="backend"):
        DiarizationConfig(backend="nemo")
    with pytest.raises(ConfigError, match="ecapa"):
        ClusteringDiarizer(DiarizationConfig(checkpoint_path="/x"),
                           device="cpu").load()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(ConfigError, match="CUDA is not available"):
            create_diarizer()


@pytest.mark.parametrize("seed", range(4))
def test_max_overlap_assignment_matches_scipy(seed):
    """The DER's own Hungarian assignment reaches scipy's optimum on
    random overlap matrices of every shape up to 9 × 9 (ties included)."""
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(seed)
    for n in range(1, 10):
        for m in range(1, 10):
            a = rng.integers(0, 6 if seed % 2 else 1000, (n, m))
            r, c = tmetrics.max_overlap_assignment(a)
            jr, jc = linear_sum_assignment(-a)
            assert a[r, c].sum() == a[jr, jc].sum()
            assert len(set(r.tolist())) == len(r) == min(n, m)
            assert len(set(c.tolist())) == len(c) == min(n, m)


def test_eigengap_near_ties_break_alike():
    """Gaps equal in exact arithmetic (three windows: spectrum 0, 1, 2)
    give the smaller speaker count whichever way float noise tips them;
    clear gaps give the JAX package's count."""
    for noise in (-2e-8, 0.0, 2e-8):
        ev = np.array([noise, 1.0, 2.0 - noise])
        assert tspectral.estimate_num_speakers(ev, 2) == 1
    for ev in (np.array([0.0, 0.01, 0.02, 0.9, 1.0]),
               np.array([0.0, 0.5, 0.6, 0.7, 1.2]),
               np.array([0.0, 0.0, 0.0])):
        for m in (1, 2, 8):
            assert (tspectral.estimate_num_speakers(ev, m)
                    == jspectral.estimate_num_speakers(ev, m))
