"""Live transcription in the port against the JAX package on the CPU: the
chunk batch of the streaming mux (``WhisperASR.transcribe_chunk_batch``)
and its per-row language detection (``detect_language_rows``) on the
``test`` and ``test-ml`` presets, ``StreamingASR`` on the trained
tiny-synth model with the JAX end-to-end test's settings, sessions sharing
one ``StreamingMux``, the session-sticky language, the streaming config
against ``config/schema.py``, and the port's departures (warm-up failures
raise).

Tolerances: tokens, texts, languages and offsets exact; segment and word
bounds within 0.02 s (one encoder frame: the DTW path may part by a frame
where the two packages' attention weights differ in their last bits)."""

import asyncio
import dataclasses
import threading

import jax
import numpy as np
import pydantic
import pytest

from audio_rag_tpu.asr import whisper_jax as jwa
from audio_rag_tpu.asr.mux import StreamingMux as JaxMux
from audio_rag_tpu.asr.streaming import StreamingASR as JaxStreamingASR
from audio_rag_tpu.asr.streaming import StreamingConfig as JaxStreamingConfig
from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.config import schema
from audio_rag_tpu_torch import config as tconfig
from audio_rag_tpu_torch.asr import whisper as twa
from audio_rag_tpu_torch.asr.fake import FakeASR
from audio_rag_tpu_torch.asr.mux import StreamingMux
from audio_rag_tpu_torch.asr.streaming import StreamingASR, StreamingConfig
from audio_rag_tpu_torch.audio.synth import speech_like
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.weights import whisper_params
from torch_llm_common import one_torch_thread  # noqa: F401

TOL = 0.02


def _pair(size, **fields):
    """Both packages' backends at ``size`` (f32, one device's mel, the
    ladder and the VAD off unless ``fields`` say otherwise), the JAX
    backend's seeded weights in the port's."""
    fields = {"compute_type": "float32", "vad_filter": False,
              "temperature_fallback": False, **fields}
    jasr = jwa.WhisperJaxASR(schema.ASRConfig(
        model_size=size, mel_sharded=False, **fields))
    jasr.load()
    tasr = twa.WhisperASR(tconfig.ASRConfig(model_size=size, **fields),
                          "cpu")
    tasr.load()
    tasr._params = whisper_params(jax.tree.map(np.asarray, jasr._params),
                                  tw.WHISPER_PRESETS[size], "cpu")
    return jasr, tasr


@pytest.fixture(scope="module")
def test_pair():
    jasr, tasr = _pair("test")
    yield jasr, tasr
    jasr.unload()


@pytest.fixture(scope="module")
def ml_pair():
    jasr, tasr = _pair("test-ml")
    yield jasr, tasr
    jasr.unload()


def _set(asrs, **fields):
    for asr in asrs:
        for k, v in fields.items():
            setattr(asr.config, k, v)


def _same_words(got, ref):
    assert [w.text for w in got] == [w.text for w in ref]
    for g, r in zip(got, ref):
        assert abs(g.start - r.start) <= TOL and abs(g.end - r.end) <= TOL


def _same_chunks(got, ref):
    """One segment list per chunk: texts, languages and log-probabilities
    of the same tokens; bounds and word times within :data:`TOL`."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [(s.text, s.language) for s in g] == \
            [(s.text, s.language) for s in r]
        for a, b in zip(g, r):
            assert abs(a.start - b.start) <= TOL and abs(a.end - b.end) <= TOL
            assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=1e-4)
            _same_words(a.words, b.words)


def _chunks(n, seconds=1.1):
    return [speech_like(int(SR * seconds), SR, seed=i) for i in range(n)]


# -- the chunk batch ----------------------------------------------------------------

@pytest.mark.parametrize("pad_to", [1, 4])
def test_chunk_batch_matches_jax(test_pair, pad_to):
    """Three chunks of one window: the JAX backend's segments and word
    times, and each chunk's own ``transcribe``."""
    jasr, tasr = test_pair
    chunks = _chunks(3)
    ref = jasr.transcribe_chunk_batch(chunks, SR, word_timestamps=True,
                                      pad_to=pad_to)
    got = tasr.transcribe_chunk_batch(chunks, SR, word_timestamps=True,
                                      pad_to=pad_to)
    _same_chunks(got, ref)
    assert any(got) and tasr.timings["windows"] == 3
    assert tasr.timings["batches"] == 1
    alone = [tasr.transcribe(c, SR, word_timestamps=True) for c in chunks]
    _same_chunks(got, alone)


def test_empty_and_silent_rows_match_jax(test_pair):
    jasr, tasr = test_pair
    chunks = [np.zeros(0, np.float32), _chunks(1, 1.0)[0],
              np.zeros(SR // 10, np.float32)]
    ref = jasr.transcribe_chunk_batch(chunks, SR, pad_to=4)
    got = tasr.transcribe_chunk_batch(chunks, SR, pad_to=4)
    _same_chunks(got, ref)
    assert got[0] == [] and got[2] == []
    assert tasr.transcribe_chunk_batch([np.zeros(0, np.float32)], SR) == [[]]


def _two_spans():
    """speech / 1.4 s of silence / speech: two energy-VAD spans."""
    return np.concatenate([speech_like(int(SR * 0.4), SR, seed=1),
                           np.zeros(int(SR * 1.4), np.float32),
                           speech_like(int(SR * 0.4), SR, seed=2)])


@pytest.mark.parametrize("pad_to", [None, 1])
def test_vad_spans_and_envelope_match_jax(test_pair, pad_to):
    """Under the energy VAD a chunk's rows are its speech spans, each with
    its offset; at ``pad_to`` 1 the two-span chunk collapses to its
    envelope cut to one window. Both as in the JAX backend, and (without
    a collapse) as the port's own ``transcribe``."""
    from audio_rag_tpu_torch.asr.vad import VADOptions, speech_segments

    jasr, tasr = test_pair
    _set((jasr, tasr), vad_filter=True, vad_backend="energy")
    try:
        two = _two_spans()
        lead = np.concatenate([np.zeros(SR // 2, np.float32),
                               speech_like(SR // 2, SR, seed=3)])
        spans = speech_segments(two, SR, VADOptions(backend="energy"))
        assert len(spans) == 2
        chunks = [two, lead]
        ref = jasr.transcribe_chunk_batch(chunks, SR, pad_to=pad_to)
        got = tasr.transcribe_chunk_batch(chunks, SR, pad_to=pad_to)
        _same_chunks(got, ref)
        assert got[1] and got[1][0].start > 0.3
        if pad_to is None:
            assert tasr.timings["windows"] == 3
            _same_chunks(got, [tasr.transcribe(c, SR) for c in chunks])
        else:
            env = tasr.transcribe_chunk_batch([two], SR, pad_to=1)[0]
            assert tasr.timings["windows"] == 1 and env
            assert abs(env[0].start - spans[0][0]) < 0.05
            assert env[-1].end <= spans[0][0] + tasr.window_seconds + 0.05
    finally:
        _set((jasr, tasr), vad_filter=False, vad_backend="auto")


# -- languages per row ----------------------------------------------------------

@pytest.mark.parametrize("pad_to", [None, 4])
def test_detect_language_rows_matches_jax(ml_pair, pad_to):
    """Each row detects on its own audio: the JAX offsets, whatever the
    batch's size or order."""
    jasr, tasr = ml_pair
    rows = _chunks(3, 1.0) + [np.zeros(SR // 2, np.float32)]
    ref = jasr.detect_language_rows(rows, pad_to=pad_to)
    got = tasr.detect_language_rows(rows, pad_to=pad_to)
    assert got == ref and len(got) == 4
    assert tasr.detect_language_rows(rows[::-1], pad_to=pad_to) == got[::-1]
    assert tasr.detect_language_rows(rows[:1]) == got[:1]


@pytest.mark.parametrize("language", [["en", "de"], [None, "de"],
                                      ["xx", None], None])
def test_languages_per_row_match_jax(ml_pair, language):
    """Fixed languages mixed in one batch, a detected one beside a fixed
    one, an unknown code ("en"), and every row detected: each row's prompt
    and segments carry its own language, as in the JAX backend and as each
    chunk's own ``transcribe``."""
    jasr, tasr = ml_pair
    chunks = _chunks(2, 1.0)
    ref = jasr.transcribe_chunk_batch(chunks, SR, language=language,
                                      pad_to=2)
    got = tasr.transcribe_chunk_batch(chunks, SR, language=language,
                                      pad_to=2)
    _same_chunks(got, ref)
    langs = language or [None, None]
    alone = [tasr.transcribe(c, SR, language=lang)
             for c, lang in zip(chunks, langs)]
    _same_chunks(got, alone)
    if language == ["en", "de"]:
        assert [s.language for segs in got for s in segs] == \
            ["en"] * len(got[0]) + ["de"] * len(got[1])


def test_scalar_callers_keep_their_prompts(ml_pair, monkeypatch):
    """``transcribe`` with one language builds the same prompt through the
    per-row path as the broadcast it replaced."""
    _, tasr = ml_pair
    seen = []
    orig = twa.greedy_decode

    def spy(params, dims, enc, prompt, *a, **kw):
        seen.append(prompt.clone())
        return orig(params, dims, enc, prompt, *a, **kw)

    monkeypatch.setattr(twa, "greedy_decode", spy)
    tasr.transcribe(_chunks(1, 2.0)[0], SR, language="de")
    st = tasr.tokens
    de = st.lang_base + tw.language_offset("de")
    assert [p.tolist() for p in seen] == [
        [[st.sot, de, st.transcribe, st.no_timestamps]] * 2]


# -- sessions -------------------------------------------------------------------

STREAM = dict(chunk_duration=4.0, overlap_duration=0.5, max_decode_tokens=112)
TINY = dict(model_size="tiny-synth", compute_type="float32",
            vad_filter=False, temperature_fallback=False)
PHRASES = ["the model learns fast and stops",
           "gradient descent minimizes the loss",
           "the spectrogram shows harmonic structure"]


def _speech(texts, seed):
    rng = np.random.default_rng(seed)
    gap = np.zeros(int(0.3 * SR), np.float32)
    parts = []
    for t in texts:
        parts += [synth_text(t, rng, noise_level=0.005), gap]
    return np.concatenate(parts)


def _results(results):
    return [(r.text, r.start, r.end, r.is_final) for r in results]


def _same_results(got, ref):
    assert _results(got) == _results(ref)
    for g, r in zip(got, ref):
        _same_words(g.words, r.words)


@pytest.fixture(scope="module")
def tiny():
    if not (ASSETS_DIR / "asr_tiny_synth.npz").exists():
        pytest.skip("trained ASR asset not built")
    asr = twa.WhisperASR(tconfig.ASRConfig(**TINY, **{
        "max_decode_tokens": STREAM["max_decode_tokens"]}), "cpu")
    asr.load()
    return asr


def test_process_stream_matches_jax(tiny):
    """The JAX end-to-end test's streaming settings (4 s chunks, 0.5 s
    overlap, 112 tokens) on three spoken phrases: the same chunks, texts,
    absolute times and words; the spoken words are heard."""
    audio = _speech(PHRASES, 3)
    jax_stream = JaxStreamingASR(
        schema.ASRConfig(**TINY, mel_sharded=False),
        JaxStreamingConfig(**STREAM))
    jax_stream.load()
    try:
        ref = list(jax_stream.process_stream(audio, SR))
    finally:
        jax_stream.unload()
    port = StreamingASR(tconfig.ASRConfig(**TINY), StreamingConfig(**STREAM),
                        device="cpu")
    assert port.backend.config.max_decode_tokens == 112
    port.load()
    try:
        got = list(port.process_stream(audio, SR))
    finally:
        port.unload()
    _same_results(got, ref)
    assert len(got) >= 3 and got[-1].is_final
    text = " ".join(r.text for r in got)
    assert sum(w in text for w in ("model", "learns", "gradient",
                                   "spectrogram")) >= 3, text
    assert port.state.value == "stopped" and not port.backend.is_loaded


def test_int16_bytes_stream_as_floats(test_pair):
    """int16 little-endian PCM fed as bytes gives the results of the same
    samples fed as floats; a second replay on one session starts over."""
    _, tasr = test_pair
    audio = speech_like(int(SR * 2.5), SR, seed=8)
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    sess = StreamingASR(tasr.config, StreamingConfig(
        chunk_duration=1.0, overlap_duration=0.2), backend=tasr)
    want = _replay(sess, pcm.astype(np.float32) / 32768.0)

    async def feed():
        out = []
        await sess.start()
        raw = pcm.tobytes()
        for i in range(0, len(raw), SR):  # 0.5 s of int16 a feed
            r = await sess.add_audio(raw[i: i + SR])
            if r is not None:
                out.append(r)
        return out + [await sess.stop()]

    try:
        got = asyncio.run(feed())
    finally:
        sess.unload()
    assert len(want) >= 2
    _same_results(got, want)
    assert tasr.is_loaded


def _replay(session, audio):
    session.load()
    return list(session.process_stream(audio, SR))


@pytest.mark.parametrize("backend", ["fake", "tiny-synth"])
def test_sessions_sharing_a_mux_equal_their_replays(backend, request):
    """Two sessions, each on its own speech, stream at once through one
    mux: each equals its replay without the mux, and the mux batched."""
    if backend == "fake":
        asr, stream = FakeASR(), StreamingConfig(chunk_duration=1.0,
                                                 overlap_duration=0.2)
        audios = [speech_like(SR * 3, SR, seed=5),
                  speech_like(int(SR * 2.6), SR, seed=6)]
    else:
        asr, stream = request.getfixturevalue("tiny"), StreamingConfig(
            **STREAM)
        audios = [_speech(PHRASES[:2], 4), _speech(PHRASES[1:], 5)]
    cfg = tconfig.ASRConfig(**TINY)
    plain = StreamingASR(cfg, stream, backend=asr)  # replays start over
    want = [_replay(plain, audio) for audio in audios]
    plain.unload()
    assert asr.is_loaded  # a session leaves a backend it did not build
    mux = StreamingMux(asr, max_batch=2, linger_ms=50.0)
    try:
        sessions = [StreamingASR(cfg, stream, mux=mux) for _ in audios]
        outs: list = [None] * len(audios)

        def run(i):
            outs[i] = _replay(sessions[i], audios[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(audios))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for got, ref in zip(outs, want):
            _same_results(got, ref)
        served = sum(len(w) for w in want)
        assert mux.chunks_served == served  # the warm-up is no chunk
        assert mux.batches_run < served, "no chunks were batched"
        for s in sessions:
            s.unload()
        assert asr.is_loaded
    finally:
        mux.stop()


def test_session_language_sticks_from_its_own_audio(ml_pair):
    """A muxed session without a language keeps the first one its chunks
    detect (the JAX session's), and ``reset`` clears it."""
    jasr, tasr = ml_pair
    stream = dict(chunk_duration=1.0, overlap_duration=0.2)
    audio = speech_like(SR * 3, SR, seed=12)
    jmux = JaxMux(jasr, max_batch=2)
    jmux.warmed = True  # its programs compiled by the tests above
    mux = StreamingMux(tasr, max_batch=2)
    try:
        jsess = JaxStreamingASR(jasr.config, JaxStreamingConfig(**stream),
                                mux=jmux)
        jsess.load()
        ref = list(jsess.process_stream(audio, SR))
        sess = StreamingASR(tasr.config, StreamingConfig(**stream), mux=mux)
        sess.load()
        got = list(sess.process_stream(audio, SR))
        _same_results(got, ref)
        assert sess._session_lang is not None
        assert sess._session_lang == jsess._session_lang
        first = tasr.detect_language_rows([audio[:SR]])[0]
        assert sess._session_lang == tw.WHISPER_LANGUAGES[first]
        asyncio.run(sess.reset())
        assert sess._session_lang is None
    finally:
        jmux.stop()
        mux.stop()


# -- config, departures and the JAX package's defect ------------------------------

def test_streaming_config_is_the_schemas():
    """Defaults and bounds of ``StreamingSchema`` and the session's
    ``StreamingConfig`` as ``config/schema.py`` and ``asr/streaming.py``
    declare them; ``to_runtime`` carries the same fields."""
    jax_fields = schema.StreamingSchema.model_fields
    port = tconfig.StreamingSchema()
    assert {f.name: getattr(port, f.name)
            for f in dataclasses.fields(port)} == {
        name: f.default for name, f in jax_fields.items()}
    for name, lo, hi in (("chunk_duration", 0.5, 30.0),
                         ("overlap_duration", 0.0, 10.0),
                         ("max_decode_tokens", 8, 224),
                         ("max_sessions", 1, 64)):
        step = 1 if isinstance(lo, int) else 0.01
        for v in (lo, hi):
            schema.StreamingSchema(**{name: v})
            tconfig.StreamingSchema(**{name: v})
        for v in (lo - step, hi + step):
            with pytest.raises(pydantic.ValidationError):
                schema.StreamingSchema(**{name: v})
            with pytest.raises(ConfigError, match=name):
                tconfig.StreamingSchema(**{name: v})
    assert dataclasses.asdict(StreamingConfig()) == \
        dataclasses.asdict(JaxStreamingConfig())
    low = dict(chunk_duration=3.0, overlap_duration=0.6,
               max_decode_tokens=40, min_avg_logprob=-0.5)
    assert dataclasses.asdict(tconfig.StreamingSchema(**low).to_runtime()) \
        == dataclasses.asdict(schema.StreamingSchema(**low).to_runtime())
    assert tconfig.AudioRAGConfig(device="cpu").streaming == port


def test_min_avg_logprob_is_not_applied(test_pair):
    """Set above every chunk's average log-probability, the threshold
    drops nothing, in either package (it is declared, carried and never
    read: ROADMAP.md §3)."""
    jasr, tasr = test_pair
    stream = dict(chunk_duration=1.0, overlap_duration=0.2,
                  min_avg_logprob=0.0)
    audio = speech_like(int(SR * 2.5), SR, seed=9)
    jsess = JaxStreamingASR(jasr.config, JaxStreamingConfig(**stream),
                            backend=jasr)
    jsess.load()
    ref = list(jsess.process_stream(audio, SR))
    sess = StreamingASR(tasr.config, StreamingConfig(**stream), backend=tasr)
    got = _replay(sess, audio)
    sess.unload()
    _same_results(got, ref)
    lps = [s.avg_logprob for s in tasr.transcribe(audio[:SR], SR)]
    assert lps and max(lps) < 0.0
    assert any(r.text for r in got)


class _Broken(FakeASR):
    def transcribe(self, *a, **kw):
        raise RuntimeError("kernel launch failed")

    def transcribe_chunk_batch(self, *a, **kw):
        raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("route", ["mux", "session"])
def test_warm_up_failures_raise(route):
    """The JAX session and mux log a failing warm-up and stream on; the
    port raises, and a mux that failed to warm tries again next time."""
    stream = StreamingConfig(chunk_duration=1.0, overlap_duration=0.2)
    mux = StreamingMux(_Broken(), max_batch=2) if route == "mux" else None
    try:
        sess = StreamingASR(tconfig.ASRConfig(), stream, backend=_Broken(),
                            mux=mux)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            sess.load()
        assert not sess.is_loaded
        if mux is not None:
            assert not mux.warmed
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                mux.ensure_ready()
        with pytest.raises(Exception, match="not loaded"):
            list(sess.process_stream(np.zeros(SR, np.float32), SR))
        sess.unload()
    finally:
        if mux is not None:
            mux.stop()


def test_fake_mux_batches_languages_and_keys():
    """The mux's key is (sample rate, word times); languages ride one
    batch as a per-chunk list; mixed keys go out in their own rounds; a
    stopped mux refuses chunks."""
    seen = []
    backend = FakeASR()
    orig = backend.transcribe_chunk_batch

    def spy(chunks, *a, **kw):
        seen.append((len(chunks), kw["language"], kw["pad_to"],
                     kw["word_timestamps"]))
        return orig(chunks, *a, **kw)

    backend.transcribe_chunk_batch = spy
    mux = StreamingMux(backend, max_batch=4, linger_ms=80.0)
    chunk = speech_like(SR, SR, seed=0)
    try:
        futs = [mux.submit(chunk, SR, language=lang)
                for lang in ("en", "de", None, "fr")]
        assert all(f.result(timeout=30) for f in futs)
        assert seen == [(4, ["en", "de", None, "fr"], 4, False)]
        futs = [mux.submit(chunk, SR, word_timestamps=i % 2 == 0)
                for i in range(4)]
        out = [f.result(timeout=30) for f in futs]
        assert all(out) and all(s.words for s in out[0])
        assert sorted(s[3] for s in seen[1:]) == [False, True]
        assert mux.chunks_served == 8 and mux.batches_run == 3
    finally:
        mux.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        mux.submit(chunk, SR)


def test_async_stream_equals_replay():
    """``process_stream_async`` over an async iterator of 0.5 s pieces
    yields what ``process_stream`` returns, the final flush included."""
    stream = StreamingConfig(chunk_duration=1.0, overlap_duration=0.2)
    audio = speech_like(int(SR * 2.7), SR, seed=4)
    sess = StreamingASR(tconfig.ASRConfig(), stream, backend=FakeASR())
    want = _replay(sess, audio)

    async def pieces():
        for i in range(0, len(audio), SR // 2):
            yield audio[i: i + SR // 2]

    async def collect():
        return [r async for r in sess.process_stream_async(pieces())]

    try:
        got = asyncio.run(collect())
    finally:
        sess.unload()
    assert len(want) == 3 and want[-1].is_final
    assert _results(got) == _results(want)
