"""The rest of greedy Whisper transcription in the port against the JAX
package on the CPU: sampled ``greedy_decode`` (JAX's PRNG, temperatures
0.2 and 0.4), the quality gates and the compression ratio, the
temperature-fallback ladder through ``transcribe``, language detection on
the multilingual ``test-ml`` preset, conditioning on previous text on the
trained tiny-synth model, the ``test-ml`` weight tree, and the config's
defaults against ``config/schema.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_rag_tpu.asr import whisper_jax as jwa
from audio_rag_tpu.audio.charvoice import SR, synth_text
from audio_rag_tpu.config import schema
from audio_rag_tpu.models import whisper as jw
from audio_rag_tpu_torch import config as tconfig
from audio_rag_tpu_torch.asr import whisper as twa
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR
from audio_rag_tpu_torch.models import whisper as tw
from audio_rag_tpu_torch.ops import random as R
from audio_rag_tpu_torch.weights import (
    whisper_params,
    whisper_q8_params,
    whisper_spec,
)
from torch_llm_common import one_torch_thread  # noqa: F401

DIMS = jw.WHISPER_PRESETS["test"]
TDIMS = tw.WHISPER_PRESETS["test"]
ST = jw.SpecialTokens.for_dims(DIMS)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def test_model():
    """Seeded ``test`` weights in both packages, and one batch of random
    log-mel encoded by each."""
    jp = jw.init_whisper(jax.random.PRNGKey(3), DIMS)
    tp = whisper_params(_np_tree(jp), TDIMS, "cpu")
    mel = np.random.default_rng(0).standard_normal(
        (4, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    jenc = jw.encode(jp, DIMS, jnp.asarray(mel), jnp.float32)
    tenc = tw.encode(tp, TDIMS, torch.from_numpy(mel), torch.float32)
    return jp, tp, jenc, tenc


def _prompt(n):
    return np.array([[ST.sot, ST.lang_base, ST.transcribe,
                      ST.no_timestamps]] * n, np.int32)


@pytest.mark.parametrize("profile,temperature", [
    ("f32", 0.2), ("f32", 0.4), ("int8+skv8", 0.4)])
def test_sampled_greedy_decode_matches_jax(test_model, temperature,
                                           profile):
    """Sampled tokens equal the jitted JAX decode's (as its backend runs
    it, seeded ``int(T * 100)``) in f32 and with int8 cross K/V, int8
    weights and the int8 self cache; avg logprob within 1e-4 in f32 (1e-3
    quantized, where the two packages' int8 products round apart)."""
    jp, tp, jenc, tenc = test_model
    quant = profile != "f32"
    jq8 = (jax.jit(lambda p: jw.quantize_decoder_weights(p, DIMS, 8))(jp)
           if quant else None)
    run = jax.jit(lambda p, q, e, pr: jw.greedy_decode(
        p, DIMS, e, pr, 8, ST.eot, dtype=jnp.float32,
        temperature=temperature,
        rng=jax.random.PRNGKey(int(temperature * 100)),
        no_speech_id=ST.no_speech, cross_kv_quantize=quant, decoder_q8=q,
        self_kv_int8=quant))
    jt, jl, jn = run(jp, jq8, jenc, jnp.asarray(_prompt(4)))
    tq8 = whisper_q8_params(_np_tree(jq8), TDIMS, "cpu") if quant else None
    tt, tl, tn = tw.greedy_decode(
        tp, TDIMS, tenc, torch.from_numpy(_prompt(4)).long(), 8, ST.eot,
        dtype=torch.float32, no_speech_id=ST.no_speech,
        cross_kv_quantize=quant, decoder_q8=tq8, self_kv_int8=quant,
        temperature=temperature,
        rng=R.PRNGKey(int(temperature * 100)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-3 if quant else 1e-4)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    # sampling differs from the argmax, and the seed matters
    greedy = tw.greedy_decode(
        tp, TDIMS, tenc, torch.from_numpy(_prompt(4)).long(), 8, ST.eot,
        dtype=torch.float32, cross_kv_quantize=quant, decoder_q8=tq8,
        self_kv_int8=quant)[0]
    assert not torch.equal(greedy, tt)


# -- the gates ------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "", "a", "tok1 tok2 tok3", "the the the the the the the the the the",
    "gradient descent minimizes the loss", "ééé ünïcödé " * 7,
    "tok695 " * 40])
def test_compression_ratio_matches_jax(text):
    assert twa.compression_ratio(text) == jwa._compression_ratio(text)


def test_seeds_truncate_as_python_floats():
    """The retries' seed is ``int(temperature * 100)``: 0.29 gives 28."""
    assert [int(t * 100) for t in (0.2, 0.29, 0.4, 0.57)] == [20, 28, 40, 56]


@pytest.fixture(scope="module")
def backends():
    """Both packages' backends at the ``test`` preset (f32, no VAD, one
    device's mel), the JAX backend's seeded weights in the port's."""
    jasr = jwa.WhisperJaxASR(schema.ASRConfig(
        model_size="test", compute_type="float32", vad_filter=False,
        mel_sharded=False, window_batch_size=2))
    jasr.load()
    tasr = twa.WhisperASR(tconfig.ASRConfig(
        model_size="test", compute_type="float32", vad_filter=False,
        window_batch_size=2), "cpu")
    tasr.load()
    tasr._params = whisper_params(_np_tree(jasr._params), TDIMS, "cpu")
    yield jasr, tasr
    jasr.unload()


def _with_config(asr, **fields):
    for k, v in fields.items():
        setattr(asr.config, k, v)


def test_gates_match_jax(backends):
    jasr, tasr = backends
    rng = np.random.default_rng(5)
    toks = np.full((6, 12), ST.eot, np.int32)
    toks[:, :4] = _prompt(6)
    toks[0, 4:12] = 7                        # a repetition loop
    toks[1, 4:10] = rng.integers(0, 900, 6)  # varied text
    toks[2, 4:6] = [ST.timestamp_base, 5]    # a timestamp, then text
    toks[3, 4:12] = [3, 4] * 4
    lp = np.array([-0.5, -0.5, -2.0, -0.2, -0.9, -1.1], np.float32)
    for thr in (2.4, 1.3, 0.0):
        _with_config(jasr, compression_ratio_threshold=thr)
        _with_config(tasr, compression_ratio_threshold=thr)
        ref = jasr._gates_failed(toks.copy(), lp.copy(), prompt_len=4)
        got = tasr._gates_failed(toks.copy(), lp.copy(), 4)
        assert got.tolist() == ref.tolist()
    assert got.tolist() == [False, False, True, False, False, True]
    _with_config(jasr, compression_ratio_threshold=2.4)
    _with_config(tasr, compression_ratio_threshold=2.4)


def _noise(seconds, seed):
    return (0.05 * np.random.default_rng(seed).standard_normal(
        int(seconds * 16000))).astype(np.float32)


def _jax_temps(monkeypatch, jasr, seen):
    """Record each window's final temperature in the JAX backend."""
    orig = jasr._transcribe_batch

    def spy(windows, lang, **kw):
        per, meta = orig(windows, lang, **{**kw, "return_meta": True})
        seen.extend(float(t) for t in meta["final_temp"][:len(windows)])
        if kw.get("return_meta"):
            return per, meta
        return [s for segs in per for s in segs]

    monkeypatch.setattr(jasr, "_transcribe_batch", spy)


def _segs(segments):
    return [(s.text, s.start, s.end, s.avg_logprob, s.language)
            for s in segments]


@pytest.mark.parametrize("gates", [
    {},  # the defaults: every window fails the logprob gate
    # repetition only: some windows pass at 0.0, others retry
    {"logprob_threshold": -9.0, "compression_ratio_threshold": 1.43},
])
def test_ladder_through_transcribe_matches_jax(backends, monkeypatch,
                                               gates):
    """Three windows in a batch of two (the tail padded): the same final
    temperature per window and the same segments, the retries decoding
    the whole padded batch."""
    jasr, tasr = backends
    for asr in (jasr, tasr):
        _with_config(asr, **{"logprob_threshold": -1.0,
                             "compression_ratio_threshold": 2.4, **gates})
    audio = _noise(3.3, 1)
    jtemps = []
    _jax_temps(monkeypatch, jasr, jtemps)
    ref = jasr.transcribe(audio, 16000)
    got = tasr.transcribe(audio, 16000)
    assert tasr.window_temps == jtemps and len(jtemps) == 3
    assert _segs(got) == _segs(ref)
    if not gates:
        assert jtemps == [np.float32(0.4)] * 3
        assert tasr.timings["fallback_decodes"] == 4  # 2 batches × 2 rungs
    else:
        assert len(set(jtemps)) > 1, jtemps
    assert tasr.timings["fallback_steps"] > 0
    for asr in (jasr, tasr):
        _with_config(asr, logprob_threshold=-1.0,
                     compression_ratio_threshold=2.4)


def test_ladder_off_and_under_beam_decodes_once(backends):
    jasr, tasr = backends
    audio = _noise(2.0, 2)
    for fields in ({"temperature_fallback": False}, {"decode": "beam"}):
        _with_config(tasr, **fields)
        tasr.transcribe(audio, 16000)
        assert tasr.timings["fallback_decodes"] == 0
        assert tasr.window_temps == [0.0, 0.0]
    _with_config(tasr, temperature_fallback=True, decode="greedy")


# -- language detection -----------------------------------------------------------

@pytest.fixture(scope="module")
def ml_backends():
    jasr = jwa.WhisperJaxASR(schema.ASRConfig(
        model_size="test-ml", compute_type="float32", vad_filter=False,
        mel_sharded=False, temperature_fallback=False))
    jasr.load()
    tasr = twa.WhisperASR(tconfig.ASRConfig(
        model_size="test-ml", compute_type="float32", vad_filter=False,
        temperature_fallback=False), "cpu")
    tasr.load()
    tasr._params = whisper_params(_np_tree(jasr._params),
                                  tw.WHISPER_PRESETS["test-ml"], "cpu")
    yield jasr, tasr
    jasr.unload()


def test_detect_language_matches_jax(ml_backends):
    """The same offset and probability within 1e-4 on audio shorter and
    longer than the window; the model's call on encoder states too."""
    jasr, tasr = ml_backends
    for seconds, seed in ((0.7, 3), (2.5, 4)):
        audio = _noise(seconds, seed)
        ref = jasr.detect_language(audio, 16000)
        got = tasr.detect_language(audio, 16000)
        assert got[0] == ref[0]
        assert abs(got[1] - ref[1]) <= 1e-4
        assert 0 <= got[0] < 99


def test_transcribe_detects_the_language_on_large_vocabularies(ml_backends,
                                                               monkeypatch,
                                                               caplog):
    """No language given: the first window's language goes into every
    prompt and segment, as in the JAX backend; an explicit unknown code
    falls back to "en" with a warning; a small vocabulary never detects."""
    jasr, tasr = ml_backends
    audio = _noise(2.5, 4)
    offset = tasr.detect_language(audio, 16000)[0]
    ref = jasr.transcribe(audio, 16000)
    got = tasr.transcribe(audio, 16000)
    assert _segs(got) == _segs(ref)
    assert {s.language for s in got} <= {tw.WHISPER_LANGUAGES[offset]}
    assert tasr.timings["detect_s"] > 0
    with caplog.at_level("WARNING"):
        bad = tasr.transcribe(audio, 16000, language="xx")
    assert "unknown language 'xx'" in caplog.text
    assert _segs(bad) == _segs(jasr.transcribe(audio, 16000, language="xx"))
    small = twa.WhisperASR(tconfig.ASRConfig(
        model_size="test", vad_filter=False, compute_type="float32",
        temperature_fallback=False), "cpu")
    calls = []
    monkeypatch.setattr(small, "detect_language",
                        lambda *a: calls.append(a) or (0, 1.0))
    small.transcribe(audio, 16000)
    assert not calls


# -- conditioning on previous text ------------------------------------------------

TURNS = ["gradient descent minimizes the loss function",
         "the spectrogram shows harmonic structure",
         "attention layers mix token information"]


@pytest.mark.skipif(not (ASSETS_DIR / "asr_tiny_synth.npz").exists(),
                    reason="trained ASR asset not built")
def test_conditioned_transcription_matches_jax(monkeypatch):
    """``condition_on_previous_text`` on tiny-synth over three 6 s
    windows: the same segments as the JAX backend, with prompts longer
    than 16 tokens primed teacher-forced."""
    rng = np.random.default_rng(7)
    win = 6 * SR
    audio = np.zeros(len(TURNS) * win, np.float32)
    for i, text in enumerate(TURNS):
        wav = synth_text(text, rng, noise_level=0.005)[: win - SR // 4]
        audio[i * win + SR // 10: i * win + SR // 10 + wav.size] = wav
    jasr = jwa.WhisperJaxASR(schema.ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        mel_sharded=False, condition_on_previous_text=True))
    jasr.load()
    tasr = twa.WhisperASR(tconfig.ASRConfig(
        model_size="tiny-synth", compute_type="float32", vad_filter=False,
        condition_on_previous_text=True), "cpu")
    prompts = []
    orig = tw.greedy_decode

    def spy(params, dims, enc, prompt, *args, **kw):
        prompts.append(prompt.shape[1])
        return orig(params, dims, enc, prompt, *args, **kw)

    monkeypatch.setattr(twa, "greedy_decode", spy)
    try:
        ref = jasr.transcribe(audio, SR)
    finally:
        jasr.unload()
    got = tasr.transcribe(audio, SR)
    assert [(s.text, s.start, s.end, s.avg_logprob) for s in got] == [
        (s.text, s.start, s.end, s.avg_logprob) for s in ref]
    assert tasr.timings["windows"] == tasr.timings["batches"] == 3
    assert prompts[0] == 4 and max(prompts) > 16, prompts
    assert "gradient" in got[0].text


def test_prompt_buckets_match_jax():
    for size in ("tiny-synth", "test", "large-v3"):
        jasr = jwa.WhisperJaxASR(schema.ASRConfig(model_size=size))
        tasr = twa.WhisperASR(tconfig.ASRConfig(model_size=size), "cpu")
        assert tasr._prompt_buckets() == jasr._prompt_buckets()


# -- the test-ml tree, the config ----------------------------------------------------

def test_test_ml_preset_and_tree_carry_over():
    dims = tw.WHISPER_PRESETS["test-ml"]
    assert dims.__dict__ == jw.WHISPER_PRESETS["test-ml"].__dict__
    assert (tw.SpecialTokens.for_dims(dims).__dict__
            == jw.SpecialTokens.for_dims(jw.WHISPER_PRESETS["test-ml"])
            .__dict__)
    tree = _np_tree(jw.init_whisper(jax.random.PRNGKey(1),
                                    jw.WHISPER_PRESETS["test-ml"]))
    params = whisper_params(tree, dims, "cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_ref:
        node = params
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert params["decoder"]["tok_emb"]["table"].shape == (51865, 64)
    assert set(whisper_spec(dims)) == {
        "/".join(k.key for k in path) for path, _ in flat_ref}


SCHEMA_PAIRS = [
    (tconfig.ASRConfig, schema.ASRConfig),
    (tconfig.DiarizationConfig, schema.DiarizationConfig),
    (tconfig.AlignmentConfig, schema.AlignmentConfig),
    (tconfig.ChunkingConfig, schema.ChunkingConfig),
    (tconfig.EmbeddingConfig, schema.EmbeddingConfig),
    (tconfig.RetrievalConfig, schema.RetrievalConfig),
    (tconfig.RerankingConfig, schema.RerankingConfig),
    (tconfig.GenerationConfig, schema.GenerationConfig),
    (tconfig.ExpansionConfig, schema.ExpansionConfig),
]

#: fields of the port's config that the schema does not have, by design
PORT_ONLY = {"ASRConfig": {"seed"}, "EmbeddingConfig": {"seed"},
             "RerankingConfig": {"seed"}, "GenerationConfig": {"seed"}}


@pytest.mark.parametrize("port,ref", SCHEMA_PAIRS,
                         ids=[p.__name__ for p, _ in SCHEMA_PAIRS])
def test_config_defaults_are_the_schemas(port, ref):
    """Every field the port's dataclass shares with the schema has the
    schema's default (ROADMAP fault 8: the port defaulted to tiny-synth and
    eval-small); the port-only fields are the named departures."""
    got = {f.name: getattr(port(), f.name) for f in dataclasses.fields(port)}
    want = ref().model_dump()
    assert set(got) - set(want) == PORT_ONLY.get(port.__name__, set())
    shared = set(got) & set(want)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


def test_config_bounds_and_the_pipeline_passes_the_fields_through():
    from audio_rag_tpu_torch.core.exceptions import ConfigError
    from audio_rag_tpu_torch.pipeline import AudioRAG

    c = tconfig.ASRConfig()
    assert (c.model_size, c.temperature_fallback, c.fallback_temperatures,
            c.compression_ratio_threshold, c.language) == (
        "large-v3", True, [0.2, 0.4], 2.4, None)
    assert tconfig.EmbeddingConfig().model == "BAAI/bge-m3"
    for bad in ({"prompt_reset_on_temperature": -0.1},
                {"no_speech_threshold": 1.5}, {"window_batch_size": 0},
                {"max_decode_tokens": 4}):
        with pytest.raises(ConfigError):
            tconfig.ASRConfig(**bad)
    asr = tconfig.ASRConfig(model_size="test", temperature_fallback=False,
                            fallback_temperatures=[0.3],
                            compression_ratio_threshold=1.9,
                            condition_on_previous_text=True,
                            prompt_reset_on_temperature=0.1)
    rag = AudioRAG(tconfig.AudioRAGConfig(asr=asr, device="cpu"))
    assert rag.asr.config is asr
