"""The port's configuration loading against the JAX package's:
``load_config`` key by key on the shipped profiles (with environment
variables and overrides), the reference-name aliases, pydantic's lax
coercion and refusals, the TPU-only fields, and the port's YAML reader
against ``yaml.safe_load``."""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml
from pydantic import BaseModel

from audio_rag_tpu.config import loader as jloader
from audio_rag_tpu.config.schema import AudioRAGConfig as JaxConfig
from audio_rag_tpu.core.exceptions import ConfigError as JaxConfigError
from audio_rag_tpu_torch.config import (
    TPU_ONLY_FIELDS,
    AudioRAGConfig,
    apply_env_overrides,
    deep_merge,
    load_config,
)
from audio_rag_tpu_torch.config import loader as tloader
from audio_rag_tpu_torch.config._yaml import parse_yaml, read_yaml
from audio_rag_tpu_torch.core.exceptions import ConfigError

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"
PROFILES = [None, "development", "production", "low_latency"]
PORT_ONLY = {"device", "asr.seed", "embedding.seed", "reranking.seed",
             "generation.seed"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in list(__import__("os").environ):
        if name.startswith("AUDIO_RAG"):
            monkeypatch.delenv(name)


def _flat(d: dict, pre: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[f"{pre}{k}"] = v
    return out


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


def _assert_same_config(port: AudioRAGConfig, ref) -> None:
    got = _flat(dataclasses.asdict(port))
    want = _flat(ref.model_dump())
    assert set(want) - set(got) == set(TPU_ONLY_FIELDS)
    assert set(got) - set(want) == PORT_ONLY
    bad = {k: (got[k], want[k]) for k in set(got) & set(want)
           if not _same(got[k], want[k])}
    assert not bad


def _both(**kw):
    """(port config or its ConfigError, JAX config or its ConfigError)."""
    out = []
    for fn, err in ((load_config, ConfigError),
                    (jloader.load_config, JaxConfigError)):
        try:
            out.append(fn(**kw))
        except err as exc:
            out.append(exc)
    return out


# -- the YAML reader ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["base", "development", "production",
                                  "low_latency"])
def test_shipped_profiles_read_as_safe_load(name):
    path = CONFIGS / f"{name}.yaml"
    assert read_yaml(path) == yaml.safe_load(path.read_text())


def test_queue_profile_is_refused_with_its_line():
    with pytest.raises(ConfigError, match=r"queue\.yaml:\d+"):
        read_yaml(CONFIGS / "queue.yaml")


SCALARS = [
    "true", "True", "TRUE", "false", "yes", "No", "on", "OFF", "y", "n",
    "~", "null", "Null", "NULL", "nULL", "", "14.0", "1e-3", "1.0e-3",
    "1.0e3", "-.inf", ".NaN", ".5", "+.5", "1_000", "017", "08", "0x1F",
    "0b101", "1:30", "12:30:00", "1.5:10", "-7", "+7", "0", "-0", "007.5",
    "'yes'", '"null"', "'it''s'", '"a\\tb\\u00e9\\x41"', "\"x # c\"",
    "x # comment", "x#c", "http://host:8000/x", "./data", "/data/x",
    "llama3.2:3b", "BAAI/bge-m3", ":x", "a b  c", "[0.2, 0.4]", "[]",
    "[1, two, '3', 4.0, ]", "[ yes , ~ ]", '["a, b", c]', "- ",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    doc = f"key: {text}\n"
    try:
        want = yaml.safe_load(doc)
    except yaml.YAMLError:
        with pytest.raises(ConfigError):
            parse_yaml(doc)
        return
    got = parse_yaml(doc)
    assert set(got) == {"key"}
    if isinstance(want["key"], float) and math.isnan(want["key"]):
        assert math.isnan(got["key"])
    else:
        assert got == want and type(got["key"]) is type(want["key"])


def test_structure_reads_as_safe_load():
    doc = ("# head\n\nasr:\n  model_size: base   # trailing\n"
           "  nested:\n    deeper: 1\n    empty:\n  after: x\n"
           "'quoted key': 2\nempty_top:\n# between\nlast: [1, 2]\n"
           "dup: 1\ndup: 2\n")
    assert parse_yaml(doc) == yaml.safe_load(doc)
    assert parse_yaml("") == {} == parse_yaml("# only a comment\n\n")


@pytest.mark.parametrize("doc", [
    "a:\n\tb: 1\n",  # a tab
    "a: &x 1\nb: *x\n",  # anchor, alias
    "a: !!str 1\n",  # tag
    "a:\n  - 1\n  - 2\n",  # block sequence
    "a: {b: 1}\n",  # flow mapping
    "a: |\n  text\n",  # block scalar
    "a: one\n  two\n",  # multi-line plain scalar
    "a: 'one\n  two'\n",  # multi-line quoted scalar
    "a: [1,\n  2]\n",  # multi-line flow sequence
    "a: [[1], 2]\n",  # nested flow sequence
    "? a\n: b\n",  # complex key
    "a: 2020-01-01\n",  # timestamp
    "a: x: y\n",  # mapping in a value
    "---\na: 1\n",  # document marker
    "a:\n    b: 1\n  c: 2\n",  # bad indentation
])
def test_unsupported_yaml_raises_with_its_line(doc):
    with pytest.raises(ConfigError, match=r"<string>:\d+"):
        parse_yaml(doc)


@pytest.mark.parametrize("doc", ["5\n", "just text\n", "[1, 2]\n"])
def test_a_root_that_is_not_a_mapping_raises(doc):
    assert not isinstance(yaml.safe_load(doc), dict)
    with pytest.raises(ConfigError, match="mapping"):
        parse_yaml(doc)


# -- load_config against the JAX loader -------------------------------------------------

ENV_VARS = {
    "AUDIO_RAG__ASR__MODEL_SIZE": "tiny-synth",
    "AUDIO_RAG__ASR__VAD_THRESHOLD": "1",
    "AUDIO_RAG__ASR__WINDOW_BATCH_SIZE": "16.0",
    "AUDIO_RAG__ASR__LANGUAGE": "en",
    "AUDIO_RAG__RETRIEVAL__TOP_K": "7",
    "AUDIO_RAG__RETRIEVAL__PERSIST_DIR": "null",
    "AUDIO_RAG__CONTEXTUAL__ENABLED": "yes",
    "AUDIO_RAG__GENERATION__MAX_TOKENS": "64",
    "AUDIO_RAG__EXPANSION__PRF_TERMS": "5",
    "AUDIO_RAG__LOG_LEVEL": "DEBUG",
    "AUDIO_RAG__DEVICE": "cpu",
}
OVERRIDES = {"asr": {"decode": "beam", "beam_size": 3.0,
                     "fallback_temperatures": [0.1, "0.3"]},
             "chunking": {"strategy": "fixed", "max_tokens": "120"},
             "embedding": {"backend": "fake", "normalize": "off"},
             "tts": {"sample_rate": 16000}, "streaming": {
                 "chunk_duration": 3}, "resources": {"max_hbm_gb": 20}}


@pytest.mark.parametrize("env", PROFILES, ids=lambda e: e or "base")
@pytest.mark.parametrize("variant", ["plain", "env_vars", "overrides"])
def test_profiles_load_as_jax(env, variant, monkeypatch):
    kw = {"env": env, "configs_dir": CONFIGS}
    if variant == "env_vars":
        for name, value in ENV_VARS.items():
            monkeypatch.setenv(name, value)
    if variant == "overrides":
        kw["overrides"] = OVERRIDES
    port, ref = _both(**kw)
    _assert_same_config(port, ref)
    assert port.device == ("cpu" if variant == "env_vars" else "cuda")


def test_environment_names_the_profile(monkeypatch):
    monkeypatch.setenv("AUDIO_RAG_ENV", "production")
    port, ref = _both(configs_dir=CONFIGS)
    _assert_same_config(port, ref)
    assert port.retrieval.quantize_dense and port.generation.speculative_k == 8


def test_layering_and_explicit_file(tmp_path):
    (tmp_path / "base.yaml").write_text(
        "asr:\n  model_size: base\nchunking:\n  max_tokens: 500\n"
        "retrieval:\n  top_k: 3\n")
    (tmp_path / "dev.yaml").write_text("chunking:\n  max_tokens: 128\n")
    extra = tmp_path / "extra.yaml"
    extra.write_text("retrieval:\n  top_k: 9\n")
    port, ref = _both(config_path=extra, env="dev", configs_dir=tmp_path)
    _assert_same_config(port, ref)
    assert (port.asr.model_size, port.chunking.max_tokens,
            port.retrieval.top_k) == ("base", 128, 9)
    for got in _both(config_path=tmp_path / "nope.yaml",
                     configs_dir=tmp_path):
        assert isinstance(got, (ConfigError, JaxConfigError))
    port, ref = _both(configs_dir=tmp_path / "missing_dir")
    _assert_same_config(port, ref)


REFERENCE_YAML = """
asr:
  backend: faster-whisper
  model_size: large-v3
  device: auto
  compute_type: float16
  vad_filter: true
  vad_threshold: 0.5
diarization:
  backend: nemo
  min_speech_duration_ms: 250
chunking:
  strategy: speaker_turn
  max_tokens: 256
contextual:
  enabled: false
  window_size: 1
embedding:
  backend: bge-m3
  batch_size: 32
retrieval:
  backend: qdrant
  collection_name: audio_rag
  search_type: hybrid
  qdrant_host: localhost
  qdrant_port: 6333
reranking:
  backend: bge-reranker
  initial_k: 20
expansion:
  backend: hyde
generation:
  backend: ollama
  model: llama3.2:3b
  temperature: 0.7
tts:
  backend: piper
  fallback_backend: edge-tts
resources:
  max_vram_gb: 12.0
  unload_after_idle_seconds: 300
"""


@pytest.mark.parametrize("text,want", [
    (REFERENCE_YAML, {"asr.backend": "whisper-jax",
                      "asr.compute_type": "bfloat16",
                      "diarization.backend": "clustering",
                      "retrieval.backend": "tpu",
                      "generation.backend": "llm-jax",
                      "generation.model": "llama-3.2-3b",
                      "tts.fallback_backend": "null", "tts.backend": "piper",
                      "expansion.backend": "hyde"}),
    ("asr:\n  backend: faster-whisper\n  compute_type: int8\n",
     {"asr.compute_type": "bfloat16", "asr.cross_kv_int8": True,
      "asr.decoder_int8": True}),
    ("asr:\n  compute_type: int8\n  decoder_int8: false\n",
     {"asr.cross_kv_int8": True, "asr.decoder_int8": False}),
    ("diarization:\n  backend: pyannote\n", {"diarization.backend": "ahc"}),
    ("asr:\n  backend: whisper-jax\n  compute_type: float32\n",
     {"asr.backend": "whisper-jax", "asr.compute_type": "float32"}),
], ids=["reference", "int8", "int8_explicit_false", "pyannote", "native"])
def test_reference_names_map_as_jax(text, want, tmp_path):
    (tmp_path / "base.yaml").write_text(text)
    port, ref = _both(configs_dir=tmp_path)
    _assert_same_config(port, ref)
    got = _flat(dataclasses.asdict(port))
    assert {k: got[k] for k in want} == want


# (section, key, value): each either loads to the same value in both or
# raises in both
COERCIONS = [
    ("asr", "window_batch_size", v) for v in
    (16, 16.0, 16.5, "16", " 16 ", "16.0", "16.", "1_6", "+16", "1e1",
     True, None, -1, 0)
] + [
    ("asr", "vad_threshold", v) for v in
    (1, "1", True, "x", ".5", "1e-1", None, 1.5, "nan", "inf")
] + [
    ("asr", "vad_filter", v) for v in
    ("yes", "Yes", "on", "OFF", "t", "f", "1", "0", 1, 0, 2, 1.0, 0.5,
     "maybe", " yes ", None)
] + [
    ("asr", "language", v) for v in ("en", None, 1, True)
] + [
    ("asr", "model_size", v) for v in ("base", "BASE", "large-v4", 1, None)
] + [
    ("asr", "max_decode_tokens", v) for v in (None, 8, 7, "32", 32.0)
] + [
    ("asr", "fallback_temperatures", v) for v in
    ([0.2, 1], ["0.3"], 0.2, [], None, ["x"])
] + [
    ("asr", "logprob_threshold", v) for v in ("-inf", "1_0", -2)
] + [
    ("chunking", "max_tokens", v) for v in (49, 50, 2000, 2001)
] + [
    ("retrieval", "persist_dir", v) for v in (None, "/x", 1)
] + [
    ("retrieval", "search_type", v) for v in ("dense", "semantic")
] + [
    ("tts", "backend", v) for v in ("null", None, "jax", "coqui")
] + [
    ("resources", "unload_after_idle_seconds", v) for v in (600, -1, "600")
] + [
    ("generation", "temperature", v) for v in (2.0, 2.1, "0.3")
] + [
    ("log_level", None, v) for v in ("INFO", "info", 1)
] + [
    ("data_dir", None, v) for v in ("/data", 1, None)
] + [
    ("asr", None, v) for v in (5, None, "x")
]


@pytest.mark.parametrize("section,key,value", COERCIONS)
def test_values_coerce_and_refuse_as_jax(section, key, value):
    override = {section: {key: value}} if key else {section: value}
    port, ref = _both(configs_dir=CONFIGS / "missing",
                      overrides=override)
    if isinstance(ref, JaxConfigError):
        assert isinstance(port, ConfigError), (value, port)
        return
    assert not isinstance(port, Exception), (value, port)
    _assert_same_config(port, ref)


def test_schema_fields_missing_from_the_port_are_the_listed_ones():
    """By introspection: the fields the JAX schema has and the port's
    dataclasses lack are exactly :data:`TPU_ONLY_FIELDS`, each at its
    schema default."""
    def jax_fields(model, pre=""):
        out = {}
        for name, f in type(model).model_fields.items():
            v = getattr(model, name)
            if isinstance(v, BaseModel):
                out.update(jax_fields(v, f"{pre}{name}."))
            else:
                out[f"{pre}{name}"] = v
        return out

    def port_fields(obj, pre=""):
        out = set()
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                out |= port_fields(v, f"{pre}{f.name}.")
            else:
                out.add(f"{pre}{f.name}")
        return out

    ref = jax_fields(JaxConfig())
    lacking = set(ref) - port_fields(AudioRAGConfig())
    assert lacking == set(TPU_ONLY_FIELDS)
    assert {k: ref[k] for k in lacking} == TPU_ONLY_FIELDS


@pytest.mark.parametrize("key", sorted(TPU_ONLY_FIELDS))
def test_tpu_only_fields_drop_at_their_defaults_and_refuse_others(key):
    section, name = key.split(".")
    default = TPU_ONLY_FIELDS[key]
    port, ref = _both(configs_dir=CONFIGS / "missing",
                      overrides={section: {name: default}})
    _assert_same_config(port, ref)
    other = {bool: False, int: 7, float: 5.0, str: "tpu"}[type(default)]
    with pytest.raises(ConfigError, match=key.replace(".", r"\.")):
        load_config(configs_dir=CONFIGS / "missing",
                    overrides={section: {name: other}})
    if name == "device":
        with pytest.raises(ConfigError, match="AUDIO_RAG__DEVICE"):
            load_config(configs_dir=CONFIGS / "missing",
                        overrides={section: {name: "cpu"}})


def test_merge_and_environment_helpers_match_jax():
    a = {"x": {"y": 1, "z": 2}, "k": 1}
    b = {"x": {"y": 9}}
    assert deep_merge(a, b) == jloader.deep_merge(a, b) == {
        "x": {"y": 9, "z": 2}, "k": 1}
    assert a["x"]["y"] == 1
    assert deep_merge({"x": 1}, {"x": {"y": 2}}) == {"x": {"y": 2}}
    for raw in ("true", "OFF", "null", "none", "", "42", "2.5", "hello",
                " 7 ", "1e3", "nan"):
        got, want = tloader._convert_value(raw), jloader._convert_value(raw)
        assert _same(got, want) or (got != got and want != want), raw
    data = {"asr": {"model_size": "large-v3"}, "retrieval": 5}
    environ = {"AUDIO_RAG__ASR__MODEL_SIZE": "base",
               "AUDIO_RAG__RETRIEVAL__TOP_K": "7",
               "AUDIO_RAG__DEVICE": "cpu", "AUDIO_RAG__": "x",
               "UNRELATED": "x"}
    assert apply_env_overrides(data, environ) == \
        jloader.apply_env_overrides(data, environ) == {
            "asr": {"model_size": "base"}, "retrieval": {"top_k": 7},
            "device": "cpu"}


def test_environment_is_read_at_each_call(monkeypatch):
    assert load_config(configs_dir=CONFIGS).retrieval.top_k == 5
    monkeypatch.setenv("AUDIO_RAG__RETRIEVAL__TOP_K", "8")
    monkeypatch.setenv("AUDIO_RAG_ENV", "development")
    cfg = load_config(configs_dir=CONFIGS)
    assert (cfg.retrieval.top_k, cfg.asr.model_size) == (8, "base")


def test_unported_values_load_and_raise_where_used(tmp_path):
    """The fake store and checkpoint paths load (as the schema holds them)
    and raise ``ConfigError`` where used; a TTS backend without its engine
    falls back as in the JAX package; resources load and raise
    nowhere."""
    from audio_rag_tpu_torch.asr.whisper import WhisperASR
    from audio_rag_tpu_torch.embeddings.bge import BGEM3Embedder
    from audio_rag_tpu_torch.embeddings.e5 import E5Embedder
    from audio_rag_tpu_torch.pipeline import AudioRAG

    cfg = load_config(configs_dir=CONFIGS, overrides={
        "tts": {"backend": "piper"}, "device": "cpu",
        "resources": {"max_hbm_gb": 20, "unload_after_idle_seconds": 5},
        "asr": {"checkpoint_path": "/x", "model_size": "test"},
        "embedding": {"checkpoint_path": "/x", "model": "test"},
        "reranking": {"backend": "none"}})
    rag = AudioRAG(cfg)
    assert rag.status()["resources"]["budget_gb"] == 20.0
    # "piper" without its engine falls back to fallback_backend ("null"),
    # as the JAX pipeline's TTS chain does on the same config
    from audio_rag_tpu.pipeline.query import QueryPipeline as JaxQuery

    jax_query = JaxQuery(JaxConfig(tts={"backend": "piper"}))
    assert type(rag.querying.tts).__name__ == type(jax_query.tts).__name__ \
        == "NullTTS"
    assert rag.querying.tts.synthesize("x y") == \
        jax_query.tts.synthesize("x y")
    for make in (lambda: WhisperASR(cfg.asr, device="cpu"),
                 lambda: BGEM3Embedder(cfg.embedding, device="cpu"),
                 lambda: E5Embedder(cfg.embedding, device="cpu")):
        with pytest.raises(ConfigError, match="not ported"):
            make().load()
    cfg.retrieval.backend = "fake"
    with pytest.raises(ConfigError, match="not registered"):
        AudioRAG(cfg)
