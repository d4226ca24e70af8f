"""The port's configuration tree: plain dataclasses with every field of
``audio_rag_tpu/config/schema.py``'s ``AudioRAGConfig`` that means
something on one card, under the same names, defaults, bounds and allowed
values, plus the port's own ``AudioRAGConfig.device`` and the weight
``seed`` of the presets without an asset.

``AudioRAG()`` runs Whisper large-v3 (seeded weights: no checkpoint is in
the repository) with the temperature-fallback ladder on and the language
detected, the BGE-M3 embedder at XLM-R large shapes and the
bge-reranker-base cross-encoder at XLM-R base shapes (both seeded, as the
JAX models start without files), ``query`` reranks, and an answer
(``generate_answer=True``) or a HyDE passage comes from llama-3.2-3b with
seeded weights through the wave scheduler. A caller who wants the
committed trained models names them (``model_size="tiny-synth"``,
``model="eval-small"`` for the embedder, the reranker and the generator);
one who wants greedy decoding at temperature 0 only passes
``temperature_fallback=False``, and ``language="en"`` skips the detection.

The fields the JAX schema has and this one lacks mean nothing on one card
(:data:`TPU_ONLY_FIELDS`, each with its schema default): ``mesh.*`` (the
TPU device mesh), the per-section ``device`` (the port has one device, the
top-level ``device``), ``asr.mel_sharded`` (one device: each window's mel
is clamped alone) and ``generation.timeout`` (read by no call of either
package). :func:`~audio_rag_tpu_torch.config.loader.load_config` drops
them at those defaults and refuses any other value.

Values that name a feature the port has not got are held here and raise
``ConfigError`` where they are used: ``retrieval.backend`` "fake"
(registered nowhere in the JAX package either).
``resources.max_hbm_gb`` and ``resources.pin_query_models`` set the
device-memory manager's budget and pins (``AudioRAG``), and the API's
idle reaper evicts what stayed idle ``unload_after_idle_seconds``
(``api/app.py``); ``max_ram_gb`` and ``max_audio_duration_minutes`` are
held and read by nothing, as in the JAX package; ``embedding.normalize``
is held and changes nothing (the JAX embedders normalize either way);
``alignment.method`` is held (the JAX aligner reads it nowhere either);
``log_level`` sets the level of the port's loggers.

Constructing a dataclass checks the allowed values of every field that
has them and the bounds the port's code relies on; :func:`validate`, run
by ``load_config``, checks every bound of the schema, as pydantic does.
The port's tests build below the schema's floors (``max_tokens=8``: one
chunk a window), as the JAX tests do by assignment.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any

from audio_rag_tpu_torch.core.exceptions import ConfigError

__all__ = [
    "ASRConfig",
    "DiarizationConfig",
    "AlignmentConfig",
    "ChunkingConfig",
    "ContextualConfig",
    "EmbeddingConfig",
    "RetrievalConfig",
    "RerankingConfig",
    "GenerationConfig",
    "ExpansionConfig",
    "StreamingSchema",
    "TTSConfig",
    "ResourceConfig",
    "AudioRAGConfig",
    "TPU_ONLY_FIELDS",
    "validate",
]

#: the JAX schema's fields that mean nothing on one card, by dotted key,
#: each with its schema default ("mesh.*" is every field of ``mesh``)
TPU_ONLY_FIELDS: dict[str, Any] = {
    "mesh.data_axis": -1,
    "mesh.model_axis": 1,
    "mesh.data_axis_name": "data",
    "mesh.model_axis_name": "model",
    "mesh.force_host_device_count": 0,
    "asr.device": "auto",
    "asr.mel_sharded": True,
    "diarization.device": "auto",
    "embedding.device": "auto",
    "reranking.device": "auto",
    "generation.timeout": 60.0,
}


def _f(default: Any, *, ge: float | None = None, le: float | None = None,
       choices: tuple | None = None):
    """A field with the schema's bounds and allowed values as metadata."""
    meta = {k: v for k, v in (("ge", ge), ("le", le), ("choices", choices))
            if v is not None}
    if isinstance(default, list):
        return field(default_factory=lambda: list(default), metadata=meta)
    return field(default=default, metadata=meta)


def _check_choices(cfg, path: str = "") -> None:
    for f in fields(cfg):
        choices = f.metadata.get("choices")
        value = getattr(cfg, f.name)
        if choices is not None and not any(
                value == c and type(value) is type(c) for c in choices):
            raise ConfigError(
                f"{path}{f.name} must be one of "
                f"{', '.join(map(repr, choices))}; got {value!r}",
                context={"field": f"{path}{f.name}"})


def _check_bounds(cfg, bounds) -> None:
    for name, lo, hi in bounds:
        v = getattr(cfg, name)
        if v < lo or (hi is not None and v > hi):
            raise ConfigError(f"{name} must be in [{lo}, {hi}], got {v}"
                              if hi is not None else
                              f"{name} must be ≥ {lo}, got {v}")


def validate(cfg, path: str = "") -> None:
    """Every allowed value and bound of the schema, through the tree
    (``load_config`` runs it; construction checks fewer bounds)."""
    _check_choices(cfg, path)
    for f in fields(cfg):
        value = getattr(cfg, f.name)
        key = f"{path}{f.name}"
        if is_dataclass(value):
            validate(value, key + ".")
            continue
        lo, hi = f.metadata.get("ge"), f.metadata.get("le")
        # NaN fails both, as it fails pydantic's
        if value is not None and ((lo is not None and not value >= lo) or (
                hi is not None and not value <= hi)):
            raise ConfigError(f"{key} must be in [{lo}, {hi}]; got {value!r}",
                              context={"field": key})


_VAD = ("auto", "learned", "energy")


@dataclass
class ASRConfig:
    #: "whisper-jax" (the schema's name of the in-process Whisper: here
    #: the port's ``WhisperASR``), "streaming-whisper" (the same backend)
    #: or "fake" (``asr/fake.py``)
    backend: str = _f("whisper-jax",
                      choices=("whisper-jax", "streaming-whisper", "fake"))
    #: a ``models.whisper.WHISPER_PRESETS`` key; "tiny-synth" loads the
    #: committed trained asset, other sizes start from seeded weights
    model_size: str = _f("large-v3", choices=(
        "tiny", "base", "small", "medium", "large-v2", "large-v3", "test",
        "test-ml", "tiny-synth"))
    #: "bfloat16" = bf16 storage and compute, "float32" = fp32 throughout
    compute_type: str = _f("bfloat16", choices=("bfloat16", "float32"))
    #: transcribe only the VAD's speech spans
    vad_filter: bool = True
    vad_threshold: float = _f(0.5, ge=0.0, le=1.0)
    #: "auto" = the learned VAD when its weights load and the audio is
    #: 16 kHz, else the energy gate; "learned" or "energy"
    vad_backend: str = _f("auto", choices=_VAD)
    #: None: detected from the first window on vocabularies of 51,865
    #: tokens or more (large-v3 included), else "en"
    language: str | None = None
    #: decode strategy: "greedy" or "beam" (hypothesis reorder from the
    #: ``BEAM_REORDER`` environment variable, read per call: "lazy"
    #: (default), "onehot" or "kernel")
    decode: str = _f("greedy", choices=("greedy", "beam"))
    #: hypotheses per window under ``decode="beam"``, 1–16
    beam_size: int = _f(5, ge=1, le=16)
    #: greedy decode in verify blocks of this many tokens against the
    #: n-gram drafter (same tokens as plain greedy); 0 disables, ≤ 8
    speculative_k: int = _f(0, ge=0, le=8)
    #: greedy only: a window whose average log-probability is below
    #: ``logprob_threshold`` or whose text compresses (zlib) more than
    #: ``compression_ratio_threshold`` times is decoded again by sampling
    #: at each temperature in turn while it still fails
    temperature_fallback: bool = True
    fallback_temperatures: list[float] = _f([0.2, 0.4])
    logprob_threshold: float = -1.0
    compression_ratio_threshold: float = 2.4
    no_speech_threshold: float = _f(0.6, ge=0.0, le=1.0)
    #: prime each window's prompt with ``<|startofprev|>`` and the tokens
    #: decoded since the last reset (windows then decode one at a time)
    condition_on_previous_text: bool = False
    #: reset that history after a window whose final temperature is above
    prompt_reset_on_temperature: float = _f(0.5, ge=0.0)
    #: windows decoded together in one batch
    window_batch_size: int = _f(8, ge=1)
    #: cap on generated tokens per window (None = the preset's default)
    max_decode_tokens: int | None = _f(None, ge=8)
    #: int8 cross-attention K/V (int8 decode cross kernel)
    cross_kv_int8: bool = False
    #: int4 cross-attention K/V, per-channel scales (int4 decode cross
    #: kernel); takes precedence over ``cross_kv_int8``
    cross_kv_int4: bool = False
    #: int8 decode-loop weight matmuls (int8-weight matmul kernel)
    decoder_int8: bool = False
    #: int4 decode-loop weight matmuls, group-wise scales (int4-weight
    #: matmul kernel); takes precedence over ``decoder_int8``
    decoder_int4: bool = False
    #: with ``decoder_int8`` and without ``decoder_int4``: int4 for the
    #: logits head only
    lm_head_int4: bool = False
    #: int8 self-attention cache with per-position scales (int8 decode self
    #: kernel); greedy decoding only (beam and speculative ignore it)
    self_kv_int8: bool = False
    #: a converted Whisper checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None
    #: seed of the weights of presets without a committed asset
    seed: int = 0

    def __post_init__(self):
        _check_choices(self)
        _check_bounds(self, (("beam_size", 1, 16), ("speculative_k", 0, 8),
                             ("vad_threshold", 0.0, 1.0),
                             ("no_speech_threshold", 0.0, 1.0),
                             ("prompt_reset_on_temperature", 0.0, None),
                             ("window_batch_size", 1, None)))
        if self.max_decode_tokens is not None and self.max_decode_tokens < 8:
            raise ConfigError(f"max_decode_tokens must be ≥ 8, got "
                              f"{self.max_decode_tokens}")


@dataclass
class DiarizationConfig:
    #: "clustering" (spectral), "ahc" (agglomerative, overlap-aware) or
    #: "fake" (round-robin turns, ``diarization/fake.py``)
    backend: str = _f("clustering", choices=("clustering", "ahc", "fake"))
    #: a ``models.speaker.SPEAKER_PRESETS`` key; "test" keeps a seeded
    #: tiny encoder, any other name loads the committed trained asset
    model: str = "titanet-jax"
    min_speakers: int | None = None
    max_speakers: int | None = _f(8, ge=1)
    min_speech_duration_ms: int = _f(250, ge=0)
    #: VAD gating the speaker windows
    vad_backend: str = _f("auto", choices=_VAD)
    #: AHC: merge clusters while their average cosine distance is below
    ahc_threshold: float = _f(0.35, ge=0.0, le=2.0)
    #: AHC: a window within this similarity margin of its second-closest
    #: centroid speaks for both (0 = single-label)
    overlap_margin: float = _f(0.0, ge=0.0, le=1.0)
    #: speaker-embedding window and shift, seconds
    window_s: float = 1.5
    shift_s: float = 0.75
    #: a converted speaker checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None

    def __post_init__(self):
        _check_choices(self)
        if self.max_speakers is not None and self.max_speakers < 1:
            raise ConfigError(f"max_speakers must be ≥ 1, got "
                              f"{self.max_speakers}")


@dataclass
class AlignmentConfig:
    #: held as the schema holds it (the JAX aligner reads it nowhere)
    method: str = _f("word_level", choices=("word_level", "segment_level"))
    #: nearest-segment fallback of the word → speaker alignment, seconds
    tolerance_s: float = 0.5

    def __post_init__(self):
        _check_choices(self)


@dataclass
class ChunkingConfig:
    #: "speaker_turn", "semantic" (a boundary where neighbouring segments'
    #: fake embeddings drift apart) or "fixed" (word windows)
    strategy: str = _f("speaker_turn",
                       choices=("speaker_turn", "semantic", "fixed"))
    max_tokens: int = _f(256, ge=50, le=2000)
    overlap_tokens: int = _f(50, ge=0)
    min_chunk_tokens: int = _f(30, ge=1)

    def __post_init__(self):
        _check_choices(self)


@dataclass
class ContextualConfig:
    #: prepend ``[Context: ...]`` headers to chunks before embedding
    enabled: bool = False
    #: neighbouring chunks on each side a header reads
    window_size: int = _f(1, ge=0, le=3)
    #: "llm" (the generator writes each header) or "extractive" (salient
    #: terms of the neighbours, no model)
    backend: str = _f("llm", choices=("llm", "extractive"))
    #: terms per extractive header
    extractive_terms: int = _f(4, ge=1, le=16)

    def __post_init__(self):
        _check_choices(self)
        _check_bounds(self, (("window_size", 0, 3),
                             ("extractive_terms", 1, 16)))


@dataclass
class EmbeddingConfig:
    #: "bge-m3" (dense + sparse), "multilingual-e5" (dense, E5's
    #: prefixes and mean pooling) or "fake" (hashed bag of words)
    backend: str = _f("bge-m3", choices=("bge-m3", "multilingual-e5", "fake"))
    #: "eval-small" loads the committed trained asset; "test" and other
    #: names, the default "BAAI/bge-m3" among them (XLM-R large shapes),
    #: start from seeded weights, as the JAX embedder does without files
    model: str = "BAAI/bge-m3"
    batch_size: int = _f(32, ge=1)
    #: held (every embedder returns unit vectors either way)
    normalize: bool = True
    use_sparse: bool = True
    max_length: int = _f(512, ge=16, le=8192)
    #: a converted embedder checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None
    seed: int = 0

    def __post_init__(self):
        _check_choices(self)


@dataclass
class RetrievalConfig:
    #: "tpu" (the schema's name of the in-process store: here the port's
    #: ``VectorStore`` on the card); "fake" is registered nowhere and
    #: raises when a store is built
    backend: str = _f("tpu", choices=("tpu", "fake"))
    collection_name: str = "audio_rag"
    search_type: str = _f("hybrid", choices=("dense", "sparse", "hybrid"))
    top_k: int = _f(5, ge=1, le=100)
    score_threshold: float = _f(0.0, ge=0.0, le=1.0)
    #: kept for the schema; hybrid search fuses by rank (RRF), not weights
    dense_weight: float = _f(0.7, ge=0.0, le=1.0)
    sparse_weight: float = _f(0.3, ge=0.0, le=1.0)
    rrf_k: float = _f(2.0, ge=0.0)
    max_doc_nnz: int = _f(128, ge=8)
    max_query_nnz: int = _f(64, ge=8)
    #: collections persist here as ``<name>.npz`` + ``<name>.json`` (the
    #: JAX store's files: either package loads the other's)
    persist_dir: str | None = None
    #: corpus rows grow in steps of this many rows
    capacity_step: int = _f(4096, ge=128)
    #: int8 dense corpus with per-row symmetric scales (the query is
    #: quantized too and the product taken on integers)
    quantize_dense: bool = False

    def __post_init__(self):
        _check_choices(self)


@dataclass
class RerankingConfig:
    #: "bge-reranker" (the cross-encoder), "fake" (word overlap) or "none"
    backend: str = _f("bge-reranker", choices=("bge-reranker", "fake", "none"))
    #: "eval-small" loads the committed trained asset, "test" keeps a
    #: seeded tiny encoder; other names, the default among them, start
    #: from seeded weights at XLM-R base shapes
    model: str = "BAAI/bge-reranker-base"
    top_k: int = _f(5, ge=1, le=50)
    #: candidates retrieved for the reranker to order
    initial_k: int = _f(20, ge=1, le=100)
    batch_size: int = _f(16, ge=1)
    max_length: int = _f(512, ge=16, le=4096)
    #: passage tokens (with the trailing ``</s>``) kept per chunk in the
    #: query engine's reranker-token cache
    fused_doc_tokens: int = _f(224, ge=16)
    #: a converted reranker checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None
    seed: int = 0

    def __post_init__(self):
        _check_choices(self)
        for name, lo in (("top_k", 1), ("initial_k", 1), ("batch_size", 1),
                         ("max_length", 16), ("fused_doc_tokens", 16)):
            if getattr(self, name) < lo:
                raise ConfigError(f"{name} must be ≥ {lo}, got "
                                  f"{getattr(self, name)}")


@dataclass
class GenerationConfig:
    #: "llm-jax" (the schema's name of the in-process LLM backend: here the
    #: port's model), "fake" (a fixed answer from the prompt) or "none"
    backend: str = _f("llm-jax", choices=("llm-jax", "fake", "none"))
    #: a ``models.llm.LLM_PRESETS`` key ("eval-small" loads the committed
    #: trained asset; other names, unknown ones as llama-3.2-3b, start from
    #: seeded weights)
    model: str = "llama-3.2-3b"
    temperature: float = _f(0.7, ge=0.0, le=2.0)
    max_tokens: int = _f(1024, ge=1, le=8192)
    #: a converted LLM checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None
    #: int8 decode-step linears and head (int8-weight matmul kernel)
    decoder_int8: bool = False
    #: int4 decode-step linears and head, group-wise scales (int4-weight
    #: matmul kernel); takes precedence over ``decoder_int8``
    decoder_int4: bool = False
    #: with ``decoder_int8``: int4 for the head only
    lm_head_int4: bool = False
    #: a greedy single-row wave decodes in verify blocks of this many
    #: tokens against the n-gram drafter (the same tokens); 0 = off
    speculative_k: int = _f(0, ge=0, le=8)
    #: prompts keep their last this many tokens
    max_prompt_tokens: int = _f(2048, ge=64)
    #: coalesce concurrent requests into one wave (engine/scheduler.py)
    use_scheduler: bool = True
    #: "wave" (each batch decoded to the end) or "continuous" (slots that
    #: requests join and leave at segment boundaries, text streamed by
    #: segment: engine/continuous.py)
    scheduler_mode: str = _f("wave", choices=("wave", "continuous"))
    scheduler_max_batch: int = _f(16, ge=1)
    scheduler_max_wait_ms: float = _f(10.0, ge=0.0)
    #: continuous mode: decode slots and decode steps a segment
    scheduler_slots: int = _f(8, ge=1)
    scheduler_segment_tokens: int = _f(16, ge=1)
    #: continuous mode: steps a segment while nobody waits to join and
    #: every slot has that much room (0 = off)
    scheduler_idle_segment_tokens: int = _f(48, ge=0)
    #: continuous mode: cache frames a slot holds
    scheduler_context_tokens: int = _f(2048, ge=64)
    #: seed of the weights of presets without a committed asset
    seed: int = 0

    def __post_init__(self):
        _check_choices(self)
        _check_bounds(self, (
            ("temperature", 0.0, 2.0), ("max_tokens", 1, 8192),
            ("speculative_k", 0, 8), ("max_prompt_tokens", 64, None),
            ("scheduler_max_batch", 1, None),
            ("scheduler_max_wait_ms", 0.0, None),
            ("scheduler_slots", 1, None),
            ("scheduler_segment_tokens", 1, None),
            ("scheduler_idle_segment_tokens", 0, None),
            ("scheduler_context_tokens", 64, None)))


@dataclass
class ExpansionConfig:
    #: "hyde" (embed an LLM-written passage that answers the query),
    #: "prf" (append salient terms of the query's own first-pass hits) or
    #: "none"
    backend: str = _f("none", choices=("hyde", "prf", "none"))
    num_hypotheses: int = _f(1, ge=1, le=3)
    #: PRF: first-pass results mined for terms
    prf_depth: int = _f(5, ge=1, le=50)
    #: PRF: expansion terms appended at most
    prf_terms: int = _f(3, ge=1, le=32)

    def __post_init__(self):
        _check_choices(self)
        _check_bounds(self, (("num_hypotheses", 1, 3), ("prf_depth", 1, 50),
                             ("prf_terms", 1, 32)))


@dataclass
class StreamingSchema:
    """Live-transcription buffering (the schema's ``StreamingSchema``;
    ``configs/low_latency.yaml`` ships 3 s chunks, 0.6 s overlap, 40
    tokens)."""

    #: seconds of audio buffered before each transcription pass
    chunk_duration: float = _f(5.0, ge=0.5, le=30.0)
    #: seconds fed again from the previous chunk
    overlap_duration: float = _f(1.0, ge=0.0, le=10.0)
    #: decode budget per chunk
    max_decode_tokens: int = _f(64, ge=8, le=224)
    #: carried to the session as the JAX package carries it, and applied
    #: by neither (ROADMAP.md §3)
    min_avg_logprob: float | None = None
    #: live sessions served at once
    max_sessions: int = _f(8, ge=1, le=64)

    def __post_init__(self):
        _check_bounds(self, (("chunk_duration", 0.5, 30.0),
                             ("overlap_duration", 0.0, 10.0),
                             ("max_decode_tokens", 8, 224),
                             ("max_sessions", 1, 64)))

    def to_runtime(self):
        """The :class:`~audio_rag_tpu_torch.asr.streaming.StreamingConfig`
        a :class:`~audio_rag_tpu_torch.asr.streaming.StreamingASR` takes."""
        from audio_rag_tpu_torch.asr.streaming import StreamingConfig

        return StreamingConfig(
            chunk_duration=self.chunk_duration,
            overlap_duration=self.overlap_duration,
            max_decode_tokens=self.max_decode_tokens,
            min_avg_logprob=self.min_avg_logprob)


@dataclass
class TTSConfig:
    """Speech output: the backend that speaks ``query(speak_answer=True)``'s
    answer ("null" tone, "jax" the neural TTS, "piper" or "edge-tts" where
    their engines are installed), the one it falls back to when it fails to
    load, and the WAV's sample rate."""

    backend: str = _f("null", choices=("null", "piper", "edge-tts", "jax"))
    model: str = "en_US-lessac-medium"
    fallback_backend: str = _f("null", choices=("null", "jax", "none"))
    output_format: str = _f("wav", choices=("wav",))
    sample_rate: int = _f(22050, ge=8000, le=48000)

    def __post_init__(self):
        _check_choices(self)


@dataclass
class ResourceConfig:
    """The device-memory manager's budget and pins (``AudioRAG``) and the
    API's idle eviction (``api/app.py``)."""

    max_hbm_gb: float = _f(14.0, ge=1.0)
    max_ram_gb: float = _f(16.0, ge=1.0)
    unload_after_idle_seconds: int = _f(300, ge=0)
    pin_query_models: bool = False
    max_audio_duration_minutes: int = _f(480, ge=1)


@dataclass
class AudioRAGConfig:
    asr: ASRConfig = field(default_factory=ASRConfig)
    streaming: StreamingSchema = field(default_factory=StreamingSchema)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    alignment: AlignmentConfig = field(default_factory=AlignmentConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    contextual: ContextualConfig = field(default_factory=ContextualConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    reranking: RerankingConfig = field(default_factory=RerankingConfig)
    expansion: ExpansionConfig = field(default_factory=ExpansionConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    tts: TTSConfig = field(default_factory=TTSConfig)
    resources: ResourceConfig = field(default_factory=ResourceConfig)
    log_level: str = _f("INFO", choices=("DEBUG", "INFO", "WARNING", "ERROR"))
    data_dir: str = "./data"
    cache_dir: str = "./cache"
    #: "cuda" (default) or "cpu"; CUDA without a card raises
    #: (``AUDIO_RAG__DEVICE`` through ``load_config``)
    device: str = "cuda"

    def __post_init__(self):
        _check_choices(self)

