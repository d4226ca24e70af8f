"""The port's own configuration: plain dataclasses holding the ASR,
diarization, alignment, embedding, retrieval, reranking, chunking,
contextual-header, generation and query-expansion fields the ported slice
uses, the live-transcription buffering, plus the device.

Every field a dataclass shares with ``audio_rag_tpu/config/schema.py`` has
the schema's name, default and bounds: ``AudioRAG()`` runs Whisper
large-v3 (seeded weights: no checkpoint is in the repository) with the
temperature-fallback ladder on and the language detected, the BGE-M3
embedder at XLM-R large shapes and the bge-reranker-base cross-encoder at
XLM-R base shapes (both seeded, as the JAX models start without files),
``query`` reranks, and an answer (``generate_answer=True``) or a HyDE
passage comes from llama-3.2-3b with seeded weights through the wave
scheduler. A caller who wants the committed trained models
names them (``model_size="tiny-synth"``, ``model="eval-small"`` for the
embedder, the reranker and the generator); one who wants greedy
decoding at temperature 0 only passes ``temperature_fallback=False``, and
``language="en"`` skips the detection. The departures: that schema cannot
name a torch backend or a CUDA device, so the port does not reuse it; the
port has no per-section ``device``, no ``backend`` but the diarizer's,
the reranker's, the generator's and the expansion's, no
``checkpoint_path`` but the diarizer's, the reranker's and the
generator's (no converted checkpoint is read: setting one raises), no
``mel_sharded`` (one device: each window's mel is clamped alone), no
``timeout`` and none of PRF's settings (PRF is not ported); it adds the
weight ``seed`` of the presets without an asset and
``AudioRAGConfig.device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
    "AudioRAGConfig",
]


@dataclass
class ASRConfig:
    #: a ``models.whisper.WHISPER_PRESETS`` key; "tiny-synth" loads the
    #: committed trained asset, other sizes start from seeded weights
    model_size: str = "large-v3"
    #: "bfloat16" = bf16 storage and compute, "float32" = fp32 throughout
    compute_type: str = "bfloat16"
    #: transcribe only the VAD's speech spans
    vad_filter: bool = True
    vad_threshold: float = 0.5
    #: "auto" = the learned VAD when its weights load and the audio is
    #: 16 kHz, else the energy gate; "learned" or "energy"
    vad_backend: str = "auto"
    #: None: detected from the first window on vocabularies of 51,865
    #: tokens or more (large-v3 included), else "en"
    language: str | None = None
    #: windows decoded together in one batch
    window_batch_size: int = 8
    #: cap on generated tokens per window (None = the preset's default)
    max_decode_tokens: int | None = None
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
    #: decode strategy: "greedy" or "beam" (hypothesis reorder from the
    #: ``BEAM_REORDER`` environment variable, read per call: "lazy"
    #: (default), "onehot" or "kernel")
    decode: str = "greedy"
    #: hypotheses per window under ``decode="beam"``, 1–16
    beam_size: int = 5
    #: greedy decode in verify blocks of this many tokens against the
    #: n-gram drafter (same tokens as plain greedy); 0 disables, ≤ 8
    speculative_k: int = 0
    #: greedy only: a window whose average log-probability is below
    #: ``logprob_threshold`` or whose text compresses (zlib) more than
    #: ``compression_ratio_threshold`` times is decoded again by sampling
    #: at each temperature in turn while it still fails
    temperature_fallback: bool = True
    fallback_temperatures: list[float] = field(
        default_factory=lambda: [0.2, 0.4])
    logprob_threshold: float = -1.0
    compression_ratio_threshold: float = 2.4
    no_speech_threshold: float = 0.6
    #: prime each window's prompt with ``<|startofprev|>`` and the tokens
    #: decoded since the last reset (windows then decode one at a time)
    condition_on_previous_text: bool = False
    #: reset that history after a window whose final temperature is above
    prompt_reset_on_temperature: float = 0.5
    #: seed of the weights of presets without a committed asset
    seed: int = 0

    def __post_init__(self):
        if self.decode not in ("greedy", "beam"):
            raise ConfigError(f"decode must be 'greedy' or 'beam', got "
                              f"{self.decode!r}")
        if not 1 <= self.beam_size <= 16:
            raise ConfigError(f"beam_size must be in [1, 16], got "
                              f"{self.beam_size}")
        if not 0 <= self.speculative_k <= 8:
            raise ConfigError(f"speculative_k must be in [0, 8], got "
                              f"{self.speculative_k}")
        _check_vad(self.vad_backend)
        for name in ("vad_threshold", "no_speech_threshold"):
            if not 0.0 <= getattr(self, name) <= 1.0:
                raise ConfigError(f"{name} must be in [0, 1], got "
                                  f"{getattr(self, name)}")
        if self.prompt_reset_on_temperature < 0.0:
            raise ConfigError(f"prompt_reset_on_temperature must be ≥ 0, "
                              f"got {self.prompt_reset_on_temperature}")
        if self.window_batch_size < 1:
            raise ConfigError(f"window_batch_size must be ≥ 1, got "
                              f"{self.window_batch_size}")
        if self.max_decode_tokens is not None and self.max_decode_tokens < 8:
            raise ConfigError(f"max_decode_tokens must be ≥ 8, got "
                              f"{self.max_decode_tokens}")


def _check_vad(backend: str) -> None:
    if backend not in ("auto", "learned", "energy"):
        raise ConfigError(f"vad_backend must be 'auto', 'learned' or "
                          f"'energy', got {backend!r}")


@dataclass
class DiarizationConfig:
    #: "clustering" (spectral) or "ahc" (agglomerative, overlap-aware)
    backend: str = "clustering"
    #: a ``models.speaker.SPEAKER_PRESETS`` key; "test" keeps a seeded
    #: tiny encoder, any other name loads the committed trained asset
    model: str = "titanet-jax"
    min_speakers: int | None = None
    max_speakers: int | None = 8
    min_speech_duration_ms: int = 250
    #: VAD gating the speaker windows
    vad_backend: str = "auto"
    #: AHC: merge clusters while their average cosine distance is below
    ahc_threshold: float = 0.35
    #: AHC: a window within this similarity margin of its second-closest
    #: centroid speaks for both (0 = single-label)
    overlap_margin: float = 0.0
    #: speaker-embedding window and shift, seconds
    window_s: float = 1.5
    shift_s: float = 0.75
    #: a converted speaker checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None

    def __post_init__(self):
        if self.backend not in ("clustering", "ahc"):
            raise ConfigError(f"diarization backend must be 'clustering' "
                              f"or 'ahc', got {self.backend!r}")
        _check_vad(self.vad_backend)
        if self.max_speakers is not None and self.max_speakers < 1:
            raise ConfigError(f"max_speakers must be ≥ 1, got "
                              f"{self.max_speakers}")


@dataclass
class AlignmentConfig:
    #: nearest-segment fallback of the word → speaker alignment, seconds
    tolerance_s: float = 0.5


@dataclass
class ChunkingConfig:
    max_tokens: int = 256
    overlap_tokens: int = 50
    min_chunk_tokens: int = 30


@dataclass
class ContextualConfig:
    #: prepend ``[Context: ...]`` headers to chunks before embedding
    enabled: bool = False
    #: neighbouring chunks on each side a header reads
    window_size: int = 1
    #: "llm" (the generator writes each header) or "extractive" (salient
    #: terms of the neighbours, no model)
    backend: str = "llm"
    #: terms per extractive header
    extractive_terms: int = 4

    def __post_init__(self):
        if self.backend not in ("llm", "extractive"):
            raise ConfigError(f"contextual backend must be 'llm' or "
                              f"'extractive', got {self.backend!r}")
        _check_bounds(self, (("window_size", 0, 3),
                             ("extractive_terms", 1, 16)))


@dataclass
class EmbeddingConfig:
    #: "eval-small" loads the committed trained asset; "test" and other
    #: names, the default "BAAI/bge-m3" among them (XLM-R large shapes),
    #: start from seeded weights, as the JAX embedder does without files
    model: str = "BAAI/bge-m3"
    batch_size: int = 32
    use_sparse: bool = True
    max_length: int = 512
    seed: int = 0


@dataclass
class RetrievalConfig:
    collection_name: str = "audio_rag"
    search_type: str = "hybrid"
    top_k: int = 5
    score_threshold: float = 0.0
    #: kept for the schema; hybrid search fuses by rank (RRF), not weights
    dense_weight: float = 0.7
    sparse_weight: float = 0.3
    rrf_k: float = 2.0
    max_doc_nnz: int = 128
    max_query_nnz: int = 64
    #: collections persist here as ``<name>.npz`` + ``<name>.json`` (the
    #: JAX store's files: either package loads the other's)
    persist_dir: str | None = None
    #: corpus rows grow in steps of this many rows
    capacity_step: int = 4096
    #: int8 dense corpus with per-row symmetric scales (the query is
    #: quantized too and the product taken on integers)
    quantize_dense: bool = False

    def __post_init__(self):
        if self.search_type not in ("dense", "sparse", "hybrid"):
            raise ConfigError(f"search_type must be 'dense', 'sparse' or "
                              f"'hybrid', got {self.search_type!r}")


@dataclass
class RerankingConfig:
    #: "bge-reranker" (the cross-encoder), "fake" (word overlap) or "none"
    backend: str = "bge-reranker"
    #: "eval-small" loads the committed trained asset, "test" keeps a
    #: seeded tiny encoder; other names, the default among them, start
    #: from seeded weights at XLM-R base shapes
    model: str = "BAAI/bge-reranker-base"
    top_k: int = 5
    #: candidates retrieved for the reranker to order
    initial_k: int = 20
    batch_size: int = 16
    max_length: int = 512
    #: passage tokens (with the trailing ``</s>``) kept per chunk in the
    #: query engine's reranker-token cache
    fused_doc_tokens: int = 224
    #: a converted reranker checkpoint (not ported: raises when set)
    checkpoint_path: str | None = None
    seed: int = 0

    def __post_init__(self):
        if self.backend not in ("bge-reranker", "fake", "none"):
            raise ConfigError(f"reranking backend must be 'bge-reranker', "
                              f"'fake' or 'none', got {self.backend!r}")
        for name, lo in (("top_k", 1), ("initial_k", 1), ("batch_size", 1),
                         ("max_length", 16), ("fused_doc_tokens", 16)):
            if getattr(self, name) < lo:
                raise ConfigError(f"{name} must be ≥ {lo}, got "
                                  f"{getattr(self, name)}")


def _check_bounds(cfg, bounds) -> None:
    for name, lo, hi in bounds:
        v = getattr(cfg, name)
        if v < lo or (hi is not None and v > hi):
            raise ConfigError(f"{name} must be in [{lo}, {hi}], got {v}"
                              if hi is not None else
                              f"{name} must be ≥ {lo}, got {v}")


@dataclass
class GenerationConfig:
    #: "llm-jax" (the schema's name of the in-process LLM backend: here the
    #: port's model), "fake" (a fixed answer from the prompt) or "none"
    backend: str = "llm-jax"
    #: a ``models.llm.LLM_PRESETS`` key ("eval-small" loads the committed
    #: trained asset; other names, unknown ones as llama-3.2-3b, start from
    #: seeded weights)
    model: str = "llama-3.2-3b"
    temperature: float = 0.7
    max_tokens: int = 1024
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
    speculative_k: int = 0
    #: prompts keep their last this many tokens
    max_prompt_tokens: int = 2048
    #: coalesce concurrent requests into one wave (engine/scheduler.py)
    use_scheduler: bool = True
    #: "wave" (each batch decoded to the end) or "continuous" (slots that
    #: requests join and leave at segment boundaries, text streamed by
    #: segment: engine/continuous.py)
    scheduler_mode: str = "wave"
    scheduler_max_batch: int = 16
    scheduler_max_wait_ms: float = 10.0
    #: continuous mode: decode slots and decode steps a segment
    scheduler_slots: int = 8
    scheduler_segment_tokens: int = 16
    #: continuous mode: steps a segment while nobody waits to join and
    #: every slot has that much room (0 = off)
    scheduler_idle_segment_tokens: int = 48
    #: continuous mode: cache frames a slot holds
    scheduler_context_tokens: int = 2048
    #: seed of the weights of presets without a committed asset
    seed: int = 0

    def __post_init__(self):
        if self.backend not in ("llm-jax", "fake", "none"):
            raise ConfigError(f"generation backend must be 'llm-jax', "
                              f"'fake' or 'none', got {self.backend!r}")
        if self.scheduler_mode not in ("wave", "continuous"):
            raise ConfigError(f"scheduler_mode must be 'wave' or "
                              f"'continuous', got {self.scheduler_mode!r}")
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
    #: "hyde" (embed an LLM-written passage that answers the query) or
    #: "none"; "prf" (pseudo-relevance feedback) is not ported: a query
    #: that would expand by it raises
    backend: str = "none"
    num_hypotheses: int = 1

    def __post_init__(self):
        if self.backend not in ("hyde", "prf", "none"):
            raise ConfigError(f"expansion backend must be 'hyde', 'prf' or "
                              f"'none', got {self.backend!r}")
        _check_bounds(self, (("num_hypotheses", 1, 3),))


@dataclass
class StreamingSchema:
    """Live-transcription buffering (the schema's ``StreamingSchema``;
    ``configs/low_latency.yaml`` ships 3 s chunks, 0.6 s overlap, 40
    tokens)."""

    #: seconds of audio buffered before each transcription pass
    chunk_duration: float = 5.0
    #: seconds fed again from the previous chunk
    overlap_duration: float = 1.0
    #: decode budget per chunk
    max_decode_tokens: int = 64
    #: carried to the session as the JAX package carries it, and applied
    #: by neither (ROADMAP.md §3)
    min_avg_logprob: float | None = None
    #: live sessions served at once
    max_sessions: int = 8

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
class AudioRAGConfig:
    asr: ASRConfig = field(default_factory=ASRConfig)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    alignment: AlignmentConfig = field(default_factory=AlignmentConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    contextual: ContextualConfig = field(default_factory=ContextualConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    reranking: RerankingConfig = field(default_factory=RerankingConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    expansion: ExpansionConfig = field(default_factory=ExpansionConfig)
    streaming: StreamingSchema = field(default_factory=StreamingSchema)
    #: "cuda" (default) or "cpu"; CUDA without a card raises
    device: str = "cuda"
