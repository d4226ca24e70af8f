"""The port's own configuration: plain dataclasses holding the ASR,
embedding, retrieval and chunking fields the ported slice uses, plus the
device. Field names and defaults follow ``audio_rag_tpu/config/schema.py``;
that schema cannot name a torch backend or a CUDA device, so the port does
not reuse it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "ASRConfig",
    "ChunkingConfig",
    "EmbeddingConfig",
    "RetrievalConfig",
    "AudioRAGConfig",
]


@dataclass
class ASRConfig:
    #: a ``models.whisper.WHISPER_PRESETS`` key; "tiny-synth" loads the
    #: committed trained asset, other sizes start from seeded weights
    model_size: str = "tiny-synth"
    #: "bfloat16" = bf16 storage and compute, "float32" = fp32 throughout
    compute_type: str = "bfloat16"
    language: str | None = None
    #: windows decoded together in one batch
    window_batch_size: int = 8
    #: cap on generated tokens per window (None = the preset's default)
    max_decode_tokens: int | None = None
    #: int8 cross-attention K/V (decode cross kernel)
    cross_kv_int8: bool = False
    #: int8 decode-loop weight matmuls (int8-weight matmul kernel)
    decoder_int8: bool = False
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    #: seed of the weights of presets without a committed asset
    seed: int = 0


@dataclass
class ChunkingConfig:
    max_tokens: int = 256
    overlap_tokens: int = 50
    min_chunk_tokens: int = 30


@dataclass
class EmbeddingConfig:
    #: "eval-small" loads the committed trained asset; "test" and other
    #: names (XLM-R large shapes) start from seeded weights
    model: str = "eval-small"
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
    rrf_k: float = 2.0
    max_doc_nnz: int = 128
    max_query_nnz: int = 64
    #: corpus rows grow in steps of this many rows
    capacity_step: int = 4096


@dataclass
class AudioRAGConfig:
    asr: ASRConfig = field(default_factory=ASRConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    #: "cuda" (default) or "cpu"; CUDA without a card raises
    device: str = "cuda"
