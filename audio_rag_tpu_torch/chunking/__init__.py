"""Transcript chunkers of the port, by the config's strategy through
:func:`create_chunker`."""

from __future__ import annotations

from audio_rag_tpu_torch.chunking.fixed import FixedSizeChunker
from audio_rag_tpu_torch.chunking.semantic import SemanticChunker
from audio_rag_tpu_torch.chunking.speaker_turn import SpeakerTurnChunker
from audio_rag_tpu_torch.config import ChunkingConfig

__all__ = ["create_chunker", "FixedSizeChunker", "SemanticChunker",
           "SpeakerTurnChunker"]

_STRATEGIES = {"speaker_turn": SpeakerTurnChunker, "fixed": FixedSizeChunker,
               "semantic": SemanticChunker}


def create_chunker(config: ChunkingConfig | None = None):
    """The chunker ``config.strategy`` names (the semantic one built
    without an embedder, as the JAX pipeline builds it)."""
    config = config or ChunkingConfig()
    return _STRATEGIES[config.strategy](config)
