"""The port's pipeline, split as the JAX package's: ingestion, query and
the ``AudioRAG`` orchestrator over the stages both share."""

from audio_rag_tpu_torch.generation.prompts import format_timestamp
from audio_rag_tpu_torch.pipeline.ingestion import (
    IngestionPipeline,
    IngestionResult,
)
from audio_rag_tpu_torch.pipeline.orchestrator import AudioRAG
from audio_rag_tpu_torch.pipeline.query import (
    QueryPipeline,
    QueryResult,
    format_context,
)

__all__ = ["AudioRAG", "IngestionPipeline", "IngestionResult",
           "QueryPipeline", "QueryResult", "format_context",
           "format_timestamp"]
