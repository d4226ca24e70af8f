"""Evaluation of the port (counterpart of ``audio_rag_tpu/evaluation``):
datasets, the RAG evaluator and its metrics; WER (:mod:`.wer`), the NLI
scorer (:mod:`.nli`), the synthetic corpus (:mod:`.corpus`) and the
retrieval-quality ladder (:mod:`.quality`) are imported from their
modules."""

from audio_rag_tpu_torch.evaluation.dataset import (
    CS229_EVAL_DATASET,
    EvalDataset,
    EvalSample,
)
from audio_rag_tpu_torch.evaluation.metrics import (
    EvaluationResult,
    GenerationMetrics,
    RAGEvaluator,
    RetrievalMetrics,
)

__all__ = [
    "EvalSample",
    "EvalDataset",
    "CS229_EVAL_DATASET",
    "RAGEvaluator",
    "RetrievalMetrics",
    "GenerationMetrics",
    "EvaluationResult",
]
