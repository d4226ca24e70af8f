"""Rerankers of the port: the BGE cross-encoder and the word-overlap fake,
by backend name through :func:`create_reranker` ("none" → None)."""

from audio_rag_tpu_torch.reranking.base import create_reranker
from audio_rag_tpu_torch.reranking.bge import BGEReranker
from audio_rag_tpu_torch.reranking.fake import FakeReranker

__all__ = ["create_reranker", "BGEReranker", "FakeReranker"]
