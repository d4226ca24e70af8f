"""Shared token estimate of the chunkers (copy of
``audio_rag_tpu/chunking/base.py::estimate_tokens``)."""

__all__ = ["estimate_tokens"]


def estimate_tokens(text: str) -> int:
    """Cheap token estimate: ~4 chars/token."""
    return max(1, len(text) // 4)
