"""Query expansion of the port: HyDE (pseudo-relevance feedback is not
ported)."""

from audio_rag_tpu_torch.expansion.hyde import HYDE_PROMPT, HyDEExpander

__all__ = ["HYDE_PROMPT", "HyDEExpander"]
