"""Query expansion of the port: HyDE and pseudo-relevance feedback."""

from audio_rag_tpu_torch.expansion.hyde import HYDE_PROMPT, HyDEExpander
from audio_rag_tpu_torch.expansion.prf import PRFExpander

__all__ = ["HYDE_PROMPT", "HyDEExpander", "PRFExpander"]
