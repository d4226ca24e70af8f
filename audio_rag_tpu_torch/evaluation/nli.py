"""NLI entailment scorer for answer evaluation (counterpart of
``audio_rag_tpu/evaluation/nli.py``).

A 3-class XLM-R-style classification head
(:func:`audio_rag_tpu_torch.models.cross_encoder.nli_forward`, roberta-mnli
label order [contradiction, neutral, entailment]) run in f32 over
``<s> premise </s></s> hypothesis </s>`` rows, padded with −1 to a pow-2
length bucket (16 up to ``max_len``). Weights: the committed tiny asset
``nli_small.npz`` for ``model`` "auto" or "tiny"; seeded random weights at
the ``test`` preset for ``model="random"``; a missing asset otherwise
raises ``FileNotFoundError``, as in the JAX package. Checkpoints
(``checkpoint_path``) are not ported and raise ``ConfigError``.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.core.exceptions import ConfigError
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.models.bert import BERT_PRESETS
from audio_rag_tpu_torch.models.cross_encoder import (
    init_cross_encoder,
    nli_forward,
)
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer, pad_batch
from audio_rag_tpu_torch.weights import cross_encoder_params

__all__ = ["NLIScorer", "CONTRADICTION", "NEUTRAL", "ENTAILMENT"]

CONTRADICTION, NEUTRAL, ENTAILMENT = 0, 1, 2

_ASSET = ASSETS_DIR / "nli_small.npz"


class NLIScorer:
    """entailment(premise, hypothesis) → P(entailment) in [0, 1]."""

    def __init__(self, model: str = "auto",
                 checkpoint_path: str | None = None,
                 max_length: int = 256,
                 device: str | torch.device = "cuda"):
        if checkpoint_path:
            raise ConfigError(
                "NLI checkpoints (restore_params) are not ported; leave "
                "checkpoint_path unset",
                context={"checkpoint_path": checkpoint_path})
        self.max_length = max_length
        self.device = resolve_device(device)
        tree = (load_npz_asset(_ASSET) if model in ("auto", "tiny")
                else None)
        if tree is not None:
            self.dims = BERT_PRESETS["nli-small"]
            self._params = cross_encoder_params(tree, self.dims, self.device)
        elif model == "random":
            self.dims = BERT_PRESETS["test"]
            self._params = init_cross_encoder(self.dims, n_out=3, seed=0,
                                              device=self.device)
        else:
            # random weights would give meaningless entailment numbers;
            # the evaluator falls back to the relevance proxy instead
            raise FileNotFoundError(
                "no NLI weights: nli_small.npz is missing (train it with "
                "scripts/train_nli.py) and checkpoints are not ported")
        self._tok = get_tokenizer(vocab_size=self.dims.vocab)

    @torch.inference_mode()
    def probs(self, premises: list[str], hypotheses: list[str]) -> np.ndarray:
        """(B, 3) class probabilities [contradiction, neutral, entailment]."""
        max_len = min(self.max_length, self.dims.max_len)
        seqs = [self._tok.encode_pair(p, h, max_len)
                for p, h in zip(premises, hypotheses)]
        T = max(16, 1 << (max(len(s) for s in seqs) - 1).bit_length())
        T = min(T, max_len)
        ids = torch.from_numpy(pad_batch(seqs, T, -1)[0]).long().to(
            self.device)
        mask = (ids >= 0).long()
        tokens = torch.where(mask.bool(), ids,
                             torch.full_like(ids, self.dims.pad_id))
        logits = nli_forward(self._params, self.dims, tokens, mask,
                             dtype=torch.float32).cpu().numpy()
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def entailment(self, premise: str, hypothesis: str) -> float:
        return float(self.probs([premise], [hypothesis])[0, ENTAILMENT])
