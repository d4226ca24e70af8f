"""NLI entailment scorer for answer evaluation (counterpart of
``audio_rag_tpu/evaluation/nli.py``).

A 3-class XLM-R-style classification head
(:func:`audio_rag_tpu_torch.models.cross_encoder.nli_forward`, roberta-mnli
label order [contradiction, neutral, entailment]) run in f32 over
``<s> premise </s></s> hypothesis </s>`` rows, padded with −1 to a pow-2
length bucket (16 up to ``max_len``). Weights, by precedence: a converted
3-label checkpoint (``{checkpoint_path}/nli.safetensors``, any
XLMRobertaForSequenceClassification MNLI model through
``convert_reranker``) at xlmr-base's heads, vocabulary and pad id, its
width, depth, feed-forward and position table read from the tree (the JAX
scorer keeps xlmr-base's dims whatever the tree holds, which runs only
where they agree); the committed tiny asset ``nli_small.npz`` for
``model`` "auto" or "tiny"; seeded random weights at the ``test`` preset
for ``model="random"``; nothing found otherwise raises
``FileNotFoundError``, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import (
    ASSETS_DIR,
    load_npz_asset,
    restore_params,
)
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.models.bert import BERT_PRESETS, BertDims
from audio_rag_tpu_torch.models.cross_encoder import (
    init_cross_encoder,
    nli_forward,
)
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer, pad_batch
from audio_rag_tpu_torch.weights import cross_encoder_params

__all__ = ["NLIScorer", "CONTRADICTION", "NEUTRAL", "ENTAILMENT"]

CONTRADICTION, NEUTRAL, ENTAILMENT = 0, 1, 2

_ASSET = ASSETS_DIR / "nli_small.npz"


def _checkpoint_dims(tree: dict) -> BertDims:
    """xlmr-base's dims with the width, depth, feed-forward width and
    position table of a converted tree."""
    base = BERT_PRESETS["xlmr-base"]
    pos = np.shape(tree["bert"]["pos_emb"]["table"])[0]
    up = tree["bert"]["blocks"]["mlp"]["up"]["w"]
    n_layers, d_model, d_ff = np.shape(up)
    return dataclasses.replace(base, d_model=int(d_model),
                               n_layers=int(n_layers), d_ff=int(d_ff),
                               max_len=int(pos) - base.pos_offset)


class NLIScorer:
    """entailment(premise, hypothesis) → P(entailment) in [0, 1]."""

    def __init__(self, model: str = "auto",
                 checkpoint_path: str | None = None,
                 max_length: int = 256,
                 device: str | torch.device = "cuda"):
        self.max_length = max_length
        self.device = resolve_device(device)
        tree = (restore_params(checkpoint_path, "nli") if checkpoint_path
                else None)
        if tree is not None:
            self.dims = _checkpoint_dims(tree)
            self._params = cross_encoder_params(tree, self.dims, self.device)
            self._tok = get_tokenizer(checkpoint_path,
                                      vocab_size=self.dims.vocab)
            return
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
                "no NLI weights: pass checkpoint_path (convert any "
                "XLMRobertaForSequenceClassification mnli model with "
                "convert_reranker) or run scripts/train_nli.py")
        self._tok = get_tokenizer(checkpoint_path,
                                  vocab_size=self.dims.vocab)

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
