"""BGE-M3 embedder of the port: dense + sparse from one batched forward.

Counterpart of ``audio_rag_tpu/embeddings/bge.py::BGEM3Embedder``: the same
hash tokenizer, the same power-of-two ``_bucket`` padding of batch and
length (−1 padding doubles as the mask), bf16 storage and compute, and the
same ``_to_sparse`` rule (max weight over duplicate token ids, special
tokens and non-positive weights dropped). Weights: ``checkpoint_path``
(``{checkpoint_path}/bgem3.safetensors`` from ``convert_bgem3``, at the
model's preset shapes), else the committed asset for "eval-small", else
seeded.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import (
    ASSETS_DIR,
    load_npz_asset,
    restore_params,
)
from audio_rag_tpu_torch.config import EmbeddingConfig
from audio_rag_tpu_torch.core.types import EmbeddingResult, SparseVector
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.engine.engine import get_engine, peek_engine
from audio_rag_tpu_torch.models.bert import BERT_PRESETS, BertDims
from audio_rag_tpu_torch.models.bgem3 import bgem3_forward, init_bgem3
from audio_rag_tpu_torch.resources.estimates import bgem3_gb
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer, pad_batch
from audio_rag_tpu_torch.weights import bgem3_params
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["BGEM3Embedder"]


def _bucket(n: int, lo: int = 16, hi: int = 512) -> int:
    b = lo
    while b < min(n, hi):
        b <<= 1
    return min(b, hi)


class BGEM3Embedder:
    def __init__(self, config: EmbeddingConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or EmbeddingConfig()
        self.device = resolve_device(device)
        preset = {"test": "test", "eval-small": "retrieval-small"}.get(
            self.config.model, "xlmr-large")
        self.dims: BertDims = BERT_PRESETS[preset]
        #: the manager's booking: the bf16 weights
        self.hbm_required_gb = bgem3_gb(self.dims)
        self._params = None
        self._tok = get_tokenizer(self.config.checkpoint_path,
                                  self.dims.vocab)

    @property
    def is_loaded(self) -> bool:
        return self._params is not None

    def load(self) -> None:
        if self.is_loaded:
            return
        rm = get_resource_manager()
        rm.ensure_hbm(self.hbm_required_gb, for_model="embeddings")
        tree = None
        if self.config.checkpoint_path:
            tree = restore_params(self.config.checkpoint_path, "bgem3")
        if tree is None and self.config.model == "eval-small":
            tree = load_npz_asset(ASSETS_DIR / "retr_embedder_small.npz")
        if tree is not None:
            params = bgem3_params(tree, self.dims, self.device,
                                  dtype=torch.bfloat16)
        else:
            params = init_bgem3(self.dims, seed=self.config.seed,
                                device=self.device, dtype=torch.bfloat16)
        self._params = get_engine(self.device).put_params("bgem3", params)
        rm.register_model("embeddings", self.hbm_required_gb, self)

    def unload(self) -> None:
        """Drop the weights (and their booking); the next use loads them."""
        if not self.is_loaded:
            return
        engine = peek_engine()
        if engine is not None:
            engine.drop_params("bgem3")
        self._params = None
        get_resource_manager().unregister("embeddings")

    @timed
    def embed(self, texts: list[str]) -> list[EmbeddingResult]:
        if not self.is_loaded:
            self.load()
        get_resource_manager().touch("embeddings")
        out: list[EmbeddingResult] = []
        bs = self.config.batch_size
        for i in range(0, len(texts), bs):
            out.extend(self._embed_batch(texts[i: i + bs]))
        return out

    def embed_query(self, query: str) -> EmbeddingResult:
        return self.embed([query])[0]

    @torch.inference_mode()
    def _embed_batch(self, texts: list[str]) -> list[EmbeddingResult]:
        seqs = [self._tok.encode(t)[: self.config.max_length] for t in texts]
        T = _bucket(max(len(s) for s in seqs), hi=self.config.max_length)
        B = _bucket(len(seqs), lo=1, hi=self.config.batch_size)
        ids, _ = pad_batch(seqs, T, -1)  # -1 padding doubles as the mask
        if len(seqs) < B:
            ids = np.pad(ids, ((0, B - len(seqs)), (0, 0)),
                         constant_values=-1)
        packed = torch.from_numpy(ids).long().to(self.device)
        mask = (packed >= 0).long()
        tokens = torch.where(mask.bool(), packed,
                             torch.full_like(packed, self.dims.pad_id))
        dense, w = bgem3_forward(self._params, self.dims, tokens, mask)
        dense = dense.cpu().numpy()
        weights = w.cpu().numpy()

        results: list[EmbeddingResult] = []
        for j, (text, seq) in enumerate(zip(texts, seqs)):
            sparse = (self._to_sparse(seq, weights[j])
                      if self.config.use_sparse else None)
            results.append(EmbeddingResult(dense=dense[j], sparse=sparse,
                                           text=text))
        return results

    def _to_sparse(self, seq: list[int], w: np.ndarray) -> SparseVector:
        specials = {self._tok.cls_id, self._tok.sep_id, self._tok.pad_id}
        pooled: dict[int, float] = {}
        for pos, tid in enumerate(seq[: w.shape[0]]):
            if tid in specials or w[pos] <= 0:
                continue
            prev = pooled.get(tid)
            if prev is None or w[pos] > prev:
                pooled[tid] = float(w[pos])
        return SparseVector(list(pooled), list(pooled.values()))
