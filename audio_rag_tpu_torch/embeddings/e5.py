"""Multilingual-E5 embedder of the port (counterpart of
``audio_rag_tpu/embeddings/e5.py``): the XLM-R encoder of
:mod:`audio_rag_tpu_torch.models.bert` with E5's conventions — texts
embed as ``"passage: …"`` and queries as ``"query: …"``, the states are
mean-pooled over real tokens in f32 and L2-normalized; dense only.

Model "test" keeps the tiny ``test`` preset, any other name XLM-R large
shapes; the weights come from ``checkpoint_path``
(``{checkpoint_path}/e5.safetensors``, the bare ``init_bert`` tree, as the
JAX embedder restores it) or are seeded (``seed``), as the JAX embedder
starts without files, and are stored in bf16. Batches and lengths pad to
the same power-of-two buckets as the JAX program (−1 padding doubles as
the mask).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import restore_params
from audio_rag_tpu_torch.config import EmbeddingConfig
from audio_rag_tpu_torch.core.types import EmbeddingResult
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.embeddings.bge import _bucket
from audio_rag_tpu_torch.engine.engine import get_engine, peek_engine
from audio_rag_tpu_torch.models.bert import (
    BERT_PRESETS,
    BertDims,
    bert_encode,
    init_bert,
)
from audio_rag_tpu_torch.resources.estimates import e5_gb
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer, pad_batch
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.weights import e5_params

__all__ = ["E5Embedder", "e5_forward"]


def e5_forward(params, dims: BertDims, packed: torch.Tensor) -> torch.Tensor:
    """Token ids (B, T), −1 at padding → unit mean-pooled vectors (B, d)
    in f32."""
    mask = (packed >= 0).long()
    ids = torch.where(mask.bool(), packed, torch.full_like(packed,
                                                           dims.pad_id))
    h = bert_encode(params, dims, ids, mask, torch.bfloat16)
    m = mask.float()[..., None]
    pooled = (h.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1),
                                                      min=1e-9)
    return pooled / torch.clamp(
        torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), min=1e-9)


class E5Embedder:
    def __init__(self, config: EmbeddingConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or EmbeddingConfig(backend="multilingual-e5")
        self.device = resolve_device(device)
        preset = "test" if self.config.model == "test" else "xlmr-large"
        self.dims: BertDims = BERT_PRESETS[preset]
        #: the manager's booking: the bf16 weights
        self.hbm_required_gb = e5_gb(self.dims)
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
        tree = (restore_params(self.config.checkpoint_path, "e5")
                if self.config.checkpoint_path else None)
        if tree is not None:
            params = e5_params(tree, self.dims, self.device, torch.bfloat16)
        else:
            gen = torch.Generator(device=self.device).manual_seed(
                self.config.seed)
            params = init_bert(self.dims, gen, self.device, torch.bfloat16)
        self._params = get_engine(self.device).put_params("e5", params)
        rm.register_model("embeddings", self.hbm_required_gb, self)

    def unload(self) -> None:
        """Drop the weights (and their booking); the next use loads them."""
        if not self.is_loaded:
            return
        engine = peek_engine()
        if engine is not None:
            engine.drop_params("e5")
        self._params = None
        get_resource_manager().unregister("embeddings")

    @torch.inference_mode()
    def _embed_prefixed(self, texts: list[str]) -> list[EmbeddingResult]:
        seqs = [self._tok.encode(t)[: self.config.max_length] for t in texts]
        T = _bucket(max(len(s) for s in seqs), 16, self.config.max_length)
        B = _bucket(len(seqs), 1, self.config.batch_size)
        ids, _ = pad_batch(seqs, T, -1)
        if len(seqs) < B:
            ids = np.pad(ids, ((0, B - len(seqs)), (0, 0)),
                         constant_values=-1)
        packed = torch.from_numpy(ids).long().to(self.device)
        dense = e5_forward(self._params, self.dims, packed).cpu().numpy()
        return [EmbeddingResult(dense=dense[i], sparse=None, text=t)
                for i, t in enumerate(texts)]

    @timed
    def embed(self, texts: list[str]) -> list[EmbeddingResult]:
        if not texts:
            return []
        self.load()
        out: list[EmbeddingResult] = []
        bs = self.config.batch_size
        prefixed = [f"passage: {t}" for t in texts]
        for i in range(0, len(prefixed), bs):
            out.extend(self._embed_prefixed(prefixed[i: i + bs]))
        for r, original in zip(out, texts):
            r.text = original
        return out

    def embed_query(self, query: str) -> EmbeddingResult:
        self.load()
        r = self._embed_prefixed([f"query: {query}"])[0]
        r.text = query
        return r
