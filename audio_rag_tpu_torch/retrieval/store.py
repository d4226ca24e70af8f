"""In-memory vector store on the device (counterpart of
``audio_rag_tpu/retrieval/tpu_store.py``).

A collection keeps host mirrors (f32 dense rows L2-normalized at add time,
fixed-width sparse (token, weight) rows padded with −1/0, payloads) and
uploads them to the device once per mutation; a search is one call of
:func:`audio_rag_tpu_torch.ops.similarity.hybrid_search` over the
device-resident arrays. Capacity grows in ``capacity_step`` rows.

* Metadata filters run on the device: the first filter on a key interns
  its payload values into an int32 column (−2: a row past the count, −3:
  an unhashable value; neither equals any code), cached beside the corpus
  arrays and dropped with them. A filter value that cannot be hashed takes
  a host O(N) mask instead.
* ``quantize_dense``: the corpus is uploaded as int8 rows with per-row
  scales ``max(|row|, 1e-9) / 127`` computed on the host.
* ``persist_dir``: every add writes ``<name>.npz`` (the rows in use) and
  ``<name>.json`` (the payloads), the JAX store's files; a store built on
  the directory loads every collection there, whichever package wrote it.
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.config import RetrievalConfig
from audio_rag_tpu_torch.core.exceptions import RetrievalError
from audio_rag_tpu_torch.core.types import (
    AudioChunk,
    EmbeddingResult,
    RetrievalResult,
    SparseVector,
)
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.ops.similarity import hybrid_search, rrf_prefetch
from audio_rag_tpu_torch.text.tokenizer import norm_tokens
from audio_rag_tpu_torch.utils.decorators import timed

__all__ = ["VectorStore", "Collection"]


def _intern(vocab: dict[Any, int], value: Any) -> int:
    """Value → stable small int code; an unhashable value codes to −3 (it
    never equals a hashable filter value, as ``md.get(k) != v`` holds)."""
    try:
        return vocab.setdefault(value, len(vocab))
    except TypeError:
        return -3


@dataclass
class Collection:
    name: str
    dim: int
    max_doc_nnz: int
    capacity: int = 0
    count: int = 0
    dense: np.ndarray | None = None  # (capacity, dim) f32
    doc_tokens: np.ndarray | None = None  # (capacity, max_doc_nnz) i32, -1 pad
    doc_weights: np.ndarray | None = None  # (capacity, max_doc_nnz) f32
    payloads: list[dict[str, Any]] = field(default_factory=list)
    #: metadata key → (capacity,) int32 interned value codes, built at the
    #: key's first filtered search and extended by ``add``
    index_cols: dict[str, np.ndarray] = field(default_factory=dict)
    index_vocab: dict[str, dict[Any, int]] = field(default_factory=dict)
    #: upload the dense rows as int8 with per-row scales
    quantize_dense: bool = False
    #: device copies (corpus arrays and "col:<key>" filter columns);
    #: dropped whenever the host mirrors change
    device_arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    #: identity of this collection for caches kept outside it (the query
    #: engine's reranker tokens): a recreated collection gets a new one
    uid: str = field(default_factory=lambda: uuid.uuid4().hex)
    #: (count, per-term document frequency) of ``VectorStore.term_stats``
    term_stats_cache: tuple[int, dict[str, int]] | None = None

    def ensure_capacity(self, n_new: int, step: int) -> None:
        needed = self.count + n_new
        cap = max(step, -(-needed // step) * step)
        if self.dense is not None and cap <= self.capacity:
            return
        grow = cap - self.capacity
        pads = (np.zeros((grow, self.dim), np.float32),
                np.full((grow, self.max_doc_nnz), -1, np.int32),
                np.zeros((grow, self.max_doc_nnz), np.float32))
        if self.dense is None:
            self.dense, self.doc_tokens, self.doc_weights = pads
        else:
            self.dense = np.concatenate([self.dense, pads[0]])
            self.doc_tokens = np.concatenate([self.doc_tokens, pads[1]])
            self.doc_weights = np.concatenate([self.doc_weights, pads[2]])
        for key, col in self.index_cols.items():
            self.index_cols[key] = np.concatenate(
                [col, np.full(grow, -2, np.int32)])
        self.capacity = cap
        self.device_arrays = {}

    def upload(self, device: torch.device) -> dict[str, torch.Tensor]:
        if "dense" not in self.device_arrays:  # filter columns may be there
            mask = np.zeros(self.capacity, bool)
            mask[: self.count] = True
            dev = dict(self.device_arrays)
            dev.update(
                doc_tokens=torch.from_numpy(self.doc_tokens).to(device),
                doc_weights=torch.from_numpy(self.doc_weights).to(device),
                valid_mask=torch.from_numpy(mask).to(device))
            if self.quantize_dense:
                row_max = np.abs(self.dense).max(axis=1)
                scales = np.maximum(row_max, 1e-9) / 127.0
                q = np.clip(np.round(self.dense / scales[:, None]),
                            -127, 127).astype(np.int8)
                dev["dense"] = torch.from_numpy(q).to(device)
                dev["scales"] = torch.from_numpy(
                    scales.astype(np.float32)).to(device)
            else:
                dev["dense"] = torch.from_numpy(self.dense).to(device)
            self.device_arrays = dev
        return self.device_arrays


def _pad_sparse(sv: SparseVector | None,
                width: int) -> tuple[np.ndarray, np.ndarray]:
    tok = np.full(width, -1, np.int32)
    w = np.zeros(width, np.float32)
    if sv is not None and sv.nnz:
        n = min(sv.nnz, width)
        if sv.nnz > width:  # keep the strongest terms
            keep = np.argsort(-sv.values)[:width]
            keep.sort()
            tok[:n] = sv.indices[keep]
            w[:n] = sv.values[keep]
        else:
            tok[:n] = sv.indices
            w[:n] = sv.values
    return tok, w


class VectorStore:
    """Hybrid (dense + sparse, RRF) vector store on one device."""

    def __init__(self, config: RetrievalConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or RetrievalConfig()
        self.device = resolve_device(device)
        self._collections: dict[str, Collection] = {}
        if self.config.persist_dir:
            self._load_all()

    def _coll(self, name: str | None) -> Collection | None:
        return self._collections.get(name or self.config.collection_name)

    def _new_collection(self, name: str, dim: int,
                        max_doc_nnz: int) -> Collection:
        return Collection(name, dim, max_doc_nnz,
                          quantize_dense=self.config.quantize_dense)

    def list_collections(self) -> list[str]:
        return sorted(self._collections)

    def collection_exists(self, collection: str | None = None) -> bool:
        return self._coll(collection) is not None

    @timed
    def add(self, chunks: list[AudioChunk], embeddings: list[EmbeddingResult],
            collection: str | None = None) -> int:
        if len(chunks) != len(embeddings):
            raise RetrievalError(f"chunks/embeddings mismatch: {len(chunks)} "
                                 f"vs {len(embeddings)}")
        if not chunks:
            return 0
        dim = embeddings[0].dim
        if dim == 0:
            raise RetrievalError("embeddings must include dense vectors")
        cname = collection or self.config.collection_name
        coll = self._collections.setdefault(
            cname, self._new_collection(cname, dim, self.config.max_doc_nnz))
        if coll.dim != dim:
            raise RetrievalError(f"dim mismatch: collection {coll.dim}, "
                                 f"got {dim}", context={"collection": cname})
        coll.ensure_capacity(len(chunks), self.config.capacity_step)
        for chunk, emb in zip(chunks, embeddings):
            i = coll.count
            vec = np.asarray(emb.dense, np.float32)
            norm = float(np.linalg.norm(vec))
            coll.dense[i] = vec / norm if norm > 0 else vec
            coll.doc_tokens[i], coll.doc_weights[i] = _pad_sparse(
                emb.sparse, coll.max_doc_nnz)
            coll.payloads.append({
                "id": chunk.chunk_id or str(uuid.uuid4()),
                "text": chunk.text, "start": chunk.start, "end": chunk.end,
                "speaker": chunk.speaker, "metadata": dict(chunk.metadata),
            })
            for key, col in coll.index_cols.items():
                col[i] = _intern(coll.index_vocab[key],
                                 chunk.metadata.get(key))
            coll.count += 1
        coll.device_arrays = {}
        if self.config.persist_dir:
            self._persist(coll)
        return len(chunks)

    # -- metadata filters ---------------------------------------------------
    @staticmethod
    def _host_mask(coll: Collection,
                   metadata_filter: dict[str, Any]) -> np.ndarray:
        """O(N) mask on the host, for a filter value that cannot be
        hashed (the interned columns cannot hold it)."""
        mask = np.zeros(coll.capacity, bool)
        mask[: coll.count] = True
        for i in range(coll.count):
            md = coll.payloads[i]["metadata"]
            if any(md.get(k) != v for k, v in metadata_filter.items()):
                mask[i] = False
        return mask

    def _device_filter(self, coll: Collection,
                       metadata_filter: dict[str, Any]
                       ) -> tuple[tuple[torch.Tensor, ...],
                                  torch.Tensor] | None:
        """(columns, wanted codes) on the device, or None when a value
        cannot be hashed. A key's column is built at its first filter."""
        cols: list[torch.Tensor] = []
        codes: list[int] = []
        for key in sorted(metadata_filter):
            value = metadata_filter[key]
            try:
                hash(value)
            except TypeError:
                return None
            if key not in coll.index_cols:
                col = np.full(coll.capacity, -2, np.int32)
                vocab: dict[Any, int] = {}
                for i in range(coll.count):
                    col[i] = _intern(vocab,
                                     coll.payloads[i]["metadata"].get(key))
                coll.index_cols[key] = col
                coll.index_vocab[key] = vocab
            codes.append(coll.index_vocab[key].get(value, -1))
            dev_key = f"col:{key}"
            if dev_key not in coll.device_arrays:
                coll.device_arrays[dev_key] = torch.from_numpy(
                    coll.index_cols[key]).to(self.device)
            cols.append(coll.device_arrays[dev_key])
        return tuple(cols), torch.tensor(codes, dtype=torch.int32,
                                         device=self.device)

    @timed
    def search(self, query_embedding: EmbeddingResult, top_k: int = 5,
               search_type: str = "hybrid", collection: str | None = None,
               metadata_filter: dict[str, Any] | None = None,
               score_threshold: float | None = None
               ) -> list[RetrievalResult]:
        coll = self._coll(collection)
        if coll is None or coll.count == 0:
            return []
        if search_type not in ("dense", "sparse", "hybrid"):
            raise RetrievalError(f"unknown search_type {search_type!r}")
        dev = coll.upload(self.device)
        mask = dev["valid_mask"]
        filter_cols: tuple[torch.Tensor, ...] = ()
        filter_codes = None
        if metadata_filter:
            device_filter = self._device_filter(coll, metadata_filter)
            if device_filter is not None:
                filter_cols, filter_codes = device_filter
            else:
                mask = torch.from_numpy(
                    self._host_mask(coll, metadata_filter)).to(self.device)
        qd = np.zeros((1, coll.dim), np.float32)
        if query_embedding.dense is not None:
            v = np.asarray(query_embedding.dense, np.float32)
            n = float(np.linalg.norm(v))
            qd[0] = v / n if n > 0 else v
        # the query's sparse terms pad to the pow-2 bucket of their nnz
        q_nnz = query_embedding.sparse.nnz if query_embedding.sparse else 0
        q_width = min(max(8, 1 << max(q_nnz - 1, 0).bit_length()),
                      self.config.max_query_nnz)
        qt, qw = _pad_sparse(query_embedding.sparse, q_width)
        k = min(top_k, coll.count)
        k_pad = 1 << (max(k, 1) - 1).bit_length()
        scores, idx = hybrid_search(
            torch.from_numpy(qd).to(self.device),
            torch.from_numpy(qt[None]).to(self.device),
            torch.from_numpy(qw[None]).to(self.device),
            dev["dense"], dev["doc_tokens"], dev["doc_weights"], mask,
            dev.get("scales"), top_k=min(k_pad, coll.capacity),
            search_type=search_type, rrf_k=float(self.config.rrf_k),
            prefetch=rrf_prefetch(k), filter_cols=filter_cols,
            filter_codes=filter_codes)
        scores = scores[0, :k].cpu().numpy()
        idx = idx[0, :k].cpu().numpy()
        thr = (score_threshold if score_threshold is not None else
               self.config.score_threshold if search_type == "dense"
               else 0.0)
        out: list[RetrievalResult] = []
        for s, i in zip(scores, idx):
            if s <= -1e29 or (thr and s < thr):
                continue
            p = coll.payloads[int(i)]
            out.append(RetrievalResult(
                text=p["text"], score=float(s), start=p["start"],
                end=p["end"], speaker=p["speaker"], chunk_id=p["id"],
                metadata=p["metadata"]))
        return out

    def count(self, collection: str | None = None) -> int:
        coll = self._coll(collection)
        return 0 if coll is None else coll.count

    def term_stats(self, collection: str | None = None
                   ) -> tuple[int, dict[str, int]]:
        """(chunks, per-term document frequency) over the collection's
        chunk texts, the statistics PRF expansion weights its terms with;
        host-side, cached until the collection's count changes."""
        coll = self._coll(collection)
        if coll is None:
            return 0, {}
        cached = coll.term_stats_cache
        if cached is not None and cached[0] == coll.count:
            return cached
        df: dict[str, int] = {}
        for p in coll.payloads[: coll.count]:
            for w in set(norm_tokens(p["text"])):
                df[w] = df.get(w, 0) + 1
        coll.term_stats_cache = (coll.count, df)
        return coll.term_stats_cache

    def collection_info(self, collection: str | None = None
                        ) -> dict[str, Any]:
        coll = self._coll(collection)
        if coll is None:
            cname = collection or self.config.collection_name
            raise RetrievalError(f"collection {cname!r} does not exist",
                                 context={"collection": cname})
        return {
            "name": coll.name, "count": coll.count,
            "capacity": coll.capacity, "dim": coll.dim,
            "hbm_bytes": 0 if coll.dense is None else (
                coll.dense.nbytes + coll.doc_tokens.nbytes
                + coll.doc_weights.nbytes),
        }

    def delete_collection(self, collection: str | None = None) -> bool:
        cname = collection or self.config.collection_name
        existed = self._collections.pop(cname, None) is not None
        if self.config.persist_dir:
            base = Path(self.config.persist_dir) / cname
            for suffix in (".npz", ".json"):
                base.with_suffix(suffix).unlink(missing_ok=True)
        return existed

    # -- persistence ------------------------------------------------------------
    def _persist(self, coll: Collection) -> None:
        base = Path(self.config.persist_dir)
        base.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            base / f"{coll.name}.npz", dense=coll.dense[: coll.count],
            doc_tokens=coll.doc_tokens[: coll.count],
            doc_weights=coll.doc_weights[: coll.count],
            dim=np.int64(coll.dim))
        with open(base / f"{coll.name}.json", "w") as f:
            json.dump(coll.payloads, f)

    def _load_all(self) -> None:
        base = Path(self.config.persist_dir)
        if not base.is_dir():
            return
        for npz_path in base.glob("*.npz"):
            name = npz_path.stem
            with np.load(npz_path) as data:
                arrays = {k: data[k] for k in data.files}
            payload_path = base / f"{name}.json"
            payloads = (json.loads(payload_path.read_text())
                        if payload_path.exists() else [])
            n = int(arrays["dense"].shape[0])
            coll = self._new_collection(
                name, int(arrays["dim"]),
                int(arrays["doc_tokens"].shape[1]) if n
                else self.config.max_doc_nnz)
            coll.ensure_capacity(n, self.config.capacity_step)
            coll.dense[:n] = arrays["dense"]
            coll.doc_tokens[:n] = arrays["doc_tokens"]
            coll.doc_weights[:n] = arrays["doc_weights"]
            coll.payloads = payloads
            coll.count = n
            self._collections[name] = coll
