"""Committed ``.npz`` model assets ↔ nested dicts of numpy arrays.

Own copy of ``audio_rag_tpu/checkpoint.py::load_npz_asset`` and
``save_npz_asset``: the same format (slash-joined keys, one compressed
``.npz``), so either package reads what the other writes. The assets stay
in the JAX package's ``assets/`` directory and are read there as data files;
:mod:`audio_rag_tpu_torch.weights` turns the trees into device tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["ASSETS_DIR", "host_tree", "load_npz_asset", "save_npz_asset"]

#: the committed trained assets (data files of the sibling JAX package)
ASSETS_DIR = Path(__file__).resolve().parents[1] / "audio_rag_tpu" / "assets"


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat: dict = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy has no bf16
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def host_tree(tree: dict) -> dict:
    """The same nested dict with every leaf a numpy array (tensors copied
    to the host; bf16 ones widened to f32)."""
    return {k: host_tree(v) if isinstance(v, dict) else _host(v)
            for k, v in tree.items()}


def save_npz_asset(path: str | Path, params: Any) -> None:
    """Write a nested dict of arrays or tensors (tensors are copied to the
    host; bf16 ones widened to f32) as one ``.npz`` asset with slash-joined
    keys."""
    np.savez_compressed(path, **_flatten(host_tree(params)))


def load_npz_asset(path: str | Path) -> Any | None:
    """Load a ``.npz`` asset (slash-joined keys) into a nested dict;
    ``None`` when the file is missing."""
    p = Path(path)
    if not p.exists():
        return None
    with np.load(p) as data:
        return _nest({k: data[k] for k in data.files})
