"""Committed ``.npz`` model assets → nested dicts of numpy arrays.

Own copy of ``audio_rag_tpu/checkpoint.py::load_npz_asset``. The assets stay
in the JAX package's ``assets/`` directory and are read there as data files;
:mod:`audio_rag_tpu_torch.weights` turns the trees into device tensors.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

__all__ = ["ASSETS_DIR", "load_npz_asset"]

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


def load_npz_asset(path: str | Path) -> Any | None:
    """Load a ``.npz`` asset (slash-joined keys) into a nested dict;
    ``None`` when the file is missing."""
    p = Path(path)
    if not p.exists():
        return None
    with np.load(p) as data:
        return _nest({k: data[k] for k in data.files})
