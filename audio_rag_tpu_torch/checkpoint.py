"""Model weights on disk ↔ nested dicts of numpy arrays.

Own copy of ``audio_rag_tpu/checkpoint.py::load_npz_asset`` and
``save_npz_asset``: the same format (slash-joined keys, one compressed
``.npz``), so either package reads what the other writes. The assets stay
in the JAX package's ``assets/`` directory and are read there as data files;
:mod:`audio_rag_tpu_torch.weights` turns the trees into device tensors.

Converted checkpoints (``checkpoint_path``): :func:`save_params` and
:func:`restore_params` mirror the JAX package's, but where that one writes
an orbax directory ``{path}/{name}/``, the port writes and reads one
safetensors file ``{path}/{name}.safetensors`` with slash-joined keys (a
list's items keyed by their index; a level whose keys are all integers
reads back as a list). The safetensors reader and writer are the port's
own (:func:`load_safetensors`, :func:`save_safetensors`): an 8-byte
little-endian header length, a JSON header of each tensor's dtype, shape
and byte range, then the raw little-endian bytes. The reader maps the file
(``mmap``) and returns views of it; BF16 tensors, which numpy cannot hold,
come back widened to f32 (the JAX converter's reader cannot read them at
all).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["ASSETS_DIR", "flatten_tree", "nest_tree", "host_tree",
           "load_npz_asset", "save_npz_asset",
           "load_safetensors", "save_safetensors", "save_params",
           "restore_params", "stored_elements"]

#: the committed trained assets (data files of the sibling JAX package)
ASSETS_DIR = Path(__file__).resolve().parents[1] / "audio_rag_tpu" / "assets"


def nest_tree(flat: dict) -> dict:
    """Slash-joined keys → a nested dict."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Slash-joined key → leaf; a list's items are keyed by their index."""
    flat: dict = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, list):
            v = {str(i): item for i, item in enumerate(v)}
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
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
    np.savez_compressed(path, **flatten_tree(host_tree(params)))


def load_npz_asset(path: str | Path) -> Any | None:
    """Load a ``.npz`` asset (slash-joined keys) into a nested dict;
    ``None`` when the file is missing."""
    p = Path(path)
    if not p.exists():
        return None
    with np.load(p) as data:
        return nest_tree({k: data[k] for k in data.files})


# -- safetensors -------------------------------------------------------------

#: safetensors dtype names ↔ the numpy dtypes ``safetensors.numpy`` gives
#: (BF16 has none: it is read as its bit pattern and widened to f32)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_, "BF16": np.uint16}
_ST_NAMES = {np.dtype(v).str: k for k, v in _ST_DTYPES.items()
             if k != "BF16"}


def _st_leaf(x: Any) -> tuple[str, np.ndarray]:
    """(safetensors dtype, contiguous little-endian array of the bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return "BF16", x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")  # np.ascontiguousarray would make 0-d 1-d
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    name = _ST_NAMES.get(a.dtype.str)
    if name is None:
        raise ValueError(f"dtype {a.dtype} has no safetensors name this "
                         f"writer knows ({sorted(_ST_DTYPES)})")
    return name, a


def save_safetensors(path: str | Path, tensors: dict[str, Any],
                     metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (name → numpy array or tensor; bf16 tensors keep
    their bits) as one safetensors file, tensor by tensor."""
    leaves = {k: _st_leaf(v) for k, v in tensors.items()}
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for k, (name, a) in leaves.items():
        header[k] = {"dtype": name, "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, a in leaves.values():
            if a.nbytes:
                f.write(memoryview(a.reshape(-1)).cast("B"))


def _read_header(path: str | Path) -> dict:
    """A safetensors file's JSON header alone."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: not a safetensors file")
        return json.loads(f.read(struct.unpack("<Q", raw)[0]))


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as a numpy array: read-only
    views of the mapped file, in the file's dtype, except BF16, widened
    to f32 through its bit pattern."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, not a safetensors file")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > size:
        raise ValueError(f"{path}: a header of {n} bytes in a file of {size}")
    header = json.loads(bytes(buf[8: 8 + n]))
    base = 8 + n
    out: dict[str, np.ndarray] = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        name = info["dtype"]
        if name not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {key} has dtype {name}, which "
                             f"this reader does not know")
        dt = np.dtype(_ST_DTYPES[name]).newbyteorder("<")
        shape = tuple(int(d) for d in info["shape"])
        lo, hi = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if hi - lo != count * dt.itemsize or base + hi > size:
            raise ValueError(f"{path}: tensor {key}'s byte range {lo}:{hi} "
                             f"does not hold {shape} of {name}")
        a = np.frombuffer(buf, dtype=dt, count=count,
                          offset=base + lo).reshape(shape)
        if name == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[key] = a
    return out


# -- converted checkpoints ---------------------------------------------------

def _listify(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[k] for k in sorted(node, key=int)]
    return node


def _params_file(path: str | Path, name: str) -> Path:
    return Path(path).expanduser().resolve() / f"{name}.safetensors"


def stored_elements(path: str | Path, name: str) -> int | None:
    """Elements of every tensor under ``{path}/{name}`` (from the file's
    header alone); ``None`` when the file is missing."""
    f = _params_file(path, name)
    if not f.exists():
        return None
    header = _read_header(f)
    return sum(int(np.prod(v["shape"], dtype=np.int64))
               for k, v in header.items() if k != "__metadata__")


def save_params(path: str | Path, name: str, params: Any) -> Path:
    """Write a parameter tree (nested dicts and lists of arrays or
    tensors) as ``{path}/{name}.safetensors``, each leaf in its own dtype;
    returns the file."""
    f = _params_file(path, name)
    f.parent.mkdir(parents=True, exist_ok=True)
    save_safetensors(f, flatten_tree(params))
    return f


def restore_params(path: str | Path, name: str) -> Any | None:
    """The tree :func:`save_params` wrote under ``{path}/{name}``, levels
    keyed by integers as lists; ``None`` when the file is missing."""
    f = _params_file(path, name)
    if not f.exists():
        return None
    return _listify(nest_tree(load_safetensors(f)))
