"""JAX-layout parameter trees (nested dicts of numpy arrays) → the port's
parameters on a device.

The trees come from a committed ``.npz`` asset
(:func:`audio_rag_tpu_torch.checkpoint.load_npz_asset`) or from
``np.asarray`` of each leaf of a JAX tree, so both packages compute from
the same numbers. Each converter checks the tree against the layout the
model expects — every key present, no unknown key, every shape, and a
floating (or, for int8 trees, the exact) dtype — and raises ``KeyError``
or ``ValueError`` otherwise. The layout is kept: stacked (L, ...) blocks,
(din, dout) weights, per-layer lists for the int8 decode tree.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.models.bert import BertDims
from audio_rag_tpu_torch.models.whisper import WhisperDims

__all__ = [
    "whisper_spec",
    "bgem3_spec",
    "whisper_params",
    "whisper_q8_params",
    "bgem3_params",
]

Shape = tuple[int, ...]


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _nest(flat: dict[str, Any]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _lin(prefix: str, L: int | None, din: int, dout: int,
         bias: bool = True) -> dict[str, Shape]:
    lead = () if L is None else (L,)
    out = {f"{prefix}/w": (*lead, din, dout)}
    if bias:
        out[f"{prefix}/b"] = (*lead, dout)
    return out


def _ln(prefix: str, L: int | None, d: int) -> dict[str, Shape]:
    lead = () if L is None else (L,)
    return {f"{prefix}/g": (*lead, d), f"{prefix}/b": (*lead, d)}


def _whisper_blocks(prefix: str, L: int, d: int,
                    cross: bool) -> dict[str, Shape]:
    spec: dict[str, Shape] = {}
    attns = ("attn", "cross") if cross else ("attn",)
    for a in attns:
        spec.update(_lin(f"{prefix}/{a}/q", L, d, d))
        spec.update(_lin(f"{prefix}/{a}/k", L, d, d, bias=False))
        spec.update(_lin(f"{prefix}/{a}/v", L, d, d))
        spec.update(_lin(f"{prefix}/{a}/o", L, d, d))
    spec.update(_ln(f"{prefix}/ln1", L, d))
    spec.update(_ln(f"{prefix}/ln_mlp", L, d))
    if cross:
        spec.update(_ln(f"{prefix}/ln_cross", L, d))
    spec.update(_lin(f"{prefix}/mlp/up", L, d, 4 * d))
    spec.update(_lin(f"{prefix}/mlp/down", L, 4 * d, d))
    return spec


def whisper_spec(dims: WhisperDims) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a Whisper tree."""
    d_a, d_t = dims.n_audio_state, dims.n_text_state
    spec: dict[str, Shape] = {
        "encoder/conv1/w": (3, dims.n_mels, d_a),
        "encoder/conv1/b": (d_a,),
        "encoder/conv2/w": (3, d_a, d_a),
        "encoder/conv2/b": (d_a,),
        "encoder/pos": (dims.n_audio_ctx, d_a),
        "decoder/tok_emb/table": (dims.n_vocab, d_t),
        "decoder/pos_emb": (dims.n_text_ctx, d_t),
    }
    spec.update(_ln("encoder/ln_post", None, d_a))
    spec.update(_ln("decoder/ln", None, d_t))
    spec.update(_whisper_blocks("encoder/blocks", dims.n_audio_layer, d_a,
                                cross=False))
    spec.update(_whisper_blocks("decoder/blocks", dims.n_text_layer, d_t,
                                cross=True))
    return spec


def bgem3_spec(dims: BertDims) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a BGE-M3 tree."""
    L, d = dims.n_layers, dims.d_model
    spec: dict[str, Shape] = {
        "bert/tok_emb/table": (dims.vocab, d),
        "bert/pos_emb/table": (dims.max_len + dims.pos_offset, d),
    }
    spec.update(_ln("bert/ln_emb", None, d))
    for a in ("q", "k", "v", "o"):
        spec.update(_lin(f"bert/blocks/attn/{a}", L, d, d))
    spec.update(_ln("bert/blocks/ln_attn", L, d))
    spec.update(_ln("bert/blocks/ln_mlp", L, d))
    spec.update(_lin("bert/blocks/mlp/up", L, d, dims.d_ff))
    spec.update(_lin("bert/blocks/mlp/down", L, dims.d_ff, d))
    spec.update(_lin("sparse", None, d, 1))
    return spec


def _to_tensor(arr: Any, device: torch.device,
               dtype: torch.dtype | None) -> torch.Tensor:
    a = np.array(arr)  # a copy: the tree's arrays may be read-only views
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.dtype != dtype:
        t = t.float().to(dtype)  # f16 → bf16 goes through f32, as in JAX
    return t.to(device)


def _check_keys(flat: dict[str, Any], spec: dict[str, Shape],
                what: str) -> None:
    missing = sorted(set(spec) - set(flat))
    unknown = sorted(set(flat) - set(spec))
    if missing or unknown:
        raise KeyError(f"{what} tree does not match the model: missing "
                       f"{missing[:8]}, unknown {unknown[:8]}")
    for key, shape in spec.items():
        got = tuple(np.shape(flat[key]))
        if got != tuple(shape):
            raise ValueError(f"{what} leaf {key}: shape {got}, "
                             f"expected {tuple(shape)}")


def _float_tree(tree: dict, spec: dict[str, Shape], what: str,
                device: str | torch.device, dtype: torch.dtype) -> dict:
    flat = _flatten(tree)
    _check_keys(flat, spec, what)
    for key, arr in flat.items():
        name = np.asarray(arr).dtype.name
        if name not in ("float16", "float32", "float64", "bfloat16"):
            raise ValueError(f"{what} leaf {key}: dtype {name} is not "
                             "floating")
    dev = torch.device(device)
    return _nest({k: _to_tensor(v, dev, dtype) for k, v in flat.items()})


def whisper_params(tree: dict, dims: WhisperDims,
                   device: str | torch.device = "cpu",
                   dtype: torch.dtype = torch.float32) -> dict:
    """A Whisper tree (``init_whisper`` layout) → tensors of ``dtype``."""
    return _float_tree(tree, whisper_spec(dims), "whisper", device, dtype)


def bgem3_params(tree: dict, dims: BertDims,
                 device: str | torch.device = "cpu",
                 dtype: torch.dtype = torch.float32) -> dict:
    """A BGE-M3 tree (``init_bgem3`` layout) → tensors of ``dtype``."""
    return _float_tree(tree, bgem3_spec(dims), "bgem3", device, dtype)


_Q8_BLOCK_SHAPES = ("attn_q", "attn_k", "attn_v", "attn_o", "cross_q",
                    "cross_o", "mlp_up", "mlp_down")


def whisper_q8_params(tree: dict, dims: WhisperDims,
                      device: str | torch.device = "cpu") -> dict:
    """The JAX package's ``quantize_decoder_weights(bits=8)`` tree
    ({"blocks": [per-layer {name: {"w8", "s"}}], "logits": {"w8", "s"}})
    → tensors, int8 weights and f32 scales kept exactly."""
    d = dims.n_text_state
    shapes = {"attn_q": (d, d), "attn_k": (d, d), "attn_v": (d, d),
              "attn_o": (d, d), "cross_q": (d, d), "cross_o": (d, d),
              "mlp_up": (d, 4 * d), "mlp_down": (4 * d, d)}
    if set(tree) != {"blocks", "logits"}:
        raise KeyError(f"int8 decoder tree keys {sorted(tree)}, expected "
                       "['blocks', 'logits']")
    blocks = tree["blocks"]
    if len(blocks) != dims.n_text_layer:
        raise ValueError(f"int8 decoder tree has {len(blocks)} layers, "
                         f"expected {dims.n_text_layer}")
    vocab_pad = -(-dims.n_vocab // 128) * 128
    spec: dict[str, Shape] = {}
    flat: dict[str, Any] = {}
    for i, blk in enumerate(blocks):
        for name in _Q8_BLOCK_SHAPES:
            din, dout = shapes[name]
            spec[f"{i}/{name}/w8"] = (din, dout)
            spec[f"{i}/{name}/s"] = (dout,)
        flat.update(_flatten(blk, str(i)))
    spec["logits/w8"] = (d, vocab_pad)
    spec["logits/s"] = (vocab_pad,)
    flat.update(_flatten(tree["logits"], "logits"))
    _check_keys(flat, spec, "int8 decoder")
    for key, arr in flat.items():
        want = "int8" if key.endswith("/w8") else "float32"
        got = np.asarray(arr).dtype.name
        if got != want:
            raise ValueError(f"int8 decoder leaf {key}: dtype {got}, "
                             f"expected {want}")
    dev = torch.device(device)
    out = _nest({k: _to_tensor(v, dev, None) for k, v in flat.items()})
    return {"blocks": [out[str(i)] for i in range(len(blocks))],
            "logits": out["logits"]}
