"""JAX-layout parameter trees (nested dicts of numpy arrays) → the port's
parameters on a device.

The trees come from a committed ``.npz`` asset
(:func:`audio_rag_tpu_torch.checkpoint.load_npz_asset`) or from
``np.asarray`` of each leaf of a JAX tree, so both packages compute from
the same numbers. Each converter checks the tree against the layout the
model expects — every key present, no unknown key, every shape, and a
floating (or, for quantized trees, the exact) dtype — and raises
``KeyError`` or ``ValueError`` otherwise. The layout is kept: stacked
(L, ...) blocks, (din, dout) weights, per-layer lists for the quantized
decode tree, the transposed or packed cross K/V, the int8 self cache.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.models.bert import BertDims
from audio_rag_tpu_torch.models.layers import q4_group
from audio_rag_tpu_torch.models.speaker import SpeakerDims
from audio_rag_tpu_torch.models.whisper import WhisperDims

__all__ = [
    "whisper_spec",
    "bgem3_spec",
    "cross_encoder_spec",
    "speaker_spec",
    "vad_spec",
    "whisper_params",
    "whisper_q8_params",
    "whisper_cross_kv",
    "whisper_self_cache_q8",
    "bgem3_params",
    "cross_encoder_params",
    "speaker_params",
    "vad_params",
]

Shape = tuple[int, ...]


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Slash-joined key → leaf; a list's items are keyed by their index."""
    flat: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, list):
            v = {str(i): item for i, item in enumerate(v)}
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


def _bert_spec(dims: BertDims) -> dict[str, Shape]:
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
    return spec


def bgem3_spec(dims: BertDims) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a BGE-M3 tree."""
    spec = _bert_spec(dims)
    spec.update(_lin("sparse", None, dims.d_model, 1))
    return spec


def cross_encoder_spec(dims: BertDims, n_out: int = 1) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a cross-encoder tree
    (``n_out`` 1: the reranker; 3: the NLI head)."""
    spec = _bert_spec(dims)
    spec.update(_lin("dense", None, dims.d_model, dims.d_model))
    spec.update(_lin("out", None, dims.d_model, n_out))
    return spec


def speaker_spec(dims: SpeakerDims) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a speaker-encoder tree
    (the blocks list keyed by index)."""
    spec: dict[str, Shape] = {}
    c_in = dims.n_mels
    for i in range(dims.n_blocks):
        spec[f"blocks/{i}/conv/w"] = (dims.kernel, c_in, dims.channels)
        spec[f"blocks/{i}/conv/b"] = (dims.channels,)
        spec.update(_ln(f"blocks/{i}/ln", None, dims.channels))
        c_in = dims.channels
    spec.update(_lin("attn", None, dims.channels, 1))
    spec.update(_lin("proj", None, 2 * dims.channels, dims.emb_dim))
    return spec


def vad_spec(n_mels: int = 80, channels: int = 64) -> dict[str, Shape]:
    """Slash-joined key → shape of every leaf of a VAD tree."""
    spec: dict[str, Shape] = {"c1/w": (5, n_mels, channels),
                              "c1/b": (channels,),
                              "c2/w": (5, channels, channels),
                              "c2/b": (channels,)}
    spec.update(_ln("ln1", None, channels))
    spec.update(_ln("ln2", None, channels))
    spec.update(_lin("out", None, channels, 1))
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


def cross_encoder_params(tree: dict, dims: BertDims,
                         device: str | torch.device = "cpu",
                         dtype: torch.dtype = torch.float32) -> dict:
    """A cross-encoder tree (``init_cross_encoder`` layout: "bert",
    "dense", "out") → tensors of ``dtype``; the head's width (1 or 3)
    follows ``out/w``."""
    shape = np.shape(_flatten(tree).get("out/w", ()))
    if len(shape) != 2:
        raise KeyError(f"cross-encoder tree: out/w has shape {shape}, "
                       "expected (d_model, n_out)")
    return _float_tree(tree, cross_encoder_spec(dims, shape[1]),
                       "cross-encoder", device, dtype)


def speaker_params(tree: dict, dims: SpeakerDims,
                   device: str | torch.device = "cpu",
                   dtype: torch.dtype = torch.float32) -> dict:
    """A speaker-encoder tree (``init_speaker_encoder`` layout, blocks as
    a list or keyed by index) → tensors, blocks as a list."""
    out = _float_tree(tree, speaker_spec(dims), "speaker", device, dtype)
    out["blocks"] = [out["blocks"][str(i)] for i in range(dims.n_blocks)]
    return out


def vad_params(tree: dict, device: str | torch.device = "cpu",
               dtype: torch.dtype = torch.float32) -> dict:
    """A VAD tree (``init_vad`` layout, nested or with the asset's flat
    "c1/w" keys) → tensors; the widths follow ``c1/w``."""
    flat = _flatten(tree)
    shape = np.shape(flat.get("c1/w", ()))
    if len(shape) != 3:
        raise KeyError(f"VAD tree: c1/w has shape {shape}, expected "
                       "(5, n_mels, channels)")
    return _float_tree(_nest(flat), vad_spec(shape[1], shape[2]), "VAD",
                       device, dtype)


def _quant_leaf(prefix: str, leaf: Any, din: int,
                dout: int) -> dict[str, Shape]:
    """Spec of one quantized linear: int8 {"w8" (din, dout), "s" (dout,)}
    or int4 {"w4" (din/2, dout), "s" (din/group, dout)}, by its keys."""
    keys = set(leaf) if isinstance(leaf, dict) else set()
    if keys == {"w8", "s"}:
        return {f"{prefix}/w8": (din, dout), f"{prefix}/s": (dout,)}
    if keys == {"w4", "s"}:
        return {f"{prefix}/w4": (din // 2, dout),
                f"{prefix}/s": (din // q4_group(din), dout)}
    raise KeyError(f"quantized decoder leaf {prefix}: keys {sorted(keys)}, "
                   "expected ['s', 'w8'] or ['s', 'w4']")


def whisper_q8_params(tree: dict, dims: WhisperDims,
                      device: str | torch.device = "cpu") -> dict:
    """The JAX package's ``quantize_decoder_weights`` tree — int8, int4 or
    int8 blocks with an int4 head ({"blocks": [per-layer {name: {"w8", "s"}
    or {"w4", "s"}}], "logits": {...}}) → tensors, the int8 weights, packed
    int4 bytes and f32 scales kept exactly."""
    d = dims.n_text_state
    shapes = {"attn_q": (d, d), "attn_k": (d, d), "attn_v": (d, d),
              "attn_o": (d, d), "cross_q": (d, d), "cross_o": (d, d),
              "mlp_up": (d, 4 * d), "mlp_down": (4 * d, d)}
    if set(tree) != {"blocks", "logits"}:
        raise KeyError(f"quantized decoder tree keys {sorted(tree)}, "
                       "expected ['blocks', 'logits']")
    blocks = tree["blocks"]
    if len(blocks) != dims.n_text_layer:
        raise ValueError(f"quantized decoder tree has {len(blocks)} layers, "
                         f"expected {dims.n_text_layer}")
    vocab_pad = -(-dims.n_vocab // 128) * 128
    spec: dict[str, Shape] = {}
    flat: dict[str, Any] = {}
    for i, blk in enumerate(blocks):
        for name, (din, dout) in shapes.items():
            spec.update(_quant_leaf(f"{i}/{name}", blk.get(name), din, dout))
        flat.update(_flatten(blk, str(i)))
    spec.update(_quant_leaf("logits", tree["logits"], d, vocab_pad))
    flat.update(_flatten(tree["logits"], "logits"))
    _check_keys(flat, spec, "quantized decoder")
    for key, arr in flat.items():
        want = "float32" if key.endswith("/s") else "int8"
        got = np.asarray(arr).dtype.name
        if got != want:
            raise ValueError(f"quantized decoder leaf {key}: dtype {got}, "
                             f"expected {want}")
    dev = torch.device(device)
    out = _nest({k: _to_tensor(v, dev, None) for k, v in flat.items()})
    return {"blocks": [out[str(i)] for i in range(len(blocks))],
            "logits": out["logits"]}


def _exact(parts, specs, what: str, device) -> tuple[torch.Tensor, ...]:
    """Arrays held to (shape, dtype name) specs → tensors, values kept."""
    if len(parts) != len(specs):
        raise ValueError(f"{what}: {len(parts)} arrays, expected "
                         f"{len(specs)}")
    for i, (arr, (shape, dtype)) in enumerate(zip(parts, specs)):
        got = (tuple(np.shape(arr)), np.asarray(arr).dtype.name)
        if got != (tuple(shape), dtype):
            raise ValueError(f"{what} array {i}: {got}, expected "
                             f"{(tuple(shape), dtype)}")
    dev = torch.device(device)
    return tuple(_to_tensor(a, dev, None) for a in parts)


def whisper_cross_kv(parts, dims: WhisperDims,
                     device: str | torch.device = "cpu"
                     ) -> tuple[torch.Tensor, ...]:
    """The JAX package's quantized ``precompute_cross_kv`` output → tensors:
    the int8 quadruple (k8, v8 (L, B, H, hd, Ta) int8, scales
    (L, B, H, 1, 1) f32) or the int4 one (k4, v4 (L, B, H, hd/2, Ta) int8,
    per-channel scales (L, B, H, 1, hd) f32), told apart by the K axis."""
    L, H = dims.n_text_layer, dims.n_text_head
    hd = dims.n_text_state // H
    shape = tuple(np.shape(parts[0]))
    if len(parts) != 4 or len(shape) != 5:
        raise ValueError("cross K/V: expected (k, v, k_scale, v_scale) with "
                         "5-dim K/V")
    B, rows, Ta = shape[1], shape[3], shape[4]
    if rows not in (hd, hd // 2):
        raise ValueError(f"cross K/V axis 3 is {rows}, expected {hd} (int8) "
                         f"or {hd // 2} (int4)")
    kv = ((L, B, H, rows, Ta), "int8")
    sc = ((L, B, H, 1, 1 if rows == hd else hd), "float32")
    return _exact(parts, (kv, kv, sc, sc), "cross K/V", device)


def whisper_self_cache_q8(parts, dims: WhisperDims,
                          device: str | torch.device = "cpu"
                          ) -> tuple[torch.Tensor, ...]:
    """The JAX package's ``quantize_self_cache`` triple (k8, v8
    (L, B, H, hd, Cp) int8, packed scales (L, B, Cp, 128) f32) → tensors."""
    L, H = dims.n_text_layer, dims.n_text_head
    hd = dims.n_text_state // H
    shape = tuple(np.shape(parts[0]))
    if len(parts) != 3 or len(shape) != 5:
        raise ValueError("self cache: expected (k8, v8, scales) with 5-dim "
                         "K/V")
    B, Cp = shape[1], shape[4]
    if Cp % 128:
        raise ValueError(f"self cache: {Cp} positions, not a multiple of "
                         "128")
    kv = ((L, B, H, hd, Cp), "int8")
    return _exact(parts, (kv, kv, ((L, B, Cp, 128), "float32")),
                  "self cache", device)
