"""Speaker-embedding encoder and frame VAD on tensors with params in dicts.

Counterpart of ``audio_rag_tpu/models/speaker.py``: a TDNN-style stack of
SAME-padded dilated convolutions (dilation 2**i) over log-mel frames with
layer norm, ReLU and residuals, attentive statistics pooling and a linear
projection to an L2-normalized embedding; and a two-layer dilated-conv
VAD (dilations 1 and 2) scoring each 10 ms frame. Both are batched over
all windows of a call. The convolutions are library calls (cuDNN at f32,
with TF32 off; an im2col product with an f32 output at bf16): no TPU
kernel lies on this path.

Encoder weights, by precedence (:func:`resolve_speaker_params`): a
converted checkpoint (``checkpoint_path``: an ECAPA-TDNN from
``convert_speaker``, run by :mod:`audio_rag_tpu_torch.models.ecapa`, or a
TDNN tree of this module's layout), the committed trained asset
``speaker_small.npz`` (read in place through :mod:`audio_rag_tpu_torch
.checkpoint`), else a seeded init from an explicit ``torch.Generator``.
The VAD reads ``vad_small.npz``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.checkpoint import (
    ASSETS_DIR,
    load_npz_asset,
    restore_params,
)
from audio_rag_tpu_torch.device import full_f32_conv, full_f32_matmul
from audio_rag_tpu_torch.models.ecapa import ecapa_emb_dim, is_ecapa_params
from audio_rag_tpu_torch.models.layers import (
    Params,
    layer_norm,
    linear,
    mm_f32,
    mm_out_f32,
)

log = logging.getLogger(__name__)

__all__ = [
    "SpeakerDims",
    "SPEAKER_PRESETS",
    "init_speaker_encoder",
    "speaker_embed",
    "speaker_dims_from_params",
    "load_speaker_asset",
    "resolve_speaker_params",
    "init_vad",
    "vad_scores",
]


@dataclasses.dataclass(frozen=True)
class SpeakerDims:
    n_mels: int = 80
    channels: int = 512
    n_blocks: int = 3
    emb_dim: int = 192
    kernel: int = 5


SPEAKER_PRESETS: dict[str, SpeakerDims] = {
    "titanet-jax": SpeakerDims(80, 512, 3, 192, 5),
    #: the committed trained asset's shape
    "small": SpeakerDims(80, 128, 3, 128, 5),
    "test": SpeakerDims(80, 32, 2, 16, 3),
}


def _conv_init(gen: torch.Generator, k: int, c_in: int,
               c_out: int) -> Params:
    scale = (k * c_in) ** -0.5
    return {"w": torch.randn((k, c_in, c_out), generator=gen) * scale,
            "b": torch.zeros((c_out,))}


def _linear_init(gen: torch.Generator, din: int, dout: int) -> Params:
    return {"w": torch.randn((din, dout), generator=gen) * din ** -0.5,
            "b": torch.zeros((dout,))}


def _ln_init(d: int) -> Params:
    return {"g": torch.ones((d,)), "b": torch.zeros((d,))}


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _conv1d(p: Params, x: torch.Tensor, dilation: int = 1,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (B, T, C_in) → (B, T, C_out): kernel k dilated by ``dilation``
    with XLA's "SAME" padding ((k−1)·dilation split evenly, the odd one
    on the right), f32 sums of exact products, the f32 bias, one rounding
    to ``dtype``."""
    B, T, c_in = x.shape
    k = p["w"].shape[0]
    pad = (k - 1) * dilation
    w = p["w"].to(dtype)
    if dtype != torch.float32:
        # im2col, tap-major as w's rows: one product with an f32 result
        xp = F.pad(x.to(dtype), (0, 0, pad // 2, pad - pad // 2))
        cols = torch.cat([xp[:, j * dilation: j * dilation + T]
                          for j in range(k)], dim=-1)
        w2 = w.reshape(k * c_in, -1)
        y = mm_out_f32(cols, w2) if x.is_cuda else mm_f32(cols, w2)
    else:
        xc = F.pad(x.float().transpose(1, 2), (pad // 2, pad - pad // 2))
        with full_f32_conv(xc):
            y = F.conv1d(xc, w.permute(2, 1, 0),
                         dilation=dilation).transpose(1, 2)
    return (y + p["b"].float()).to(dtype)


def init_speaker_encoder(dims: SpeakerDims,
                         generator: torch.Generator | None = None,
                         device: str | torch.device = "cpu") -> Params:
    """Encoder weights (f32) on ``device`` drawn from ``generator``
    (default: seed 0)."""
    gen = generator or torch.Generator().manual_seed(0)
    blocks, c_in = [], dims.n_mels
    for _ in range(dims.n_blocks):
        blocks.append({"conv": _conv_init(gen, dims.kernel, c_in,
                                          dims.channels),
                       "ln": _ln_init(dims.channels)})
        c_in = dims.channels
    tree = {"blocks": blocks,
            "attn": _linear_init(gen, dims.channels, 1),
            "proj": _linear_init(gen, dims.channels * 2, dims.emb_dim)}
    return _to(tree, torch.device(device))


def speaker_embed(params: Params, dims: SpeakerDims, mel: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Log-mel windows (B, n_mels, T) → L2-normalized embeddings
    (B, emb_dim) f32."""
    with full_f32_matmul():
        x = mel.transpose(1, 2)  # (B, T, n_mels)
        for i, blk in enumerate(params["blocks"]):
            h = _conv1d(blk["conv"], x, dilation=2 ** i, dtype=dtype)
            h = torch.relu(layer_norm(blk["ln"], h))
            x = h if x.shape[-1] != h.shape[-1] else x + h
        # attentive statistics pooling
        a = torch.softmax(linear(params["attn"], x, dtype).float(), dim=1)
        xf = x.float()
        mu = torch.sum(a * xf, dim=1)
        var = torch.sum(a * (xf - mu[:, None, :]) ** 2, dim=1)
        stats = torch.cat([mu, torch.sqrt(var + 1e-6)], dim=-1)
        emb = linear(params["proj"], stats.to(dtype), dtype).float()
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-9)


# -- trained-asset resolution ---------------------------------------------

def speaker_dims_from_params(params: Params) -> SpeakerDims:
    """:class:`SpeakerDims` from a TDNN or ECAPA tree's shapes (tensors
    or arrays)."""
    if is_ecapa_params(params):
        k, n_mels, channels = params["frontend"]["conv"]["w"].shape
        return SpeakerDims(int(n_mels), int(channels),
                           len(params["layers"]), ecapa_emb_dim(params),
                           int(k))
    blocks = params["blocks"]
    k, n_mels, channels = blocks[0]["conv"]["w"].shape
    return SpeakerDims(int(n_mels), int(channels), len(blocks),
                       int(params["proj"]["w"].shape[1]), int(k))


def load_speaker_asset() -> tuple[SpeakerDims, dict] | None:
    """The committed trained encoder (``speaker_small.npz``) as
    (dims, numpy tree with ``blocks`` a list), or None when absent."""
    tree = load_npz_asset(ASSETS_DIR / "speaker_small.npz")
    if tree is None:
        return None
    blocks = tree["blocks"]
    if isinstance(blocks, dict):
        tree = dict(tree)
        tree["blocks"] = [blocks[k] for k in sorted(blocks, key=int)]
    return speaker_dims_from_params(tree), tree


def resolve_speaker_params(checkpoint_path: str | None, dims: SpeakerDims,
                           allow_asset: bool = True,
                           device: str | torch.device = "cpu",
                           ) -> tuple[SpeakerDims, Params, str]:
    """Encoder weights by precedence: a converted checkpoint
    (``{checkpoint_path}/speaker.safetensors``; a missing one warns and
    falls through), the committed asset, else a seeded init. Returns
    (dims, params on ``device``, source); the dims follow the weights, not
    the preset. ``allow_asset=False`` (the "test" preset) keeps the seeded
    tiny encoder."""
    from audio_rag_tpu_torch.weights import ecapa_params, speaker_params

    if checkpoint_path:
        tree = restore_params(checkpoint_path, "speaker")
        if tree is not None:
            dims = speaker_dims_from_params(tree)
            params = (ecapa_params(tree, device) if is_ecapa_params(tree)
                      else speaker_params(tree, dims, device))
            return dims, params, "checkpoint"
        log.warning("speaker checkpoint missing at %s; falling back",
                    checkpoint_path)
    if allow_asset:
        asset = load_speaker_asset()
        if asset is not None:
            return (asset[0], speaker_params(asset[1], asset[0], device),
                    "asset")
    return dims, init_speaker_encoder(dims, device=device), "random"


# -- VAD -------------------------------------------------------------------

def init_vad(n_mels: int = 80, channels: int = 64,
             generator: torch.Generator | None = None,
             device: str | torch.device = "cpu") -> Params:
    """VAD weights (f32) on ``device`` drawn from ``generator`` (default:
    seed 0)."""
    gen = generator or torch.Generator().manual_seed(0)
    tree = {"c1": _conv_init(gen, 5, n_mels, channels),
            "ln1": _ln_init(channels),
            "c2": _conv_init(gen, 5, channels, channels),
            "ln2": _ln_init(channels),
            "out": _linear_init(gen, channels, 1)}
    return _to(tree, torch.device(device))


def vad_scores(params: Params, mel: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Log-mel (B, n_mels, T) → per-frame speech probability (B, T) f32."""
    with full_f32_matmul():
        x = mel.transpose(1, 2)
        x = torch.relu(layer_norm(params["ln1"],
                                  _conv1d(params["c1"], x, 1, dtype)))
        x = torch.relu(layer_norm(params["ln2"],
                                  _conv1d(params["c2"], x, 2, dtype)))
        return torch.sigmoid(linear(params["out"], x, dtype)[..., 0].float())
