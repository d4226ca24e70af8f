"""ECAPA-TDNN speaker encoder on tensors with params in dicts: the
converted-checkpoint path of the diarizers.

Counterpart of ``audio_rag_tpu/models/ecapa.py``: the ECAPA-TDNN of the
speechbrain ``spkrec-ecapa-voxceleb`` release (Desplanques et al. 2020),
in inference mode, over the speechbrain filterbank front end. A deployment
converts the release (``python -m audio_rag_tpu_torch.convert speaker
<ckpt_dir> out/``) and sets ``diarization.checkpoint_path: out/``.

* Front end (:func:`ecapa_fbank`): symmetric Hamming window, power STFT
  as two f32 products with cosine and sine tables, triangular HTK mel
  filters of unit peak, dB (amin 1e-10, floored 80 dB below the
  utterance's maximum), the utterance's mean subtracted.
* TDNN block: Conv1d with reflect "same" padding ((k − 1)·d / 2 each
  side) → ReLU → the eval-mode BatchNorm folded to an affine at convert
  time.
* Three SE-Res2Net blocks (dilations 2, 3, 4), the concat of their
  outputs through a 1×1 TDNN, attentive statistics pooling with global
  context (tanh attention, std clamped at 1e-12), the BatchNorm affine and
  a 1×1 projection to an L2-normalized embedding.

Rounding follows the JAX module's dtype flow (products summed in f32 and
rounded to ``dtype`` where JAX rounds them); the diarizers run it in f32,
where convolutions run in full f32 on the card (cuDNN without TF32) and
matmuls at full f32 precision. No TPU kernel lies on this path.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.device import full_f32_conv, full_f32_matmul
from audio_rag_tpu_torch.models.layers import Params, mm_f32, mm_out_f32

__all__ = ["is_ecapa_params", "ecapa_emb_dim", "ecapa_fbank", "ecapa_embed",
           "init_ecapa"]


def is_ecapa_params(params: Any) -> bool:
    return isinstance(params, dict) and "layers" in params and "fc" in params


def ecapa_emb_dim(params: Params) -> int:
    return int(params["fc"]["w"].shape[-1])


# -- feature frontend ------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _htk_mel_filters(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular HTK-scale mel filters of unit peak (speechbrain's
    ``Filterbank``; Whisper's mel bank is slaney-normalized instead)."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    pts = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2), n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        fb[:, i] = np.clip(np.minimum(up, down), 0.0, None)
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_tables(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    angle = (2.0 * np.pi * np.outer(np.arange(n_fft),
                                    np.arange(n_fft // 2 + 1)) / n_fft)
    return np.cos(angle).astype(np.float32), np.sin(angle).astype(np.float32)


def ecapa_fbank(wav: torch.Tensor, n_mels: int = 80, n_fft: int = 400,
                hop: int = 160, sr: int = 16_000) -> torch.Tensor:
    """(..., n_samples) f32 → (..., T, n_mels) log filterbanks, each
    utterance mean-normalized (speechbrain's ``Fbank`` +
    ``InputNormalization(norm_type="sentence")``)."""
    dev = wav.device
    window = torch.hamming_window(n_fft, periodic=False,
                                  dtype=torch.float64).float().to(dev)
    cos_b, sin_b = (torch.from_numpy(t).to(dev) for t in _dft_tables(n_fft))
    fb = torch.from_numpy(_htk_mel_filters(n_mels, n_fft, sr)).to(dev)
    frames = wav.float().unfold(-1, n_fft, hop) * window  # (..., T, n_fft)
    with full_f32_matmul():
        power = (frames @ cos_b) ** 2 + (frames @ sin_b) ** 2
        mel = power @ fb
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    peak = torch.amax(db, dim=(-2, -1), keepdim=True)
    db = torch.maximum(db, peak - 80.0)
    return db - db.mean(dim=-2, keepdim=True)


# -- encoder ---------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an f32 result: exact products summed in f32."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return mm_out_f32(x, w)
    return mm_f32(x, w)


def _conv_reflect(p: Params, x: torch.Tensor, dilation: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Dilated Conv1d with reflect "same" padding (speechbrain's
    ``Conv1d``, ``padding_mode='reflect'``): x (B, T, C_in) →
    (B, T, C_out) f32, the bias added in f32."""
    k, c_in, _ = p["w"].shape
    pad = (k - 1) * dilation // 2
    xt = x.transpose(1, 2)
    if pad:
        xt = F.pad(xt, (pad, pad), mode="reflect")
    w = p["w"].to(dtype)
    if dtype == torch.float32:
        xt = xt.float()
        with full_f32_conv(xt):
            y = F.conv1d(xt, w.permute(2, 1, 0),
                         dilation=dilation).transpose(1, 2)
    else:
        # im2col, tap-major as w's rows: one product with an f32 result
        xp = xt.to(dtype).transpose(1, 2)
        T = x.shape[1]
        cols = torch.cat([xp[:, j * dilation: j * dilation + T]
                          for j in range(k)], dim=-1)
        y = _mm(cols, w.reshape(k * c_in, -1))
    return y + p["b"].float()


def _tdnn(p: Params, x: torch.Tensor, dilation: int,
          dtype: torch.dtype) -> torch.Tensor:
    """Conv → ReLU → BN affine (eval-mode BN folded at convert time)."""
    y = torch.relu(_conv_reflect(p["conv"], x, dilation, dtype))
    return (y * p["bn"]["s"].float() + p["bn"]["o"].float()).to(dtype)


def _res2net(blocks: list, x: torch.Tensor, dilation: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Hierarchical multi-scale convolutions over channel chunks."""
    chunks = torch.chunk(x, len(blocks) + 1, dim=-1)
    ys, y = [chunks[0]], None
    for i in range(1, len(chunks)):
        inp = chunks[i] if i == 1 else chunks[i] + y
        y = _tdnn(blocks[i - 1], inp, dilation, dtype)
        ys.append(y)
    return torch.cat(ys, dim=-1)


def _se(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Squeeze-excitation gate over the time mean."""
    s = x.float().mean(dim=1, keepdim=True).to(dtype)  # (B, 1, C)
    h = torch.relu(_mm(s, p["c1"]["w"].to(dtype)).to(dtype).float()
                   + p["c1"]["b"].float())
    g = torch.sigmoid(mm_f32(h, p["c2"]["w"].to(dtype))
                      + p["c2"]["b"].float())
    return (x.float() * g).to(dtype)


def _stats(x: torch.Tensor, w: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean and std over time, the variance clamped at 1e-12
    (speechbrain's ``_compute_statistics``)."""
    mean = torch.sum(w * x, dim=1)
    var = torch.sum(w * (x - mean[:, None, :]) ** 2, dim=1)
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


@torch.inference_mode()
def ecapa_embed(params: Params, fbank: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Filterbanks (B, T, n_mels) from :func:`ecapa_fbank` →
    L2-normalized speaker embeddings (B, emb) f32."""
    with full_f32_matmul():
        x = _tdnn(params["frontend"], fbank, 1, dtype)
        outs = []
        for i, layer in enumerate(params["layers"]):
            dilation = 2 + i  # the published schedule: 2, 3, 4
            res = x
            if "shortcut" in layer:
                res = _conv_reflect(layer["shortcut"], x, 1, dtype)
            h = _tdnn(layer["tdnn1"], x, 1, dtype)
            h = _res2net(layer["res2net"], h, dilation, dtype)
            h = _tdnn(layer["tdnn2"], h, 1, dtype)
            h = _se(layer["se"], h, dtype)
            x = (h.float() + res.float()).to(dtype)
            outs.append(x)
        x = _tdnn(params["mfa"], torch.cat(outs, dim=-1), 1, dtype)

        # attentive statistics pooling with global context
        xf = x.float()
        t = x.shape[1]
        uniform = torch.full((1, t, 1), 1.0 / t, device=x.device)
        g_mean, g_std = _stats(xf, uniform)
        ctx = torch.cat([x, g_mean[:, None, :].expand_as(xf).to(dtype),
                         g_std[:, None, :].expand_as(xf).to(dtype)], dim=-1)
        a = _tdnn(params["asp"]["tdnn"], ctx, 1, dtype)
        a = torch.tanh(a.float()).to(dtype)
        a = (_mm(a, params["asp"]["conv"]["w"].to(dtype)).to(dtype).float()
             + params["asp"]["conv"]["b"].float())
        w = torch.softmax(a, dim=1)
        mean, std = _stats(xf, w)
        pooled = (torch.cat([mean, std], dim=-1)
                  * params["asp_bn"]["s"].float()
                  + params["asp_bn"]["o"].float())
        emb = (_mm(pooled.to(dtype), params["fc"]["w"].to(dtype)).to(dtype)
               .float() + params["fc"]["b"].float())
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-9)


# -- seeded init (tests, widths probing) -------------------------------------

def init_ecapa(generator: torch.Generator | None = None, n_mels: int = 80,
               channels: int = 64, mfa_channels: int = 192,
               attn_channels: int = 32, se_channels: int = 16,
               emb_dim: int = 24, scale: int = 4, kernel: int = 3,
               device: str | torch.device = "cpu") -> Params:
    """A seeded ECAPA tree (f32) on ``generator``'s device (default: seed
    0 on the CPU), in the JAX ``init_ecapa``'s layout and distributions;
    tiny widths by default (the voxceleb release: channels 1024, mfa 3072,
    attention 128, SE 128, embedding 192, scale 8)."""
    gen = generator or torch.Generator().manual_seed(0)
    dev = torch.device(device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dev)

    def conv(k, c_in, c_out):
        return {"w": normal(k, c_in, c_out) * (k * c_in) ** -0.5,
                "b": torch.zeros((c_out,), device=dev)}

    def bn(c):
        return {"s": 1.0 + 0.1 * normal(c), "o": 0.1 * normal(c)}

    def tdnn(k, c_in, c_out):
        return {"conv": conv(k, c_in, c_out), "bn": bn(c_out)}

    def lin(c_in, c_out):
        return {"w": normal(c_in, c_out) * c_in ** -0.5,
                "b": torch.zeros((c_out,), device=dev)}

    width = channels // scale
    layers = [{"tdnn1": tdnn(1, channels, channels),
               "res2net": [tdnn(kernel, width, width)
                           for _ in range(scale - 1)],
               "tdnn2": tdnn(1, channels, channels),
               "se": {"c1": lin(channels, se_channels),
                      "c2": lin(se_channels, channels)}}
              for _ in range(3)]
    return {"frontend": tdnn(5, n_mels, channels),
            "layers": layers,
            "mfa": tdnn(1, 3 * channels, mfa_channels),
            "asp": {"tdnn": tdnn(1, 3 * mfa_channels, attn_channels),
                    "conv": lin(attn_channels, mfa_channels)},
            "asp_bn": bn(2 * mfa_channels),
            "fc": lin(2 * mfa_channels, emb_dim)}
