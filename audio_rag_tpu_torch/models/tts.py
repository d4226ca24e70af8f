"""FastSpeech-class text-to-speech acoustic model and Griffin-Lim vocoder
(counterpart of ``audio_rag_tpu/models/tts.py``).

* character embedding + sinusoid positions → pre-LN transformer encoder;
* duration predictor (MLP head over encoder states → log frame counts);
* length regulator: a gather from frames to symbols at a static
  ``max_frames`` (frames past the total duration are zeroed and masked);
* pre-LN transformer decoder over frames → linear mel head + a residual
  frame-local refiner;
* vocoder: the invertible log-mel back to mel power, the mel filterbank's
  pseudo-inverse to linear power, and Griffin-Lim phase recovery (32
  iterations from zero phase).

Attention here is masked (keys past a row's length), so it takes the
plain product-softmax-product, on no kernel, as in the JAX package. In a
compute dtype narrower than f32 the model rounds where the JAX package's
compiled CPU program rounds, by the rules :mod:`audio_rag_tpu_torch.models.
bert` sets out (each linear's output after its bias, each LayerNorm's
output, the softmax probabilities, the attention output and GELU's erfc
and product, the position sums and each block's output); the sum after a
block's attention reaches the MLP's norm in f32 and goes on rounded.

The STFT pair runs on ``torch.fft`` (cuFFT on the card) and the inverse
adds overlapping frames with ``F.fold``, which sums each output sample's
frames in a fixed order, so the same input gives the same bits on the card
(a scatter-add would add in atomic order).

Mel convention: :mod:`audio_rag_tpu_torch.ops.mel`'s (16 kHz, n_fft 400,
hop 160, Slaney filterbank, ``(log10 mel + 4) / 4`` without the global
clamp).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.models.bert import (
    _attention,
    _gelu,
    _layer_norm,
    _residual,
)
from audio_rag_tpu_torch.models.layers import (
    Params,
    linear,
    mm_f32,
    normal_init,
    sinusoid_positions,
    take_layer,
)
from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, N_FFT, mel_filterbank

__all__ = [
    "TTSDims",
    "TTS_PRESETS",
    "SYMBOLS",
    "PAD_ID",
    "HOP_LENGTH",
    "text_to_ids",
    "init_tts",
    "apply_tts",
    "predict_durations",
    "length_regulate",
    "mel_to_audio",
    "griffin_lim",
]


#: pad, lowercase letters, digits, space and punctuation (graphemes)
SYMBOLS: str = "_abcdefghijklmnopqrstuvwxyz0123456789 .,!?'-:;\""
PAD_ID: int = 0
_SYM_TO_ID = {c: i for i, c in enumerate(SYMBOLS)}


def text_to_ids(text: str, max_len: int) -> np.ndarray:
    """Lowercase, map to symbol ids (unknown characters → space), pad or
    truncate to ``max_len`` (int32)."""
    ids = [_SYM_TO_ID.get(c, _SYM_TO_ID[" "]) for c in text.lower()[:max_len]]
    out = np.full((max_len,), PAD_ID, np.int32)
    out[: len(ids)] = ids
    return out


@dataclasses.dataclass(frozen=True)
class TTSDims:
    n_vocab: int
    d_model: int
    n_heads: int
    n_enc_layer: int
    n_dec_layer: int
    n_mels: int
    max_text: int      # symbol-position table size (texts bucket below this)
    max_frames: int    # frame-position table size (static mel length cap)
    max_dur: int = 32  # per-symbol duration clip (frames)


TTS_PRESETS: dict[str, TTSDims] = {
    # the committed trained asset's shape (~1.6 M parameters)
    "small": TTSDims(64, 128, 4, 2, 2, 80, 256, 2048),
    # tiny shapes for tests
    "test": TTSDims(64, 32, 2, 1, 1, 16, 16, 64, max_dur=8),
}


def init_tts(dims: TTSDims, seed: int = 0,
             device: str | torch.device = "cpu") -> Params:
    """Seeded random parameters in the JAX package's layout and
    distributions (normal·d_in^-½ linears with zero biases, the attention's
    k without one, normal·0.02 embeddings, the refiner's output at 1e-3);
    blocks stacked on a leading L axis. f32."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = dims.d_model

    def lin(din, dout, lead=(), bias=True, scale=None):
        p = {"w": normal_init(gen, (*lead, din, dout),
                              din ** -0.5 if scale is None else scale,
                              torch.float32)}
        if bias:
            p["b"] = torch.zeros((*lead, dout), device=device)
        return p

    def ln(dim, lead=()):
        return {"g": torch.ones((*lead, dim), device=device),
                "b": torch.zeros((*lead, dim), device=device)}

    def blocks(L):
        return {"ln1": ln(d, (L,)),
                "attn": {"q": lin(d, d, (L,)), "k": lin(d, d, (L,), False),
                         "v": lin(d, d, (L,)), "o": lin(d, d, (L,))},
                "ln_mlp": ln(d, (L,)),
                "mlp": {"up": lin(d, 4 * d, (L,)),
                        "down": lin(4 * d, d, (L,))}}

    return {
        "emb": {"table": normal_init(gen, (dims.n_vocab, d), 0.02,
                                     torch.float32)},
        "enc_blocks": blocks(dims.n_enc_layer),
        "enc_ln": ln(d),
        "dur": {"h": lin(d, d // 2), "ln": ln(d // 2), "out": lin(d // 2, 1)},
        "dec_blocks": blocks(dims.n_dec_layer),
        "dec_ln": ln(d),
        "mel_head": lin(d, dims.n_mels),
        "refine": {"h": lin(dims.n_mels, d), "ln": ln(d),
                   "out": lin(d, dims.n_mels, scale=1e-3)},
    }


def _run_blocks(blocks: Params, n_layers: int, x: torch.Tensor,
                n_heads: int, mask: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Pre-LN blocks over ``x`` in ``dtype``, as the JAX package's scan
    carries it: a block reads its input rounded, but the sum after its
    attention reaches the MLP's norm unrounded while the residual stream
    carries it rounded (XLA keeps a sum in f32 up to the norm that reads
    it, within one scan step)."""
    for i in range(n_layers):
        p = take_layer(blocks, i)
        h = _attention(p["attn"], _layer_norm(p["ln1"], x.float(), dtype),
                       n_heads, mask, dtype)
        s = _residual(x, h)
        u = linear(p["mlp"]["up"], _layer_norm(p["ln_mlp"], s, dtype), dtype)
        h = linear(p["mlp"]["down"], _gelu(u, dtype), dtype)
        x = _residual(s.to(dtype), h).to(dtype)
    return x


def _positions(length: int, d: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    return sinusoid_positions(length, d).to(device).to(dtype)


def _encode_text(params: Params, dims: TTSDims, tokens: torch.Tensor,
                 dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (encoder states (B, S, d) in ``dtype``,
    log-durations (B, S) f32)."""
    S = tokens.shape[1]
    valid = tokens != PAD_ID
    x = (params["emb"]["table"].to(dtype)[tokens]
         + _positions(dims.max_text, dims.d_model, dtype, tokens.device)[:S])
    mask = valid[:, None, None, :]  # keys only
    x = _run_blocks(params["enc_blocks"], dims.n_enc_layer, x, dims.n_heads,
                    mask, dtype)
    x = (_layer_norm(params["enc_ln"], x.float(), dtype)
         * valid[:, :, None].to(dtype))
    h = torch.relu(linear(params["dur"]["h"], x, dtype))
    h = _layer_norm(params["dur"]["ln"], h.float(), dtype)
    log_dur = linear(params["dur"]["out"], h, dtype)[..., 0].float()
    return x, log_dur


def predict_durations(dims: TTSDims, log_dur: torch.Tensor,
                      tokens: torch.Tensor, speed: float = 1.0
                      ) -> torch.Tensor:
    """Log-durations → integer frame counts (B, S), rounded half to even
    and clipped to [1, ``max_dur``]; pads get 0. ``speed`` > 1 shortens."""
    dur = torch.exp(log_dur)
    if speed != 1.0:
        dur = dur / speed
    dur = torch.clamp(torch.round(dur).to(torch.int32), 1, dims.max_dur)
    return torch.where(tokens != PAD_ID, dur, torch.zeros_like(dur))


def length_regulate(enc: torch.Tensor, durations: torch.Tensor,
                    max_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
    """enc (B, S, d), durations (B, S) → (frames (B, F, d), frame_valid
    (B, F) bool), F = ``max_frames``: frame f takes the first symbol whose
    cumulative duration exceeds f; frames at or past the total are zeroed
    and invalid."""
    ends = torch.cumsum(durations.long(), dim=1)  # (B, S)
    f = torch.arange(max_frames, device=enc.device)
    sym_idx = (f[None, :, None] >= ends[:, None, :]).sum(2)  # (B, F)
    frame_valid = f[None, :] < ends[:, -1:]
    sym_idx = torch.clamp(sym_idx, max=enc.shape[1] - 1)
    frames = torch.gather(enc, 1, sym_idx[:, :, None].expand(
        -1, -1, enc.shape[2]))
    return frames * frame_valid[:, :, None].to(enc.dtype), frame_valid


@torch.inference_mode()
def apply_tts(params: Params, dims: TTSDims, tokens: torch.Tensor,
              durations: torch.Tensor | None = None,
              dtype: torch.dtype = torch.bfloat16, speed: float = 1.0
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, S) int, 0-padded → (mel (B, F, n_mels) f32 in the
    invertible log-mel scale, frame_valid (B, F) bool, log_dur (B, S) f32).
    ``durations`` (teacher forcing) replace the predicted ones."""
    tokens = tokens.long()
    enc, log_dur = _encode_text(params, dims, tokens, dtype)
    if durations is None:
        durations = predict_durations(dims, log_dur, tokens, speed)
    frames, frame_valid = length_regulate(enc, durations, dims.max_frames)
    x = frames + _positions(dims.max_frames, dims.d_model, dtype,
                            tokens.device)
    x = _run_blocks(params["dec_blocks"], dims.n_dec_layer, x, dims.n_heads,
                    frame_valid[:, None, None, :], dtype)
    x = _layer_norm(params["dec_ln"], x.float(), dtype)
    mel = linear(params["mel_head"], x, dtype).float()
    h = torch.relu(linear(params["refine"]["h"], mel, dtype))
    h = _layer_norm(params["refine"]["ln"], h.float(), dtype)
    mel = mel + linear(params["refine"]["out"], h, dtype).float()
    return mel * frame_valid[:, :, None], frame_valid, log_dur


# -- vocoder -----------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _mel_pinv(n_mels: int) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of the mel filterbank (n_bins, n_mels)."""
    return np.linalg.pinv(mel_filterbank(n_mels)).astype(np.float32)


def _hann(device: torch.device) -> torch.Tensor:
    n = np.arange(N_FFT)
    return torch.from_numpy(
        (0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))).astype(np.float32)
    ).to(device)


def _stft(audio: torch.Tensor, window: torch.Tensor,
          n_frames: int) -> torch.Tensor:
    """(B, T) → complex (B, n_frames, n_fft//2+1); centre-padded, hop 160."""
    padded = F.pad(audio, (N_FFT // 2, N_FFT // 2))
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    return torch.fft.rfft(frames * window, dim=-1)


def _overlap_add(frames: torch.Tensor) -> torch.Tensor:
    """(B, n_frames, n_fft) → (B, (n_frames − 1)·hop + n_fft): frame f
    added at f·hop, each sample's frames summed in order."""
    n_frames = frames.shape[1]
    total = (n_frames - 1) * HOP_LENGTH + N_FFT
    return F.fold(frames.transpose(1, 2), (1, total), (1, N_FFT),
                  stride=(1, HOP_LENGTH))[:, 0, 0]


def _istft(spec: torch.Tensor, window: torch.Tensor, n_samples: int,
           den: torch.Tensor) -> torch.Tensor:
    """complex (B, n_frames, n_bins) → (B, n_samples) by overlap-add over
    ``den`` (the summed squared windows), the centre padding cut off."""
    frames = torch.fft.irfft(spec, n=N_FFT, dim=-1) * window
    audio = _overlap_add(frames) / den
    return audio[:, N_FFT // 2: N_FFT // 2 + n_samples]


def griffin_lim(magnitude: torch.Tensor, n_iter: int = 32) -> torch.Tensor:
    """Phase recovery: |S| (B, n_frames, n_bins) f32 → audio
    (B, n_frames·hop): alternate ISTFT/STFT projections keeping the target
    magnitude, from zero phase."""
    B, n_frames, _ = magnitude.shape
    n_samples = n_frames * HOP_LENGTH
    window = _hann(magnitude.device)
    den = torch.clamp(_overlap_add(
        (window * window).expand(1, n_frames, N_FFT)), min=1e-8)
    spec = magnitude.to(torch.complex64)
    for _ in range(n_iter):
        est = _stft(_istft(spec, window, n_samples, den), window, n_frames)
        spec = magnitude * (est / torch.clamp(est.abs(), min=1e-8))
    return _istft(spec, window, n_samples, den)


@torch.inference_mode()
def mel_to_audio(mel: torch.Tensor, n_iter: int = 32) -> torch.Tensor:
    """Invertible log-mel (B, F, n_mels) (or (F, n_mels)) → waveforms
    (B, F·hop) f32, each row's peak scaled to 0.9: mel power
    ``10^(4·mel − 4)``, the filterbank's pseudo-inverse to linear power,
    Griffin-Lim for the phase."""
    squeeze = mel.dim() == 2
    if squeeze:
        mel = mel[None]
    mel_power = torch.pow(10.0, 4.0 * mel.float() - 4.0)
    pinv = torch.from_numpy(_mel_pinv(mel.shape[-1])).to(mel.device)
    power = torch.clamp(mm_f32(mel_power, pinv.T), min=0.0)
    audio = griffin_lim(torch.sqrt(power), n_iter=n_iter)
    peak = audio.abs().amax(dim=1, keepdim=True)
    audio = audio / torch.clamp(peak, min=1e-6) * 0.9
    return audio[0] if squeeze else audio
