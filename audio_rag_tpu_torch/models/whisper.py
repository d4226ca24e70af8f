"""Whisper encoder/decoder on tensors with params in dicts: greedy,
speculative greedy and beam decoding.

Counterpart of ``audio_rag_tpu/models/whisper.py``: the same param tree
(per-layer blocks stacked on a leading L axis), the same presets, special
tokens and char codec, and the same functions: :func:`encode`,
:func:`precompute_cross_kv` (bf16/f32, int8 and int4),
:func:`decoder_forward` (teacher-forced priming, and the word-alignment
pass with the head-averaged cross weights of the upper layers),
:func:`_cross_with_kv`, :func:`quantize_decoder_weights` (8 or 4 bits, or
int8 blocks with an int4 logits head), :func:`quantize_self_cache`,
:func:`decoder_step` (greedy, beams in the physical or lazy-ancestry
layout, or the int8 self cache), :func:`greedy_decode` (argmax, or at a
temperature sampled with JAX's PRNG, :mod:`audio_rag_tpu_torch.ops.random`),
:func:`detect_language`, :func:`ngram_draft`, :func:`decoder_block_verify`,
:func:`speculative_greedy_decode` and :func:`beam_decode`, whose loop body
is :func:`beam_step`. ``lax.scan`` and ``while_loop`` become Python loops;
KV caches are updated in place.

Kernel routes on CUDA (plain versions on the CPU, see ``ops/kernels.py``):
the encoder's self-attention goes to ``flash_attention``; with int8 or
int4 cross K/V the decode loops' cross-attention (≤ 8 queries per row:
one token, K beams or a k-token verify block) goes to
``decode_cross_attention_q8`` or ``_q4``; with
``quantize_decoder_weights`` the decode loops' weight matmuls go to
``matmul_q8w`` or ``matmul_q4w``; with the int8 self cache the greedy
loop's self-attention goes to ``decode_self_attention_q8``; beam search's
``reorder="kernel"`` reorders the self caches with ``beam_reorder_kv``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.device import full_f32_conv, full_f32_matmul
from audio_rag_tpu_torch.models.layers import (
    _INV7,
    _INV127,
    Params,
    gelu,
    layer_norm,
    linear,
    linear_q8,
    make_causal_mask,
    mha,
    mlp,
    mm_f32,
    mm_out_f32,
    quant_bytes,
    quantize_linear,
    quantize_linear_q4,
    sinusoid_positions,
    take_layer,
)
from audio_rag_tpu_torch.ops import kernels
from audio_rag_tpu_torch.ops import random as jrandom

__all__ = [
    "WhisperDims",
    "WHISPER_PRESETS",
    "SpecialTokens",
    "CHAR_SYMBOLS",
    "char_encode",
    "char_decode",
    "WHISPER_LANGUAGES",
    "language_offset",
    "init_whisper",
    "encode",
    "cross_kv_layer",
    "precompute_cross_kv",
    "decoder_forward",
    "quantize_decoder_weights",
    "q8_param_bytes",
    "pack_self_scales",
    "quantize_self_cache",
    "decoder_step",
    "prime_decode",
    "greedy_decode",
    "ngram_draft",
    "decoder_block_verify",
    "speculative_greedy_decode",
    "BEAM_REORDERS",
    "BeamState",
    "beam_start",
    "beam_step",
    "beam_best",
    "beam_decode",
    "detect_language",
]


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int


WHISPER_PRESETS: dict[str, WhisperDims] = {
    "tiny": WhisperDims(80, 1500, 384, 6, 4, 51865, 448, 384, 6, 4),
    "base": WhisperDims(80, 1500, 512, 8, 6, 51865, 448, 512, 8, 6),
    "small": WhisperDims(80, 1500, 768, 12, 12, 51865, 448, 768, 12, 12),
    "medium": WhisperDims(80, 1500, 1024, 16, 24, 51865, 448, 1024, 16, 24),
    "large-v2": WhisperDims(80, 1500, 1280, 20, 32, 51865, 448, 1280, 20, 32),
    "large-v3": WhisperDims(128, 1500, 1280, 20, 32, 51866, 448, 1280, 20, 32),
    "test": WhisperDims(80, 60, 64, 2, 2, 1024, 32, 64, 2, 2),
    # the test shapes with the multilingual v2 vocabulary (language
    # detection and per-row language tokens at test size)
    "test-ml": WhisperDims(80, 60, 64, 2, 2, 51865, 32, 64, 2, 2),
    # the committed trained tiny ASR: 6 s windows, char-level vocab
    "tiny-synth": WhisperDims(128, 300, 128, 4, 3, 64, 128, 128, 4, 3),
}

#: char-level codec of "tiny-synth": token id == index into this table (a
#: copy of the TTS symbol table ``audio_rag_tpu/models/tts.py::SYMBOLS``)
CHAR_SYMBOLS: str = "_abcdefghijklmnopqrstuvwxyz0123456789 .,!?'-:;\""


def char_encode(text: str) -> list[int]:
    """Lowercased text → tiny-synth token ids (unknown chars → space)."""
    space = CHAR_SYMBOLS.index(" ")
    return [
        CHAR_SYMBOLS.index(c) if c in CHAR_SYMBOLS and c != "_" else space
        for c in text.lower()
    ]


def char_decode(ids) -> str:
    """tiny-synth token ids → text (pad/unknown ids drop)."""
    return "".join(
        CHAR_SYMBOLS[int(i)] for i in ids if 0 < int(i) < len(CHAR_SYMBOLS)
    )


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Multilingual Whisper special-token ids (v2 vocab; large-v3 +1 past sot)."""

    eot: int = 50257
    sot: int = 50258
    lang_base: int = 50259
    translate: int = 50358
    transcribe: int = 50359
    sot_prev: int = 50361
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_base: int = 50364

    @classmethod
    def for_dims(cls, dims: WhisperDims) -> "SpecialTokens":
        if dims.n_vocab == 51866:  # large-v3 adds <|yue|>
            return cls(
                eot=50257, sot=50258, lang_base=50259, translate=50359,
                transcribe=50360, sot_prev=50362, no_speech=50363,
                no_timestamps=50364, timestamp_base=50365,
            )
        if dims.n_vocab < 51865:  # small vocabs: specials at the top
            v = dims.n_vocab
            return cls(
                eot=v - 9, sot=v - 8, lang_base=v - 7, translate=v - 6,
                transcribe=v - 5, sot_prev=v - 4, no_speech=v - 3,
                no_timestamps=v - 2, timestamp_base=v - 1,
            )
        return cls()


#: Whisper's language-token order (token id = lang_base + index)
WHISPER_LANGUAGES: tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
    "yue",
)


def language_offset(code: str) -> int:
    """Language code → offset from ``lang_base`` (e.g. "en" → 0)."""
    try:
        return WHISPER_LANGUAGES.index(code.lower())
    except ValueError:
        raise ValueError(f"unknown whisper language code {code!r}") from None


# -- init ------------------------------------------------------------------

def init_whisper(dims: WhisperDims, seed: int = 0,
                 device: str | torch.device = "cpu",
                 dtype: torch.dtype = torch.float32) -> Params:
    """Seeded random parameters in the JAX package's tree layout and
    distributions (normal·d_in^-½ linears, zero biases, unit norms,
    normal·0.02 token table, normal·0.01 text positions, sinusoidal audio
    positions). The numbers differ from the JAX package's seeded init:
    PyTorch's and JAX's generators differ. ``dtype`` is the storage dtype."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, device=device)
        return (x * scale).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def lin(L, din, dout, bias=True):
        p = {"w": normal((L, din, dout), din ** -0.5)}
        if bias:
            p["b"] = zeros((L, dout))
        return p

    def ln(L, d):
        return {"g": ones((L, d)), "b": zeros((L, d))}

    def attn(L, d):
        return {"q": lin(L, d, d), "k": lin(L, d, d, bias=False),
                "v": lin(L, d, d), "o": lin(L, d, d)}

    def blocks(L, d, cross):
        p = {"ln1": ln(L, d), "attn": attn(L, d),
             "mlp": {"up": lin(L, d, 4 * d), "down": lin(L, 4 * d, d)},
             "ln_mlp": ln(L, d)}
        if cross:
            p["cross"] = attn(L, d)
            p["ln_cross"] = ln(L, d)
        return p

    d_a, d_t = dims.n_audio_state, dims.n_text_state
    scale = d_a ** -0.5
    return {
        "encoder": {
            "conv1": {"w": normal((3, dims.n_mels, d_a), scale),
                      "b": zeros((d_a,))},
            "conv2": {"w": normal((3, d_a, d_a), scale), "b": zeros((d_a,))},
            "pos": sinusoid_positions(dims.n_audio_ctx, d_a).to(device, dtype),
            "blocks": blocks(dims.n_audio_layer, d_a, cross=False),
            "ln_post": {"g": ones((d_a,)), "b": zeros((d_a,))},
        },
        "decoder": {
            "tok_emb": {"table": normal((dims.n_vocab, d_t), 0.02)},
            "pos_emb": normal((dims.n_text_ctx, d_t), 0.01),
            "blocks": blocks(dims.n_text_layer, d_t, cross=True),
            "ln": {"g": ones((d_t,)), "b": zeros((d_t,))},
        },
    }


# -- encoder ---------------------------------------------------------------

def _conv1d(p: Params, x: torch.Tensor, stride: int,
            dtype: torch.dtype) -> torch.Tensor:
    """x (B, T, C_in) → (B, T/stride, C_out): kernel 3 with XLA's "SAME"
    padding ((1, 1) at stride 1; (0, 1) at stride 2 on an even T), f32
    sums of exact products, the bias added in f32, one rounding."""
    B, T, c_in = x.shape
    out_len = -(-T // stride)
    pad = max((out_len - 1) * stride + 3 - T, 0)
    w = p["w"].to(dtype)  # (3, Cin, Cout)
    if x.is_cuda and dtype != torch.float32:
        # im2col: row (b, t) holds the three taps' input features, tap
        # major as w's rows; one product with an f32 output, so the sum is
        # rounded to bf16 once, after the bias
        xp = F.pad(x.to(dtype), (0, 0, pad // 2, pad - pad // 2))
        cols = xp.unfold(1, 3, stride).transpose(2, 3)  # (B, T', 3, Cin)
        y = mm_out_f32(cols.reshape(B, out_len, 3 * c_in),
                       w.reshape(3 * c_in, -1))
    else:
        xc = F.pad(x.to(dtype).transpose(1, 2), (pad // 2, pad - pad // 2))
        with full_f32_conv(xc):
            y = F.conv1d(xc.float(), w.float().permute(2, 1, 0),
                         stride=stride).transpose(1, 2)
    return (y + p["b"].float()).to(dtype)


def encode(params: Params, dims: WhisperDims, mel: torch.Tensor,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """mel (B, n_mels, 2·n_audio_ctx) → encoder states (B, n_audio_ctx, d)."""
    enc = params["encoder"]
    x = mel.transpose(1, 2)  # (B, T, n_mels)
    x = gelu(_conv1d(enc["conv1"], x, 1, dtype))
    x = gelu(_conv1d(enc["conv2"], x, 2, dtype))
    x = x + enc["pos"].to(dtype)
    for i in range(dims.n_audio_layer):
        p = take_layer(enc["blocks"], i)
        h, _ = mha(p["attn"], layer_norm(p["ln1"], x), dims.n_audio_head,
                   dtype=dtype)
        x = x + h
        x = x + mlp(p["mlp"], layer_norm(p["ln_mlp"], x), dtype)
    return layer_norm(enc["ln_post"], x)


# -- decoder ---------------------------------------------------------------

def _quant8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Ta, D) → int8 (B, H, D, Ta) transposed + per-(B, H) f32 scale
    (B, H, 1, 1), exactly the JAX package's rounding."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=(2, 3), keepdim=True)
    scale = torch.clamp(amax, min=1e-9) * _INV127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.transpose(2, 3).contiguous(), scale


def _quant4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, Ta, D) → int4 (B, H, D/2, Ta) nibble-packed along D in
    half-split order (byte row r: dim r in the low nibble, r + D/2 in the
    high one) + per-channel f32 scales (B, H, 1, D), exactly the JAX
    package's rounding and packing."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=2, keepdim=True)
    scale = torch.clamp(amax, min=1e-9) * _INV7
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int32)
    qt = q.transpose(2, 3)  # (B, H, D, Ta)
    half = qt.shape[2] // 2
    packed = (qt[:, :, :half] & 0x0F) | (qt[:, :, half:] << 4)
    return packed.to(torch.int8).contiguous(), scale


def _unpack_kv4(x4: torch.Tensor) -> torch.Tensor:
    """(…, D/2, Ta) half-split packed int4 → (…, D, Ta) int8 values (the
    teacher-forced path's inverse of :func:`_quant4`; the decode kernel
    unpacks in registers instead)."""
    return torch.cat(kernels.int4_nibbles(x4), dim=-2).to(torch.int8)


def cross_kv_layer(params: Params, dims: WhisperDims, enc: torch.Tensor,
                   i: int, dtype: torch.dtype = torch.bfloat16
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s cross K and V from encoder states, (B, H, Ta, D) each
    in ``dtype``."""
    head_dim = dims.n_text_state // dims.n_text_head
    B, Ta, _ = enc.shape
    cross = take_layer(params["decoder"]["blocks"]["cross"], i)
    k = linear(cross["k"], enc, dtype).reshape(
        B, Ta, dims.n_text_head, head_dim).transpose(1, 2)
    v = linear(cross["v"], enc, dtype).reshape(
        B, Ta, dims.n_text_head, head_dim).transpose(1, 2)
    return k, v


def precompute_cross_kv(params: Params, dims: WhisperDims, enc: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16,
                        quantize: bool = False, bits: int = 8):
    """Per-layer cross K/V from encoder states.

    ``quantize=False``: (k, v), each (L, B, H, Ta, D) in ``dtype``.
    ``quantize=True, bits=8``: (k8, v8, k_scale, v_scale) with int8 K/V
    TRANSPOSED to (L, B, H, D, Ta) and per-(L, B, H) f32 scales
    (L, B, H, 1, 1). ``bits=4``: int4 K/V nibble-packed along D to
    (L, B, H, D/2, Ta) int8 with per-channel scales (L, B, H, 1, D). These
    are the layouts the decode cross kernels read; K/V are quantized layer
    by layer so the f32 temporaries never exist for all layers at once.
    """
    if quantize and bits not in (8, 4):
        raise ValueError(f"cross-KV bits must be 8 or 4, got {bits}")
    quant = _quant8 if bits == 8 else _quant4
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        k, v = cross_kv_layer(params, dims, enc, i, dtype)
        if quantize:
            k, v = quant(k), quant(v)
        ks.append(k)
        vs.append(v)
    if not quantize:
        return torch.stack(ks), torch.stack(vs)
    return (torch.stack([k[0] for k in ks]), torch.stack([v[0] for v in vs]),
            torch.stack([k[1] for k in ks]), torch.stack([v[1] for v in vs]))


def _cross_with_kv(p: Params, x: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, n_heads: int, dtype: torch.dtype,
                   k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None,
                   q8: Params | None = None, return_weights: bool = False):
    """Cross-attention against precomputed K/V of one layer.

    bf16/f32 K/V arrive as (B, H, Ta, D); int8 K/V arrive TRANSPOSED as
    (B, H, D, Ta) with per-(B, H) f32 scales; int4 K/V arrive packed as
    (B, H, D/2, Ta) int8 with per-channel (B, H, 1, D) scales, told apart
    from int8 by the halved axis. With ≤ 8 queries per row (the decode
    loop; beams would ride the same axis) quantized K/V go to the
    ``decode_cross_attention_q8`` or ``_q4`` kernel; longer query blocks
    (teacher-forced) take the einsum on the unpacked values with the scales
    folded into q and the output, as in the JAX package.
    ``return_weights=True`` returns (output, f32 softmax probabilities
    (B, H, T, Ta)) and always takes the einsum.
    """
    B, T, d_model = x.shape
    head_dim = d_model // n_heads
    quantized = k.dtype == torch.int8
    packed4 = quantized and k.shape[-2] == head_dim // 2
    xn = layer_norm(p["ln_cross"], x)
    if q8 is None:
        q = linear(p["cross"]["q"], xn, dtype)
    else:
        q = linear_q8(p["cross"]["q"], q8["cross_q"], xn, dtype)
    q = q.reshape(B, T, n_heads, head_dim).transpose(1, 2)
    scale = head_dim ** -0.5

    def out_proj(o):
        if q8 is None:
            return linear(p["cross"]["o"], o, dtype)
        return linear_q8(p["cross"]["o"], q8["cross_o"], o, dtype)

    if quantized and T <= 8 and not return_weights:
        kern = (kernels.decode_cross_attention_q4 if packed4
                else kernels.decode_cross_attention_q8)
        o = kern(q.contiguous(), k, v, k_scale, v_scale)
        o = o.to(dtype).transpose(1, 2).reshape(B, T, d_model)
        return out_proj(o)

    if quantized:
        if packed4:
            k, v = _unpack_kv4(k), _unpack_kv4(v)
        q = (q.float() * k_scale).to(dtype)
        logits = mm_f32(q * scale, k.to(dtype))
        probs = torch.softmax(logits, dim=-1)
        out = mm_f32(probs.to(dtype), v.to(dtype).transpose(-1, -2))
        out = out * v_scale
    else:
        logits = mm_f32(q * scale, k.to(dtype).transpose(-1, -2))
        probs = torch.softmax(logits, dim=-1)
        out = mm_f32(probs.to(dtype), v.to(dtype))
    out = out.to(dtype).transpose(1, 2).reshape(B, T, d_model)
    if return_weights:
        return out_proj(out), probs
    return out_proj(out)


def decoder_forward(
    params: Params,
    dims: WhisperDims,
    tokens: torch.Tensor,  # (B, T) int
    cross_kv,
    pos_offset: int = 0,
    self_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    dtype: torch.dtype = torch.bfloat16,
    collect_cross_weights: str | None = None,
):
    """Teacher-forced decoder pass (prompt priming, word alignment).

    ``cross_kv`` is (k, v) or the int8 or int4 quadruple of
    :func:`precompute_cross_kv`, or a function of the layer index giving
    that layer's (k, v) (the alignment pass: one layer's K/V exist at a
    time). With ``self_cache`` ((L, B, H, C, hd) each) the new K/V are
    written in place at ``pos_offset``. Returns (logits (B, T, vocab) f32,
    the cache or None); with ``collect_cross_weights="alignment_mean"``
    also the DTW alignment statistic: the cross-attention probabilities
    averaged over all heads of the upper half of the layers
    (``layer >= L // 2``), (B, T, Ta) f32, summed layer by layer into one
    buffer.
    """
    if collect_cross_weights not in (None, "alignment_mean"):
        raise ValueError("collect_cross_weights must be None or "
                         f"'alignment_mean', got {collect_cross_weights!r}")
    dec = params["decoder"]
    B, T = tokens.shape
    H = dims.n_text_head
    L = dims.n_text_layer
    if callable(cross_kv):
        layer_kv, ks, vs = cross_kv, None, None
    else:
        quantized = len(cross_kv) == 4
        ks, vs = (cross_kv[2], cross_kv[3]) if quantized else (None, None)

        def layer_kv(i):
            return cross_kv[0][i], cross_kv[1][i]
    device = tokens.device
    acc = None

    x = dec["tok_emb"]["table"].to(dtype)[tokens]
    x = x + dec["pos_emb"][pos_offset:pos_offset + T].to(dtype)
    if self_cache is not None:
        Tc = self_cache[0].shape[3]
        mask = make_causal_mask(T, Tc, offset=pos_offset, device=device)
        mask = mask & (torch.arange(Tc, device=device)[None, :]
                       < pos_offset + T)
    else:
        mask = make_causal_mask(T, T, device=device)

    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        cache = ((self_cache[0][i], self_cache[1][i])
                 if self_cache is not None else None)
        h, _ = mha(p["attn"], layer_norm(p["ln1"], x), H, mask=mask,
                   cache=cache, cache_index=pos_offset, dtype=dtype)
        x = x + h
        ck, cv = layer_kv(i)
        scales = (None if ks is None else ks[i], None if vs is None else vs[i])
        if collect_cross_weights and i >= L // 2:
            h, w = _cross_with_kv(p, x, ck, cv, H, dtype, *scales,
                                  return_weights=True)
            w = w.mean(dim=1)
            acc = w if acc is None else acc + w
        else:
            h = _cross_with_kv(p, x, ck, cv, H, dtype, *scales)
        x = x + h
        x = x + mlp(p["mlp"], layer_norm(p["ln_mlp"], x), dtype)
    x = layer_norm(dec["ln"], x)
    logits = mm_f32(x, dec["tok_emb"]["table"].to(dtype).t())
    if collect_cross_weights:
        return logits, self_cache, acc / float(L - L // 2)
    return logits, self_cache


def quantize_decoder_weights(params: Params, dims: WhisperDims,
                             bits: int = 8,
                             lm_head_bits: int | None = None) -> Params:
    """Per-out-channel int8 (``bits=8``, {"w8", "s"} leaves) or group-wise
    int4 (``bits=4``, {"w4", "s"}) of every weight matrix the decode loop
    re-reads each token (attention, cross q/o, MLP linears and the logits
    head), as per-layer lists like the JAX package's tree.
    ``lm_head_bits`` overrides ``bits`` for the logits head only (the
    int8-blocks + int4-head profile). The head (token table transposed)
    pads its vocab axis to a multiple of 128 with zero columns;
    :func:`decoder_step` slices ``[:, :n_vocab]``."""
    lm_bits = bits if lm_head_bits is None else lm_head_bits
    for what, b in (("bits", bits), ("lm_head_bits", lm_bits)):
        if b not in (8, 4):
            raise ValueError(f"{what} must be 8 or 4, got {b}")
    quant = quantize_linear if bits == 8 else quantize_linear_q4
    dec = params["decoder"]
    blocks = []
    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        blocks.append({
            "attn_q": quant(p["attn"]["q"]["w"]),
            "attn_k": quant(p["attn"]["k"]["w"]),
            "attn_v": quant(p["attn"]["v"]["w"]),
            "attn_o": quant(p["attn"]["o"]["w"]),
            "cross_q": quant(p["cross"]["q"]["w"]),
            "cross_o": quant(p["cross"]["o"]["w"]),
            "mlp_up": quant(p["mlp"]["up"]["w"]),
            "mlp_down": quant(p["mlp"]["down"]["w"]),
        })
    table = dec["tok_emb"]["table"]
    vocab = table.shape[0]
    vocab_pad = -(-vocab // 128) * 128
    wt = F.pad(table.float().t(), (0, vocab_pad - vocab))
    head = quantize_linear if lm_bits == 8 else quantize_linear_q4
    return {"blocks": blocks, "logits": head(wt)}


def q8_param_bytes(dims: WhisperDims, bits: int = 8,
                   lm_head_bits: int | None = None) -> int:
    """Bytes of the :func:`quantize_decoder_weights` copies (weights and
    f32 scales), which sit beside the stored parameters."""
    d = dims.n_text_state
    mats = ([(d, d)] * 6 + [(d, 4 * d), (4 * d, d)]) * dims.n_text_layer
    vocab_pad = -(-dims.n_vocab // 128) * 128
    lm_bits = bits if lm_head_bits is None else lm_head_bits
    return quant_bytes(mats, bits) + quant_bytes([(d, vocab_pad)], lm_bits)


def pack_self_scales(ks: torch.Tensor, vs: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The (..., Cp, 128) packed operand of
    ``kernels.decode_self_attention_q8`` from per-position scales ``ks``,
    ``vs`` (..., H, Cp) f32 and ``valid`` (..., Cp) bool: K scales in lanes
    [0, H), V scales in [H, 2H), the additive mask (0 valid, -1e30 not) in
    lane 2H, zeros past it. The JAX package's format, so one self cache
    feeds both packages."""
    *lead, H, Cp = ks.shape
    out = torch.zeros((*lead, Cp, kernels.SELF_LANES), dtype=torch.float32,
                      device=ks.device)
    out[..., :H] = ks.transpose(-1, -2)
    out[..., H:2 * H] = vs.transpose(-1, -2)
    out[..., 2 * H] = torch.where(valid, 0.0, -1e30)
    return out


def quantize_self_cache(sk: torch.Tensor, sv: torch.Tensor, n_valid: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A primed (L, B, H, C, hd) self cache → the int8 decode form
    (k8 (L, B, H, hd, Cp) int8, v8 likewise, packed scales (L, B, Cp, 128)
    f32) with per-position scales (amax over hd times the f32 reciprocal of
    127, 1 where the amax is 0), C padded up to Cp, a multiple of 128;
    positions ≥ ``n_valid`` are masked. Exactly the JAX package's jitted
    arithmetic (it quantizes the primed cache inside its compiled decode)."""
    L, B, H, C, hd = sk.shape
    Cp = -(-C // 128) * 128

    def q(x):
        xf = x.float()
        a = torch.amax(torch.abs(xf), dim=-1)  # (L, B, H, C)
        s = torch.where(a > 0, a * _INV127, 1.0)
        x8 = torch.round(xf / s[..., None]).to(torch.int8)
        x8 = F.pad(x8.transpose(3, 4), (0, Cp - C)).contiguous()
        return x8, F.pad(s, (0, Cp - C))

    k8, ks = q(sk)
    v8, vs = q(sv)
    valid = (torch.arange(Cp, device=sk.device) < n_valid).expand(L, B, Cp)
    return k8, v8, pack_self_scales(ks, vs, valid)


def _decode_linear(p8: Params | None, dtype: torch.dtype):
    """The decode loops' linear: the f32/bf16 weights, or with ``p8`` (one
    layer of a :func:`quantize_decoder_weights` tree) their int8 or int4
    copy through ``matmul_q8w`` or ``matmul_q4w``."""
    def lin(p: Params, key8: str, x: torch.Tensor) -> torch.Tensor:
        if p8 is None:
            return linear(p, x, dtype)
        return linear_q8(p, p8[key8], x, dtype)
    return lin


def _logits(params: Params, dims: WhisperDims, q8: Params | None,
            x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Final norm and logits head (the token table, or ``q8``'s quantized
    copy padded to a multiple of 128 columns) → (..., vocab) f32."""
    dec = params["decoder"]
    x = layer_norm(dec["ln"], x)
    if q8 is None:
        return mm_f32(x, dec["tok_emb"]["table"].to(dtype).t())
    return linear_q8({}, q8["logits"], x,
                     dtype=torch.float32)[..., :dims.n_vocab]


def decoder_step(
    params: Params,
    dims: WhisperDims,
    tok: torch.Tensor,  # (B, 1) int
    cross_kv,
    pos: int,
    self_cache: tuple[torch.Tensor, ...],
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
    self_kv_int8: bool = False,
    beams: int = 1,
    beam_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """One decode step with the layer loop unrolled. Writes this step's
    K/V into ``self_cache`` IN PLACE at ``pos``. With ``q8`` the weight
    matmuls read int8 or int4 weights through ``matmul_q8w`` or
    ``matmul_q4w``. ``self_cache`` is (sk, sv), each (L, B, H, C, hd), or
    with ``self_kv_int8`` the triple of :func:`quantize_self_cache`: the
    new position's K/V are then quantized on write (amax over hd, from the
    projections after their cast to ``dtype``), its packed scale row is
    written with the mask lane 0 (valid), and the self-attention reads the
    int8 cache through ``decode_self_attention_q8``.

    ``beams=K``: ``tok`` and the self cache carry B = G·K beam rows while
    the cross K/V carries G rows; the K beams of a group fold into the
    query axis of their group's cross-attention (M = K queries per row of
    the decode cross kernels). ``beam_mask`` (G, K, K, C) bool switches
    the self-attention to the lazy-ancestry layout: the cache is
    (L, G, H, K, C, hd) in birth order, each beam writes its own row, and
    beam n of group g reads position c of row k where
    ``beam_mask[g, n, k, c]``; the scores of all (k, c) pairs are masked
    with -1e30 and softmaxed over the flattened (k, c) axis. The int8 self
    cache is greedy-only. Returns (logits (B, vocab) f32, self_cache)."""
    dec = params["decoder"]
    quantized = len(cross_kv) == 4
    ck, cv = cross_kv[0], cross_kv[1]
    ks, vs = (cross_kv[2], cross_kv[3]) if quantized else (None, None)
    B = tok.shape[0]
    H = dims.n_text_head
    d = dims.n_text_state
    hd = d // H
    device = tok.device
    lazy = beam_mask is not None
    if self_kv_int8 and (lazy or beams > 1):
        raise ValueError("self_kv_int8 is greedy-only")

    x = dec["tok_emb"]["table"].to(dtype)[tok]  # (B, 1, d)
    x = x + dec["pos_emb"][pos:pos + 1].to(dtype)
    if self_kv_int8:
        sk, sv, scp = self_cache  # the packed scales carry the mask
    elif lazy:
        sk, sv = self_cache
        G, C = B // beams, sk.shape[4]
        amask = beam_mask.reshape(G, 1, beams, beams * C)
    else:
        sk, sv = self_cache
        mask = torch.arange(sk.shape[3], device=device) < pos + 1  # (C,)
    scale = hd ** -0.5

    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]
        lin = _decode_linear(p8, dtype)
        xn = layer_norm(p["ln1"], x)
        q = lin(p["attn"]["q"], "attn_q", xn).reshape(B, 1, H, hd)
        k = lin(p["attn"]["k"], "attn_k", xn).reshape(B, 1, H, hd)
        v = lin(p["attn"]["v"], "attn_v", xn).reshape(B, 1, H, hd)
        q = q.transpose(1, 2)
        if self_kv_int8:
            row = torch.zeros((B, kernels.SELF_LANES), dtype=torch.float32,
                              device=device)
            for cache, new, lanes in ((sk, k, slice(0, H)),
                                      (sv, v, slice(H, 2 * H))):
                nf = new[:, 0].float()  # (B, H, hd)
                a = torch.amax(torch.abs(nf), dim=-1)
                sc = torch.where(a > 0, a * _INV127, 1.0)
                cache[i, :, :, :, pos] = torch.round(
                    nf / sc[..., None]).to(torch.int8)
                row[:, lanes] = sc
            scp[i, :, pos] = row  # lane 2H stays 0: this position is valid
            o = kernels.decode_self_attention_q8(q.contiguous(), sk[i],
                                                 sv[i], scp[i])
        elif lazy:
            def groups(t):  # (B, H, hd) → (G, H, K, hd)
                return t.reshape(G, beams, H, hd).transpose(1, 2)

            sk[i, :, :, :, pos] = groups(k[:, 0]).to(sk.dtype)
            sv[i, :, :, :, pos] = groups(v[:, 0]).to(sv.dtype)
            s = mm_f32(groups(q[:, :, 0]) * scale,
                       sk[i].reshape(G, H, beams * C, hd).transpose(-1, -2))
            s = s.masked_fill(~amask, -1e30)  # (G, H, K, K·C)
            probs = torch.softmax(s, dim=-1).to(dtype)
            o = mm_f32(probs, sv[i].reshape(G, H, beams * C, hd))
            o = o.to(dtype).transpose(1, 2).reshape(B, H, 1, hd)
        else:
            sk[i, :, :, pos] = k[:, 0].to(sk.dtype)
            sv[i, :, :, pos] = v[:, 0].to(sv.dtype)
            s = mm_f32(q * scale, sk[i].transpose(-1, -2))
            s = s.masked_fill(~mask, -1e30)
            probs = torch.softmax(s, dim=-1).to(dtype)
            o = mm_f32(probs, sv[i])
        o = o.to(dtype).transpose(1, 2).reshape(B, 1, d)
        x = x + lin(p["attn"]["o"], "attn_o", o)
        # beams fold into the query axis of their group's cross-attention
        h = _cross_with_kv(p, x.reshape(B // beams, beams, d), ck[i], cv[i],
                           H, dtype, None if ks is None else ks[i],
                           None if vs is None else vs[i], q8=p8)
        x = x + h.reshape(B, 1, d)
        h = gelu(lin(p["mlp"]["up"], "mlp_up", layer_norm(p["ln_mlp"], x)))
        x = x + lin(p["mlp"]["down"], "mlp_down", h)

    logits = _logits(params, dims, q8, x[:, 0], dtype)
    return logits, ((sk, sv, scp) if self_kv_int8 else (sk, sv))


def prime_decode(params: Params, dims: WhisperDims, enc: torch.Tensor,
                 prompt: torch.Tensor, cache_len: int, dtype: torch.dtype,
                 decoder_q8: Params | None, cross_kv_quantize: bool,
                 cross_kv_bits: int):
    """The decode loops' common start: the cross K/V of ``enc`` and a
    (L, B, H, cache_len, hd) self cache primed with ``prompt``. With
    quantized cross K/V and a short prompt (≤ 16 tokens) the prompt primes
    through unrolled :func:`decoder_step` calls (quantized weights and
    kernels included); longer prompts and the unquantized path prime
    teacher-forced. Returns (cross_kv, (sk, sv), log-probabilities after
    the prompt (B, vocab) f32)."""
    B, P = prompt.shape
    H = dims.n_text_head
    hd = dims.n_text_state // H
    cross_kv = precompute_cross_kv(params, dims, enc, dtype,
                                   quantize=cross_kv_quantize,
                                   bits=cross_kv_bits)
    sk = torch.zeros((dims.n_text_layer, B, H, cache_len, hd), dtype=dtype,
                     device=enc.device)
    sv = torch.zeros_like(sk)
    if cross_kv_quantize and P <= 16:
        logits = None
        for t in range(P):
            logits, (sk, sv) = decoder_step(
                params, dims, prompt[:, t:t + 1], cross_kv, t, (sk, sv),
                dtype=dtype, q8=decoder_q8)
    else:
        logits, _ = decoder_forward(params, dims, prompt, cross_kv,
                                    pos_offset=0, self_cache=(sk, sv),
                                    dtype=dtype)
        logits = logits[:, -1, :]
    return cross_kv, (sk, sv), torch.log_softmax(logits.float(), dim=-1)


def _no_speech(step0: torch.Tensor, no_speech_id: int | None) -> torch.Tensor:
    if no_speech_id is None:
        return torch.zeros(step0.shape[:1], device=step0.device)
    return torch.exp(step0[:, no_speech_id])


@torch.inference_mode()
def greedy_decode(
    params: Params,
    dims: WhisperDims,
    enc: torch.Tensor,  # (B, Ta, d)
    prompt: torch.Tensor,  # (B, P) int
    max_new_tokens: int,
    eot: int,
    dtype: torch.dtype = torch.bfloat16,
    no_speech_id: int | None = None,
    cross_kv_quantize: bool = False,
    decoder_q8: Params | None = None,
    cross_kv_bits: int = 8,
    self_kv_int8: bool = False,
    temperature: float = 0.0,
    rng: jrandom.Key | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched greedy or sampled decode with a static KV cache.

    Returns (tokens (B, P+max_new), avg_logprob (B,), no_speech_prob (B,)),
    positions past EOT filled with ``eot``, as the JAX package's
    ``greedy_decode``. ``cross_kv_bits`` (8 or 4) picks the quantized
    cross K/V; ``decoder_q8`` is a :func:`quantize_decoder_weights` tree;
    the prompt primes as :func:`prime_decode` says. ``self_kv_int8``
    converts the primed cache once (:func:`quantize_self_cache`) and runs
    the loop on the int8 self cache.

    ``temperature > 0`` samples each token as the JAX package draws it
    from ``rng`` (a :func:`ops.random.PRNGKey`, default seed 0): the first
    from ``split(rng)``'s first key, each later one from the first key of
    a further split, by ``categorical`` on the f32 log-softmax times the
    f32 reciprocal of the temperature (XLA compiles the JAX backend's
    division by the constant so); finished rows still emit EOT, and the
    average log-probability is of the chosen tokens.
    """
    B, P = prompt.shape
    total = P + max_new_tokens
    device = enc.device
    cross_kv, (sk, sv), step0 = prime_decode(
        params, dims, enc, prompt, min(dims.n_text_ctx, total), dtype,
        decoder_q8, cross_kv_quantize, cross_kv_bits)
    no_speech_prob = _no_speech(step0, no_speech_id)

    if temperature > 0.0:
        inv_t = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
            temperature, dtype=torch.float32)
        inv_t = inv_t.to(device)
        rng = jrandom.PRNGKey(0) if rng is None else rng

    def pick(logp: torch.Tensor) -> torch.Tensor:
        nonlocal rng
        if temperature <= 0.0:
            return torch.argmax(logp, dim=-1)
        key, rng = jrandom.split(rng)
        return jrandom.categorical(key, logp * inv_t)

    rows = torch.arange(B, device=device)
    first = pick(step0)
    sum_lp = step0[rows, first]
    tokens = torch.full((B, total), eot, dtype=torch.long, device=device)
    tokens[:, :P] = prompt
    tokens[:, P] = first
    finished = first == eot
    n_decoded = torch.ones((B,), device=device)
    # the int8 cache replaces the bf16 one, which dies here
    cache = quantize_self_cache(sk, sv, P) if self_kv_int8 else (sk, sv)
    del sk, sv

    i = P
    while i < total - 1 and not bool(finished.all()):
        logits, cache = decoder_step(
            params, dims, tokens[:, i:i + 1], cross_kv, i, cache,
            dtype=dtype, q8=decoder_q8, self_kv_int8=self_kv_int8)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = pick(logp)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        lp = logp[rows, nxt]
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        n_decoded = n_decoded + torch.where(finished, 0.0, 1.0)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eot)
        i += 1
    return tokens, sum_lp / torch.clamp(n_decoded, min=1.0), no_speech_prob


@torch.inference_mode()
def detect_language(params: Params, dims: WhisperDims, enc: torch.Tensor,
                    st: SpecialTokens, dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(language offset from ``st.lang_base`` (B,), its probability (B,))
    from one decoder step over ``<|sot|>``: the softmax of the first-step
    logits over the language block [lang_base, translate) (99 tokens on
    the v2 vocabulary, 100 on large-v3's)."""
    B = enc.shape[0]
    ckv = precompute_cross_kv(params, dims, enc, dtype)
    sot = torch.full((B, 1), st.sot, dtype=torch.long, device=enc.device)
    logits, _ = decoder_forward(params, dims, sot, ckv, dtype=dtype)
    lang = logits[:, 0, st.lang_base: st.translate]
    probs = torch.softmax(lang.float(), dim=-1)
    best = torch.argmax(probs, dim=-1)
    return best, probs[torch.arange(B, device=enc.device), best]


# -- speculative greedy decode ------------------------------------------------

def ngram_draft(tokens: torch.Tensor, n_tok: torch.Tensor,
                draft_len: int) -> torch.Tensor:
    """Prompt-lookup drafts (B, draft_len): what followed the latest earlier
    occurrence of each row's final 2-gram (``tokens`` (B, total) valid
    through index ``n_tok`` (B,)); rows without a match repeat their last
    token."""
    B, total = tokens.shape
    device = tokens.device
    rows = torch.arange(B, device=device)
    g1 = tokens[rows, n_tok]
    g0 = tokens[rows, torch.clamp(n_tok - 1, min=0)]
    idx = torch.arange(total - 1, device=device)
    m = ((tokens[:, :-1] == g0[:, None]) & (tokens[:, 1:] == g1[:, None])
         & (idx[None, :] + 1 < n_tok[:, None]))
    s = torch.where(m, idx[None, :], -1).amax(dim=1)  # latest match or -1
    src = torch.clamp(s[:, None] + 2
                      + torch.arange(draft_len, device=device)[None, :],
                      0, total - 1)
    drafts = tokens.gather(1, src)
    return torch.where(s[:, None] >= 0, drafts, g1[:, None])


def decoder_block_verify(
    params: Params,
    dims: WhisperDims,
    block: torch.Tensor,  # (B, k) int: [cur, draft_1 .. draft_{k-1}]
    cross_kv,
    pos: torch.Tensor,  # (B,) int: each row's cache index of block[:, 0]
    self_cache: tuple[torch.Tensor, torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Teacher-forced k-token step with per-row positions, the verify pass
    of speculative decoding. Row b writes its k new K/V IN PLACE at cache
    slots pos_b .. pos_b + k - 1 (clipped to the cache), query j attends
    to the slots ≤ pos_b + j, and the k queries ride the query axis of the
    cross-attention (the decode cross kernels for k ≤ 8). Returns (logits
    (B, k, vocab) f32, self_cache)."""
    dec = params["decoder"]
    quantized = len(cross_kv) == 4
    ck, cv = cross_kv[0], cross_kv[1]
    ks, vs = (cross_kv[2], cross_kv[3]) if quantized else (None, None)
    sk, sv = self_cache
    B, k = block.shape
    H = dims.n_text_head
    d = dims.n_text_state
    hd = d // H
    C = sk.shape[3]
    device = block.device
    at = pos[:, None] + torch.arange(k, device=device)[None, :]  # (B, k)

    x = dec["tok_emb"]["table"].to(dtype)[block]  # (B, k, d)
    x = x + dec["pos_emb"][torch.clamp(at, 0, dims.n_text_ctx - 1)].to(dtype)
    cpos = torch.clamp(at, 0, C - 1)
    mask = (torch.arange(C, device=device)[None, None, None, :]
            <= cpos[:, None, :, None])  # (B, 1, k, C)
    rows = torch.arange(B, device=device)[:, None]
    scale = hd ** -0.5

    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]
        lin = _decode_linear(p8, dtype)
        xn = layer_norm(p["ln1"], x)
        q = lin(p["attn"]["q"], "attn_q", xn).reshape(B, k, H, hd)
        kk = lin(p["attn"]["k"], "attn_k", xn).reshape(B, k, H, hd)
        vv = lin(p["attn"]["v"], "attn_v", xn).reshape(B, k, H, hd)
        # per-row scatter: sk[i][b, :, cpos[b, j]] = kk[b, j]
        sk[i][rows, :, cpos] = kk.to(sk.dtype)
        sv[i][rows, :, cpos] = vv.to(sv.dtype)
        s = mm_f32(q.transpose(1, 2) * scale, sk[i].transpose(-1, -2))
        s = s.masked_fill(~mask, -1e30)
        probs = torch.softmax(s, dim=-1).to(dtype)
        o = mm_f32(probs, sv[i]).to(dtype).transpose(1, 2).reshape(B, k, d)
        x = x + lin(p["attn"]["o"], "attn_o", o)
        x = x + _cross_with_kv(p, x, ck[i], cv[i], H, dtype,
                               None if ks is None else ks[i],
                               None if vs is None else vs[i], q8=p8)
        h = gelu(lin(p["mlp"]["up"], "mlp_up", layer_norm(p["ln_mlp"], x)))
        x = x + lin(p["mlp"]["down"], "mlp_down", h)

    return _logits(params, dims, q8, x, dtype), (sk, sv)


@torch.inference_mode()
def speculative_greedy_decode(
    params: Params,
    dims: WhisperDims,
    enc: torch.Tensor,  # (B, Ta, d)
    prompt: torch.Tensor,  # (B, P) int
    max_new_tokens: int,
    eot: int,
    spec_k: int = 8,
    dtype: torch.dtype = torch.bfloat16,
    no_speech_id: int | None = None,
    cross_kv_quantize: bool = False,
    cross_kv_bits: int = 8,
    decoder_q8: Params | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Greedy decode in verify blocks of ``spec_k`` tokens: each iteration
    drafts ``spec_k - 1`` tokens with :func:`ngram_draft` and verifies the
    block in one :func:`decoder_block_verify` pass; a draft survives only
    where it equals the model's own argmax, and the argmax after the last
    survivor is emitted too, so the output is :func:`greedy_decode`'s.
    Rows advance by their own acceptance counts, stop at their first EOT
    and never write past the buffer. Returns (tokens (B, P+max_new),
    avg_logprob (B,), no_speech_prob (B,), verify iterations run)."""
    B, P = prompt.shape
    k = spec_k
    total = P + max_new_tokens
    device = enc.device
    # a block write may reach k - 1 slots past a row's last real position
    cross_kv, cache, step0 = prime_decode(
        params, dims, enc, prompt, min(dims.n_text_ctx, total) + k, dtype,
        decoder_q8, cross_kv_quantize, cross_kv_bits)
    no_speech_prob = _no_speech(step0, no_speech_id)

    rows = torch.arange(B, device=device)
    j = torch.arange(k, device=device)[None, :]
    first = torch.argmax(step0, dim=-1)
    sum_lp = step0[rows, first]
    tokens = torch.full((B, total), eot, dtype=torch.long, device=device)
    tokens[:, :P] = prompt
    tokens[:, P] = first
    finished = first == eot
    n_decoded = torch.ones((B,), device=device)
    n_tok = torch.full((B,), P, dtype=torch.long, device=device)
    steps = 0
    while not bool(finished.all()):
        block = torch.cat([tokens[rows, n_tok][:, None],
                           ngram_draft(tokens, n_tok, k - 1)], dim=1)
        logits, cache = decoder_block_verify(
            params, dims, block, cross_kv, n_tok, cache, dtype=dtype,
            q8=decoder_q8)
        logp = torch.log_softmax(logits.float(), dim=-1)
        f = torch.argmax(logp, dim=-1)  # (B, k)
        f_lp = logp.gather(-1, f[..., None])[..., 0]
        # accepted drafts are the argmaxes f[:, :a], plus the bonus f[:, a]
        a = torch.cumprod((block[:, 1:] == f[:, :-1]).long(), dim=1).sum(1)
        is_eot = f == eot
        a = torch.where(is_eot.any(1),
                        torch.minimum(a, is_eot.int().argmax(1)), a)
        a = torch.minimum(a, total - 2 - n_tok)  # emission bound
        write = (j <= a[:, None]) & ~finished[:, None]  # (B, k)
        dst = n_tok[:, None] + 1 + j
        tokens[rows[:, None].expand(B, k)[write], dst[write]] = f[write]
        sum_lp = sum_lp + torch.where(write, f_lp, 0.0).sum(1)
        n_decoded = n_decoded + write.float().sum(1)
        n_tok = n_tok + torch.where(finished, 0, a + 1)
        finished = finished | (is_eot & write).any(1) | (n_tok >= total - 1)
        steps += 1
    return (tokens, sum_lp / torch.clamp(n_decoded, min=1.0), no_speech_prob,
            steps)


# -- beam search --------------------------------------------------------------

#: hypothesis-reorder strategies of :func:`beam_decode`
BEAM_REORDERS = ("lazy", "onehot", "kernel")


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    equal values in index order (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass
class BeamState:
    """The beam loop's carry. Physical layouts ("onehot", "kernel"): the
    caches are (L, B·K, H, C, hd) and each step reorders them by source
    beam into new tensors (the previous pair is freed, so two pairs live
    at once). "lazy": the caches are (L, B, H, K, C, hd) in birth order,
    updated in place, and ``mask`` (B, K, K, C) bool routes each beam to
    its history."""
    tokens: torch.Tensor    # (B, K, total) hypotheses
    sum_lp: torch.Tensor    # (B, K) f32 summed log-probabilities
    finished: torch.Tensor  # (B, K) bool: the hypothesis has emitted EOT
    pos: int                # position of the tokens the next step feeds
    cache: tuple[torch.Tensor, torch.Tensor]
    mask: torch.Tensor | None
    reorder: str
    eot: int

    @property
    def done(self) -> bool:
        return (self.pos >= self.tokens.shape[2] - 1
                or bool(self.finished.all()))


def beam_start(cache: tuple[torch.Tensor, torch.Tensor],
               logp0: torch.Tensor, prompt: torch.Tensor, total: int,
               beam_size: int, eot: int, reorder: str) -> BeamState:
    """The beam loop's first carry from a cache primed over B rows and the
    log-probabilities after the prompt (:func:`prime_decode`): the top-K
    first tokens per row; the primed cache replicated K× (physical layouts) or
    placed at birth row 0 with every beam's prompt positions pointing
    there (lazy). ``cache`` is read, not written."""
    if reorder not in BEAM_REORDERS:
        raise ValueError(f"unknown beam reorder mode {reorder!r}")
    sk, sv = cache
    B, P = prompt.shape
    K = beam_size
    top_lp, top_tok = _top_k(logp0, K)
    tokens = torch.full((B, K, total), eot, dtype=torch.long,
                        device=prompt.device)
    tokens[:, :, :P] = prompt[:, None, :]
    tokens[:, :, P] = top_tok
    mask = None
    if reorder == "lazy":
        L, _, H, C, hd = sk.shape
        lazy = []
        for c in (sk, sv):
            t = c.new_zeros((L, B, H, K, C, hd))
            t[:, :, :, 0] = c
            lazy.append(t)
        cache = tuple(lazy)
        mask = torch.zeros((B, K, K, C), dtype=torch.bool, device=sk.device)
        mask[:, :, 0, :P] = True
    else:
        cache = (sk.repeat_interleave(K, dim=1),
                 sv.repeat_interleave(K, dim=1))
    return BeamState(tokens, top_lp, top_tok == eot, P, cache, mask,
                     reorder, eot)


def _onehot_reorder(cache, idx: torch.Tensor):
    """The JAX package's 0/1 one-hot matmul reorder, layer by layer (each
    (N, H·C·hd) layer slab is a view, so no transposed copy of the cache
    is made). Exact: each output is one product 1·x plus products 0·y."""
    N = idx.shape[0]
    onehot = F.one_hot(idx, N).to(cache[0].dtype)
    out = []
    with full_f32_matmul():
        for c in cache:
            o = torch.empty_like(c)
            for layer in range(c.shape[0]):
                torch.matmul(onehot, c[layer].reshape(N, -1),
                             out=o[layer].reshape(N, -1))
            out.append(o)
    return tuple(out)


def beam_step(params: Params, dims: WhisperDims, cross_kv,
              state: BeamState, dtype: torch.dtype = torch.bfloat16,
              decoder_q8: Params | None = None) -> torch.Tensor:
    """One iteration of the beam loop, advancing ``state`` in place: a
    :func:`decoder_step` over the B·K beams at ``state.pos``; finished
    beams extend only with EOT at no cost; the K best of the K·V
    candidates of each row survive; the hypotheses, flags and caches
    follow their source beams ("kernel": ``kernels.beam_reorder_kv``;
    "onehot": :func:`_onehot_reorder`; "lazy": the ancestry mask's beam
    axis, the caches stay). Returns the step's logits (B·K, vocab) f32."""
    B, K, total = state.tokens.shape
    V = dims.n_vocab
    i = state.pos
    device = state.tokens.device
    flat = state.tokens.reshape(B * K, total)
    lazy = state.reorder == "lazy"
    if lazy:  # each beam's new position lands in its own birth row
        ar = torch.arange(K, device=device)
        state.mask[:, ar, ar, i] = True
    logits, cache = decoder_step(
        params, dims, flat[:, i:i + 1], cross_kv, i, state.cache,
        dtype=dtype, q8=decoder_q8, beams=K,
        beam_mask=state.mask if lazy else None)
    logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
    eot_only = torch.full((V,), float("-inf"), device=device)
    eot_only[state.eot] = 0.0
    logp = torch.where(state.finished[..., None], eot_only, logp)
    cand = state.sum_lp[..., None] + logp
    new_lp, flat_idx = _top_k(cand.reshape(B, K * V), K)
    src = flat_idx // V
    new_tok = flat_idx % V
    gather = (torch.arange(B, device=device)[:, None] * K + src).reshape(-1)
    tokens = flat[gather].reshape(B, K, total)
    tokens[:, :, i + 1] = new_tok
    if lazy:
        state.mask = state.mask[torch.arange(B, device=device)[:, None], src]
    elif state.reorder == "kernel":
        state.cache = kernels.beam_reorder_kv(*cache, gather)
    else:
        state.cache = _onehot_reorder(cache, gather)
    state.finished = (state.finished.reshape(-1)[gather].reshape(B, K)
                      | (new_tok == state.eot))
    state.tokens, state.sum_lp, state.pos = tokens, new_lp, i + 1
    return logits


def beam_best(state: BeamState, prompt_len: int,
              length_penalty: float = 1.0) -> torch.Tensor:
    """The hypothesis of each row with the best length-normalised summed
    log-probability, (B, total), EOT-padded."""
    tokens = state.tokens
    lengths = (tokens != state.eot).float().sum(-1) - prompt_len + 1.0
    score = state.sum_lp / torch.clamp(lengths, min=1.0) ** length_penalty
    best = torch.argmax(score, dim=-1)
    return tokens[torch.arange(tokens.shape[0], device=tokens.device), best]


@torch.inference_mode()
def beam_decode(
    params: Params,
    dims: WhisperDims,
    enc: torch.Tensor,  # (B, Ta, d)
    prompt: torch.Tensor,  # (B, P) int
    max_new_tokens: int,
    eot: int,
    beam_size: int = 5,
    length_penalty: float = 1.0,
    dtype: torch.dtype = torch.bfloat16,
    decoder_q8: Params | None = None,
    cross_kv_quantize: bool = False,
    cross_kv_bits: int = 8,
    reorder: str | None = None,
) -> tuple[torch.Tensor, int]:
    """Beam search over B windows with K = ``beam_size`` hypotheses each,
    as the JAX package's ``beam_decode``: the cross K/V is computed for
    the B windows only and the K beams of a window ride the query axis of
    its cross-attention; the prompt primes B rows (:func:`prime_decode`);
    the loop (:func:`beam_step`) runs until every hypothesis has finished or
    the buffer is full. ``reorder`` (default: the ``BEAM_REORDER``
    environment variable, else "lazy") picks the reorder of the self
    caches, see :data:`BEAM_REORDERS` and :class:`BeamState`: the three
    give the same tokens, "kernel" and "onehot" the same bits. Caches are
    updated in place. Returns (the best hypothesis per window (B,
    P+max_new), EOT-padded; the loop iterations run)."""
    mode = reorder or os.environ.get("BEAM_REORDER", "lazy")
    P = prompt.shape[1]
    total = P + max_new_tokens
    cross_kv, cache, logp0 = prime_decode(
        params, dims, enc, prompt, min(dims.n_text_ctx, total), dtype,
        decoder_q8, cross_kv_quantize, cross_kv_bits)
    state = beam_start(cache, logp0, prompt, total, beam_size, eot, mode)
    del cache
    while not state.done:
        beam_step(params, dims, cross_kv, state, dtype, decoder_q8)
    return beam_best(state, P, length_penalty), state.pos - P
