"""Whisper encoder/decoder on tensors with params in dicts — greedy path.

Counterpart of ``audio_rag_tpu/models/whisper.py``: the same param tree
(per-layer blocks stacked on a leading L axis), the same presets, special
tokens and char codec, and the same functions for the greedy path:
:func:`encode`, :func:`precompute_cross_kv` (bf16/f32 and int8),
:func:`decoder_forward` (teacher-forced priming, no cross weights),
:func:`_cross_with_kv`, :func:`quantize_decoder_weights` (8 bits),
:func:`decoder_step` (greedy) and :func:`greedy_decode`. ``lax.scan`` and
``while_loop`` become Python loops; KV caches are updated in place.

Kernel routes on CUDA (plain versions on the CPU, see ``ops/kernels.py``):
the encoder's self-attention goes to ``flash_attention``; with int8 cross
K/V the decode loop's cross-attention (≤ 8 queries per row) goes to
``decode_cross_attention_q8``; with ``quantize_decoder_weights`` the decode
loop's weight matmuls go to ``matmul_q8w``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from audio_rag_tpu_torch.models.layers import (
    Params,
    gelu,
    layer_norm,
    linear,
    linear_q8,
    make_causal_mask,
    mha,
    mlp,
    mm_f32,
    quantize_linear,
    sinusoid_positions,
    take_layer,
)
from audio_rag_tpu_torch.ops import kernels

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
    "precompute_cross_kv",
    "decoder_forward",
    "quantize_decoder_weights",
    "decoder_step",
    "greedy_decode",
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
    padding ((1, 1) at stride 1; (0, 1) at stride 2 on an even T)."""
    T = x.shape[1]
    out_len = -(-T // stride)
    pad = max((out_len - 1) * stride + 3 - T, 0)
    w = p["w"].to(dtype).permute(2, 1, 0)  # (3, Cin, Cout) → (Cout, Cin, 3)
    xc = F.pad(x.to(dtype).transpose(1, 2), (pad // 2, pad - pad // 2))
    if xc.is_cuda and dtype != torch.float32:
        y = F.conv1d(xc, w, stride=stride).float()
    else:
        y = F.conv1d(xc.float(), w.float(), stride=stride)
    return (y.transpose(1, 2) + p["b"].float()).to(dtype)


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
    scale = torch.clamp(amax, min=1e-9) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q.transpose(2, 3).contiguous(), scale


def precompute_cross_kv(params: Params, dims: WhisperDims, enc: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16,
                        quantize: bool = False):
    """Per-layer cross K/V from encoder states.

    ``quantize=False``: (k, v), each (L, B, H, Ta, D) in ``dtype``.
    ``quantize=True``: (k8, v8, k_scale, v_scale) with int8 K/V TRANSPOSED
    to (L, B, H, D, Ta) and per-(L, B, H) f32 scales (L, B, H, 1, 1) — the
    layout the decode cross kernel reads; quantized layer by layer so the
    f32 temporaries never exist for all layers at once.
    """
    head_dim = dims.n_text_state // dims.n_text_head
    B, Ta, _ = enc.shape
    blocks = params["decoder"]["blocks"]
    ks, vs = [], []
    for i in range(dims.n_text_layer):
        cross = take_layer(blocks["cross"], i)
        k = linear(cross["k"], enc, dtype).reshape(
            B, Ta, dims.n_text_head, head_dim).transpose(1, 2)
        v = linear(cross["v"], enc, dtype).reshape(
            B, Ta, dims.n_text_head, head_dim).transpose(1, 2)
        if quantize:
            k, v = _quant8(k), _quant8(v)
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
                   q8: Params | None = None) -> torch.Tensor:
    """Cross-attention against precomputed K/V of one layer.

    bf16/f32 K/V arrive as (B, H, Ta, D); int8 K/V arrive TRANSPOSED as
    (B, H, D, Ta) with per-(B, H) f32 scales. The int8 case with ≤ 8
    queries per row (the decode loop; beams would ride the same axis) goes
    to the ``decode_cross_attention_q8`` kernel; longer int8 query blocks
    (teacher-forced) take the einsum with the scales folded into q and the
    output, as in the JAX package.
    """
    B, T, d_model = x.shape
    head_dim = d_model // n_heads
    quantized = k.dtype == torch.int8
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

    if quantized and T <= 8:
        o = kernels.decode_cross_attention_q8(q.contiguous(), k, v,
                                              k_scale, v_scale)
        o = o.to(dtype).transpose(1, 2).reshape(B, T, d_model)
        return out_proj(o)

    if quantized:
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
    return out_proj(out)


def decoder_forward(
    params: Params,
    dims: WhisperDims,
    tokens: torch.Tensor,  # (B, T) int
    cross_kv,
    pos_offset: int = 0,
    self_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor] | None]:
    """Teacher-forced decoder pass (the prompt-priming path).

    ``cross_kv`` is (k, v) or the int8 quadruple of
    :func:`precompute_cross_kv`. With ``self_cache`` ((L, B, H, C, hd)
    each) the new K/V are written in place at ``pos_offset``. Returns
    (logits (B, T, vocab) f32, the cache or None).
    """
    dec = params["decoder"]
    B, T = tokens.shape
    H = dims.n_text_head
    quantized = len(cross_kv) == 4
    ck, cv = cross_kv[0], cross_kv[1]
    ks, vs = (cross_kv[2], cross_kv[3]) if quantized else (None, None)
    device = tokens.device

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
        x = x + _cross_with_kv(p, x, ck[i], cv[i], H, dtype,
                               None if ks is None else ks[i],
                               None if vs is None else vs[i])
        x = x + mlp(p["mlp"], layer_norm(p["ln_mlp"], x), dtype)
    x = layer_norm(dec["ln"], x)
    logits = mm_f32(x, dec["tok_emb"]["table"].to(dtype).t())
    return logits, self_cache


def quantize_decoder_weights(params: Params, dims: WhisperDims) -> Params:
    """Per-out-channel int8 of every weight matrix the decode loop re-reads
    each token (attention, cross q/o, MLP linears and the logits head),
    as per-layer lists like the JAX package's ``bits=8`` tree. The logits
    head (token table transposed) pads its vocab axis to a multiple of 128
    with zero columns; :func:`decoder_step` slices ``[:, :n_vocab]``."""
    dec = params["decoder"]
    blocks = []
    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        blocks.append({
            "attn_q": quantize_linear(p["attn"]["q"]["w"]),
            "attn_k": quantize_linear(p["attn"]["k"]["w"]),
            "attn_v": quantize_linear(p["attn"]["v"]["w"]),
            "attn_o": quantize_linear(p["attn"]["o"]["w"]),
            "cross_q": quantize_linear(p["cross"]["q"]["w"]),
            "cross_o": quantize_linear(p["cross"]["o"]["w"]),
            "mlp_up": quantize_linear(p["mlp"]["up"]["w"]),
            "mlp_down": quantize_linear(p["mlp"]["down"]["w"]),
        })
    table = dec["tok_emb"]["table"]
    vocab = table.shape[0]
    vocab_pad = -(-vocab // 128) * 128
    wt = F.pad(table.float().t(), (0, vocab_pad - vocab))
    return {"blocks": blocks, "logits": quantize_linear(wt)}


def decoder_step(
    params: Params,
    dims: WhisperDims,
    tok: torch.Tensor,  # (B, 1) int
    cross_kv,
    pos: int,
    self_cache: tuple[torch.Tensor, torch.Tensor],  # (L, B, H, C, hd) ×2
    dtype: torch.dtype = torch.bfloat16,
    q8: Params | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One greedy decode step with the layer loop unrolled. Writes this
    step's K/V into ``self_cache`` IN PLACE at ``pos``. With ``q8`` the
    weight matmuls read int8 weights through ``matmul_q8w``. Returns
    (logits (B, vocab) f32, self_cache)."""
    dec = params["decoder"]
    quantized = len(cross_kv) == 4
    ck, cv = cross_kv[0], cross_kv[1]
    ks, vs = (cross_kv[2], cross_kv[3]) if quantized else (None, None)
    sk, sv = self_cache
    B = tok.shape[0]
    H = dims.n_text_head
    hd = dims.n_text_state // H
    C = sk.shape[3]
    device = tok.device

    x = dec["tok_emb"]["table"].to(dtype)[tok]  # (B, 1, d)
    x = x + dec["pos_emb"][pos:pos + 1].to(dtype)
    mask = torch.arange(C, device=device) < pos + 1  # (C,)
    scale = hd ** -0.5

    for i in range(dims.n_text_layer):
        p = take_layer(dec["blocks"], i)
        p8 = None if q8 is None else q8["blocks"][i]

        def lin(pp, key8, xx):
            if p8 is None:
                return linear(pp, xx, dtype)
            return linear_q8(pp, p8[key8], xx, dtype)

        xn = layer_norm(p["ln1"], x)
        q = lin(p["attn"]["q"], "attn_q", xn).reshape(B, 1, H, hd)
        k = lin(p["attn"]["k"], "attn_k", xn).reshape(B, 1, H, hd)
        v = lin(p["attn"]["v"], "attn_v", xn).reshape(B, 1, H, hd)
        q = q.transpose(1, 2)
        sk[i, :, :, pos] = k[:, 0].to(sk.dtype)
        sv[i, :, :, pos] = v[:, 0].to(sv.dtype)
        s = mm_f32(q * scale, sk[i].transpose(-1, -2))
        s = s.masked_fill(~mask, -1e30)
        probs = torch.softmax(s, dim=-1).to(dtype)
        o = mm_f32(probs, sv[i]).to(dtype)
        o = o.transpose(1, 2).reshape(B, 1, dims.n_text_state)
        x = x + lin(p["attn"]["o"], "attn_o", o)
        x = x + _cross_with_kv(p, x, ck[i], cv[i], H, dtype,
                               None if ks is None else ks[i],
                               None if vs is None else vs[i], q8=p8)
        if p8 is None:
            x = x + mlp(p["mlp"], layer_norm(p["ln_mlp"], x), dtype)
        else:
            h = gelu(lin(p["mlp"]["up"], "mlp_up",
                         layer_norm(p["ln_mlp"], x)))
            x = x + lin(p["mlp"]["down"], "mlp_down", h)

    x = layer_norm(dec["ln"], x)
    if q8 is None:
        logits = mm_f32(x[:, 0], dec["tok_emb"]["table"].to(dtype).t())
    else:
        logits = linear_q8({}, q8["logits"], x[:, 0],
                           dtype=torch.float32)[:, :dims.n_vocab]
    return logits, (sk, sv)


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched greedy decode with a static KV cache.

    Returns (tokens (B, P+max_new), avg_logprob (B,), no_speech_prob (B,)),
    positions past EOT filled with ``eot``, as the JAX package's
    ``greedy_decode`` at temperature 0. With int8 cross K/V and a short
    prompt (≤ 16 tokens) the prompt primes through unrolled
    :func:`decoder_step` calls (int8 weights and kernels included); longer
    prompts and the unquantized path prime teacher-forced.
    """
    B, P = prompt.shape
    L = dims.n_text_layer
    H = dims.n_text_head
    hd = dims.n_text_state // H
    total = P + max_new_tokens
    cache_len = min(dims.n_text_ctx, total)
    device = enc.device

    cross_kv = precompute_cross_kv(params, dims, enc, dtype,
                                   quantize=cross_kv_quantize)
    sk = torch.zeros((L, B, H, cache_len, hd), dtype=dtype, device=device)
    sv = torch.zeros_like(sk)

    if cross_kv_quantize and P <= 16:
        logits = None
        for t in range(P):
            logits, (sk, sv) = decoder_step(
                params, dims, prompt[:, t:t + 1], cross_kv, t, (sk, sv),
                dtype=dtype, q8=decoder_q8)
        step0 = torch.log_softmax(logits.float(), dim=-1)
    else:
        logits, _ = decoder_forward(params, dims, prompt, cross_kv,
                                    pos_offset=0, self_cache=(sk, sv),
                                    dtype=dtype)
        step0 = torch.log_softmax(logits[:, -1, :].float(), dim=-1)
    no_speech_prob = (torch.exp(step0[:, no_speech_id])
                      if no_speech_id is not None
                      else torch.zeros((B,), device=device))

    rows = torch.arange(B, device=device)
    first = torch.argmax(step0, dim=-1)
    sum_lp = step0[rows, first]
    tokens = torch.full((B, total), eot, dtype=torch.long, device=device)
    tokens[:, :P] = prompt
    tokens[:, P] = first
    finished = first == eot
    n_decoded = torch.ones((B,), device=device)

    i = P
    while i < total - 1 and not bool(finished.all()):
        logits, (sk, sv) = decoder_step(
            params, dims, tokens[:, i:i + 1], cross_kv, i, (sk, sv),
            dtype=dtype, q8=decoder_q8)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logp, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, eot), nxt)
        lp = logp[rows, nxt]
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        n_decoded = n_decoded + torch.where(finished, 0.0, 1.0)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eot)
        i += 1
    return tokens, sum_lp / torch.clamp(n_decoded, min=1.0), no_speech_prob
