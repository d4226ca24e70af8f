"""Batched-window Whisper ASR backend of the port.

Counterpart of ``audio_rag_tpu/asr/whisper_jax.py``: decode → slice into
windows of the model's audio context → log-mel of a window batch → encode →
decode of all windows of the batch at once → strip special tokens,
no-speech gate, segments → interpolated word times. The parameters come
from the committed asset for "tiny-synth" and from a seeded init for the
other presets; ``compute_type="bfloat16"`` stores and computes in bf16;
the quantization switches of ``ASRConfig`` pick the decode profile as the
JAX backend does (int4 beats int8; ``lm_head_int4`` only with
``decoder_int8`` and without ``decoder_int4``; ``self_kv_int8``), and with
it the quantized decode kernels. The decode strategy is chosen as the JAX
backend's ``_program`` chooses it: beam search under ``decode="beam"``
(its avg-logprob and no-speech probability are 0, so the no-speech gate
never drops a window); else speculative greedy under ``speculative_k > 0``
with a prompt of ≤ 16 tokens; else greedy. Beam and speculative ignore
``self_kv_int8``. Not ported here: VAD, temperature fallback, language
detection, conditioning on previous text, DTW word timestamps.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.audio.io import decode_audio
from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, load_npz_asset
from audio_rag_tpu_torch.config import ASRConfig
from audio_rag_tpu_torch.core.exceptions import TranscriptionError
from audio_rag_tpu_torch.core.types import TranscriptSegment, Word
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.models.whisper import (
    WHISPER_PRESETS,
    SpecialTokens,
    WhisperDims,
    beam_decode,
    char_decode,
    encode,
    greedy_decode,
    init_whisper,
    language_offset,
    quantize_decoder_weights,
    speculative_greedy_decode,
)
from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, SAMPLE_RATE, log_mel_batch
from audio_rag_tpu_torch.weights import whisper_params

__all__ = ["WhisperASR", "interpolate_words"]

MAX_NEW_TOKENS = 224  # ≤ n_text_ctx/2, as Whisper decodes per window


class WhisperASR:
    """Batched-window Whisper on one device.

    ``timings`` accumulates, per :meth:`transcribe` call, host-clock seconds
    of the mel, encode and decode stages (each ends in a device
    synchronize on CUDA), the decode-loop iterations run (greedy steps,
    beam steps or speculative verify passes) and the windows and batches
    seen.
    """

    def __init__(self, config: ASRConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or ASRConfig()
        size = self.config.model_size
        if size not in WHISPER_PRESETS:
            raise TranscriptionError(f"unknown whisper size {size!r}")
        self.device = resolve_device(device)
        self.dims: WhisperDims = WHISPER_PRESETS[size]
        self.tokens = SpecialTokens.for_dims(self.dims)
        self.dtype = (torch.bfloat16 if self.config.compute_type == "bfloat16"
                      else torch.float32)
        c = self.config
        #: decode profile: 0 = off, else the bits of the cross K/V, of the
        #: decoder's weight matmuls and of the logits head (None = as the
        #: decoder's)
        self.cross_kv_bits = 4 if c.cross_kv_int4 else (
            8 if c.cross_kv_int8 else 0)
        self.decoder_bits = 4 if c.decoder_int4 else (
            8 if c.decoder_int8 else 0)
        self.lm_head_bits = (4 if self.decoder_bits == 8 and c.lm_head_int4
                             else None)
        self._params = None
        self._params_q8 = None
        self.timings: dict[str, float] = {}
        self._decode_text = (char_decode if size == "tiny-synth"
                             else lambda ids: " ".join(f"tok{int(i)}"
                                                       for i in ids))

    # -- lifecycle ---------------------------------------------------------
    @property
    def is_loaded(self) -> bool:
        return self._params is not None

    @property
    def window_seconds(self) -> float:
        """Seconds of audio per window: the model's audio context (30 s for
        the released sizes, 6 s for tiny-synth)."""
        return 2 * self.dims.n_audio_ctx * HOP_LENGTH / SAMPLE_RATE

    def load(self) -> None:
        if self.is_loaded:
            return
        tree = None
        if self.config.model_size == "tiny-synth":
            tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
            if tree is None:
                raise TranscriptionError("asr_tiny_synth.npz asset missing")
        if tree is not None:
            params = whisper_params(tree, self.dims, self.device,
                                    dtype=self.dtype)
        else:
            params = init_whisper(self.dims, seed=self.config.seed,
                                  device=self.device, dtype=self.dtype)
        self._params = params
        if self.decoder_bits:
            self._params_q8 = quantize_decoder_weights(
                params, self.dims, self.decoder_bits, self.lm_head_bits)

    # -- public API --------------------------------------------------------
    def _max_new(self) -> int:
        if self.dims.n_text_ctx >= 448:
            cap = MAX_NEW_TOKENS
        elif self.dims.n_text_ctx >= 128:
            cap = self.dims.n_text_ctx - 16  # tiny-synth: char-level text
        else:
            cap = 8
        if self.config.max_decode_tokens:
            cap = min(cap, self.config.max_decode_tokens)
        return cap

    def transcribe(self, audio: np.ndarray | str,
                   sample_rate: int | None = None,
                   word_timestamps: bool = False,
                   language: str | None = None) -> list[TranscriptSegment]:
        if not self.is_loaded:
            self.load()
        self.timings = {"mel_s": 0.0, "encode_s": 0.0, "decode_s": 0.0,
                        "decode_steps": 0, "windows": 0, "batches": 0}
        wav, sr = decode_audio(audio, sample_rate)
        if wav.size == 0:
            return []
        step = int(round(self.window_seconds * sr))
        windows: list[tuple[float, np.ndarray]] = []
        for start in range(0, len(wav), step):
            seg = wav[start: start + step]
            if seg.size >= int(0.2 * sr):  # skip sub-200ms tails
                windows.append((start / sr, seg))
        if not windows:
            return []

        lang = language or self.config.language or "en"
        try:
            lang_off = language_offset(lang)
        except ValueError:
            lang, lang_off = "en", 0

        segments: list[TranscriptSegment] = []
        bs = self.config.window_batch_size
        pad_to = bs if len(windows) > bs else None
        for i in range(0, len(windows), bs):
            segments.extend(self._transcribe_batch(
                windows[i: i + bs], lang, lang_off, pad_to))
        if word_timestamps:
            for seg in segments:
                seg.words = interpolate_words(seg)
        return segments

    def transcribe_with_words(self, audio: np.ndarray | str,
                              sample_rate: int | None = None,
                              **kw: Any) -> list[TranscriptSegment]:
        return self.transcribe(audio, sample_rate, word_timestamps=True, **kw)

    # -- internals ---------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _transcribe_batch(self, windows: list[tuple[float, np.ndarray]],
                          lang: str, lang_off: int,
                          pad_to: int | None) -> list[TranscriptSegment]:
        n_real = len(windows)
        B = max(pad_to or 0, n_real)  # zero windows pad the tail batch
        n_samples = 2 * self.dims.n_audio_ctx * HOP_LENGTH
        win = np.zeros((B, n_samples), np.float32)
        for j, (_, seg) in enumerate(windows):
            win[j, : min(len(seg), n_samples)] = seg[:n_samples]

        t0 = time.perf_counter()
        mel = log_mel_batch(torch.from_numpy(win).to(self.device),
                            n_mels=self.dims.n_mels)
        self._sync()
        t1 = time.perf_counter()
        enc = encode(self._params, self.dims, mel, dtype=self.dtype)
        self._sync()
        t2 = time.perf_counter()

        st = self.tokens
        prompt = np.tile(np.array([[st.sot, st.lang_base + lang_off,
                                    st.transcribe, st.no_timestamps]],
                                  np.int64), (B, 1))
        P = prompt.shape[1]
        toks, avg_lp, no_speech, steps = self._decode(
            enc, torch.from_numpy(prompt).to(self.device))
        tokens = toks.cpu().numpy()
        avg_lp = avg_lp.cpu().numpy()
        no_speech = no_speech.cpu().numpy()
        t3 = time.perf_counter()
        self.timings["mel_s"] += t1 - t0
        self.timings["encode_s"] += t2 - t1
        self.timings["decode_s"] += t3 - t2
        self.timings["decode_steps"] += steps
        self.timings["windows"] += n_real
        self.timings["batches"] += 1

        # Whisper's no-speech gate: high p(no_speech) AND low confidence
        silent = ((no_speech > self.config.no_speech_threshold)
                  & (avg_lp < self.config.logprob_threshold))
        out: list[TranscriptSegment] = []
        for j, (t0w, seg_audio) in enumerate(windows):
            if silent[j]:
                continue
            text_ids = self._strip_special(tokens[j], P)
            dur = len(seg_audio) / SAMPLE_RATE
            segs = self._tokens_to_segments(text_ids, t0w, dur, lang)
            for s in segs:
                s.avg_logprob = round(float(avg_lp[j]), 4)
            out.extend(segs)
        return out

    def _decode(self, enc: torch.Tensor, prompt: torch.Tensor):
        """(tokens, avg_logprob, no_speech_prob, loop iterations) of the
        configured strategy."""
        c, st = self.config, self.tokens
        B, P = prompt.shape
        max_new = min(self._max_new(), self.dims.n_text_ctx - P)
        common = dict(dtype=self.dtype,
                      cross_kv_quantize=bool(self.cross_kv_bits),
                      cross_kv_bits=self.cross_kv_bits or 8,
                      decoder_q8=self._params_q8)
        if c.decode == "beam":
            toks, steps = beam_decode(
                self._params, self.dims, enc, prompt, max_new, st.eot,
                beam_size=c.beam_size, **common)
            zeros = torch.zeros((B,), device=enc.device)
            return toks, zeros, zeros, steps
        if c.speculative_k > 0 and P <= 16:
            return speculative_greedy_decode(
                self._params, self.dims, enc, prompt, max_new, st.eot,
                spec_k=c.speculative_k, no_speech_id=st.no_speech, **common)
        toks, avg_lp, no_speech = greedy_decode(
            self._params, self.dims, enc, prompt, max_new, st.eot,
            no_speech_id=st.no_speech, self_kv_int8=c.self_kv_int8, **common)
        return (toks, avg_lp, no_speech,
                _loop_steps(toks.cpu().numpy(), P, st.eot))

    def _strip_special(self, ids: np.ndarray, prompt_len: int) -> list[int]:
        """Drop the prompt and control tokens ([eot, timestamp_base));
        keep text and timestamp tokens; stop at EOT."""
        st = self.tokens
        keep: list[int] = []
        for i in ids.tolist()[prompt_len:]:
            if i == st.eot:
                break
            if st.eot <= i < st.timestamp_base:
                continue
            keep.append(i)
        return keep

    def _tokens_to_segments(self, ids: list[int], t0: float, dur: float,
                            lang: str) -> list[TranscriptSegment]:
        """Split on timestamp-token pairs when present, else one segment."""
        st = self.tokens
        segs: list[tuple[float, float, list[int]]] = []
        cur_start: float | None = None
        cur: list[int] = []
        for i in ids:
            if i >= st.timestamp_base:
                ts = (i - st.timestamp_base) * 0.02
                if cur_start is None:
                    cur_start = ts
                else:
                    segs.append((cur_start, ts, cur))
                    cur_start, cur = None, []
            else:
                cur.append(i)
        if cur:
            segs.append((cur_start or 0.0, dur, cur))
        out = []
        for s, e, toks in segs:
            if not toks:
                continue
            text = self._decode_text(toks).strip()
            if not text:
                continue
            out.append(TranscriptSegment(
                text=text,
                start=round(t0 + s, 3),
                end=round(t0 + min(e, dur), 3),
                language=lang,
            ))
        return out


def _loop_steps(tokens: np.ndarray, prompt_len: int, eot: int) -> int:
    """Decode-loop iterations :func:`greedy_decode` ran for these tokens:
    it stops once every row has emitted EOT or the buffer is full."""
    total = tokens.shape[1]
    last = prompt_len
    for row in tokens:
        hits = np.nonzero(row[prompt_len:] == eot)[0]
        last = max(last, prompt_len + int(hits[0]) if hits.size else total - 1)
    return last - prompt_len


def interpolate_words(seg: TranscriptSegment) -> list[Word]:
    """Evenly distributed word times inside a segment (the JAX backend's
    ``_interpolate_words``, used when DTW timestamps are off)."""
    parts = seg.text.split()
    if not parts:
        return []
    step = seg.duration / len(parts)
    return [
        Word(text=w, start=round(seg.start + k * step, 3),
             end=round(seg.start + (k + 1) * step, 3), speaker=seg.speaker)
        for k, w in enumerate(parts)
    ]
