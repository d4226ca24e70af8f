"""Batched-window Whisper ASR backend of the port.

Counterpart of ``audio_rag_tpu/asr/whisper_jax.py``: decode → VAD speech
spans (``vad_filter``, :mod:`audio_rag_tpu_torch.asr.vad`) → slice each
span into windows of the model's audio context → log-mel of a window batch
→ encode → decode of all windows of the batch at once → strip special
tokens, no-speech gate, segments → with word timestamps, one teacher-forced
decoder pass over the decoded tokens collecting the head-averaged
cross-attention of the upper decoder layers, and DTW word times
(:mod:`audio_rag_tpu_torch.asr.word_timing`) that also widen each segment's
bounds; segments that get no words take evenly spread ones. The parameters
come from ``checkpoint_path`` (a converted checkpoint,
``{checkpoint_path}/whisper.safetensors``; a missing one warns and falls
through, as in the JAX backend), else the committed asset for "tiny-synth"
and a seeded init for the other presets; ``compute_type="bfloat16"``
stores and computes in bf16 (each leaf cast once from its stored dtype);
the quantization switches of ``ASRConfig`` pick the decode profile as the
JAX backend does (int4 beats int8; ``lm_head_int4`` only with
``decoder_int8`` and without ``decoder_int4``; ``self_kv_int8``), and with
it the quantized decode kernels; the alignment pass always runs on the
full-precision weights and unquantized cross K/V, as the JAX backend's
does. The decode strategy is chosen as the JAX backend's ``_program``
chooses it: beam search under ``decode="beam"`` (its avg-logprob and
no-speech probability are 0, so the no-speech gate never drops a window);
else speculative greedy under ``speculative_k > 0`` with a prompt of ≤ 16
tokens; else greedy. Beam and speculative ignore ``self_kv_int8``.

Under greedy decoding the temperature-fallback ladder
(``temperature_fallback``) decodes the whole padded batch again at each of
``fallback_temperatures`` while a real window still fails a quality gate
(average log-probability below ``logprob_threshold``, or its text
compressing more than ``compression_ratio_threshold`` times); only the
failing rows take the sampled tokens (a row's sample depends on the batch
size, so the batch stays whole). The retries sample plain greedy with
JAX's PRNG seeded ``int(temperature * 100)``, never speculative or beam.
Pad rows never start a retry: their tokens are dropped either way. With no
language given, a vocabulary of 51,865 tokens or more detects one from
the first window (:meth:`WhisperASR.detect_language`); an unknown code
falls back to "en" with a warning. ``condition_on_previous_text`` decodes
the windows one at a time, each prompt ``<|startofprev|>`` + the tokens
decoded since the last reset (cut down to a bucket length) + the SOT
sequence. Not ported here: the HF tokenizer's word map (without one every
token is a word, as in the JAX backend).

The streaming mux's path: :meth:`WhisperASR.transcribe_chunk_batch` runs
short independent chunks (different sessions' audio) as one window batch,
each row with its own language token; a chunk without a language detects
its own, all such rows in one :meth:`WhisperASR.detect_language_rows`
call.
"""

from __future__ import annotations

import logging
import time
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch

from audio_rag_tpu_torch.asr.vad import (
    VADOptions,
    speech_segments,
    speech_segments_batch,
)
from audio_rag_tpu_torch.asr.word_timing import attention_to_word_times
from audio_rag_tpu_torch.audio.io import decode_audio
from audio_rag_tpu_torch.checkpoint import (
    ASSETS_DIR,
    host_tree,
    load_npz_asset,
    restore_params,
)
from audio_rag_tpu_torch.config import ASRConfig
from audio_rag_tpu_torch.core.exceptions import TranscriptionError
from audio_rag_tpu_torch.core.types import TranscriptSegment, Word
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.engine.engine import get_engine, peek_engine
from audio_rag_tpu_torch.models.whisper import (
    WHISPER_LANGUAGES,
    WHISPER_PRESETS,
    SpecialTokens,
    WhisperDims,
    beam_decode,
    char_decode,
    cross_kv_layer,
    decoder_forward,
    detect_language,
    encode,
    greedy_decode,
    init_whisper,
    language_offset,
    quantize_decoder_weights,
    speculative_greedy_decode,
)
from audio_rag_tpu_torch.ops import random as jrandom
from audio_rag_tpu_torch.ops.mel import HOP_LENGTH, SAMPLE_RATE, log_mel_batch
from audio_rag_tpu_torch.resources.estimates import whisper_gb
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.text.tokenizer import refuse_tokenizer_files
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.weights import whisper_params

log = logging.getLogger(__name__)

__all__ = ["WhisperASR", "interpolate_words", "compression_ratio"]

MAX_NEW_TOKENS = 224  # ≤ n_text_ctx/2, as Whisper decodes per window
N_SAMPLES = 30 * SAMPLE_RATE  # the audio language detection reads


class WhisperASR:
    """Batched-window Whisper on one device.

    ``timings`` accumulates, per :meth:`transcribe` (or
    :meth:`transcribe_chunk_batch`) call, host-clock seconds
    of the VAD, language detection, mel, encode, decode and word-alignment
    stages (each ends in a device synchronize or a copy to the host on
    CUDA; ``align_s`` is the teacher-forced pass and the host's word
    times, ``dtw_s`` the host's part alone: median filter, DTW and path
    walk), the decode-loop iterations run (greedy
    steps, beam steps or speculative verify passes) and the windows and
    batches seen; the fallback ladder's sampled decodes are counted apart
    (``fallback_decodes``, ``fallback_steps``, ``fallback_s``).
    ``window_temps`` holds each real window's final temperature (0.0
    unless the ladder replaced its tokens), in order.
    """

    def __init__(self, config: ASRConfig | None = None,
                 device: str | torch.device = "cuda",
                 weights: dict | str | Path | None = None):
        """``weights``: a Whisper tree (``init_whisper``'s layout, numpy
        arrays or tensors) or the path of an ``.npz`` asset, in place of
        what ``load`` reads by default (``checkpoint_path``, the committed
        asset for tiny-synth, seeded weights otherwise): a freshly trained
        tree."""
        self.config = config or ASRConfig()
        self._weights = weights
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
        #: the manager's booking: the stored weights and the quantized
        #: decoder copies (resources/estimates.py)
        self.hbm_required_gb = whisper_gb(self.dims, self.dtype,
                                          self.decoder_bits,
                                          self.lm_head_bits)
        self._params = None
        self._params_q8 = None
        self.timings: dict[str, float] = {}
        self.window_temps: list[float] = []
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
        ckpt = self.config.checkpoint_path
        # the JAX backend decodes with them (WhisperTokenizer)
        refuse_tokenizer_files(ckpt)
        rm = get_resource_manager()
        rm.ensure_hbm(self.hbm_required_gb, for_model="asr")
        tree = None
        if isinstance(self._weights, dict):
            tree = host_tree(self._weights)
        elif self._weights is not None:
            tree = load_npz_asset(self._weights)
            if tree is None:
                raise TranscriptionError(
                    f"Whisper weights {str(self._weights)!r} not found")
        elif ckpt and (tree := restore_params(ckpt, "whisper")) is None:
            log.warning("checkpoint %s missing whisper params; falling "
                        "back", ckpt)
        if tree is None and self._weights is None \
                and self.config.model_size == "tiny-synth":
            tree = load_npz_asset(ASSETS_DIR / "asr_tiny_synth.npz")
            if tree is None:
                raise TranscriptionError("asr_tiny_synth.npz asset missing")
        if tree is not None:
            params = whisper_params(tree, self.dims, self.device,
                                    dtype=self.dtype)
        else:
            params = init_whisper(self.dims, seed=self.config.seed,
                                  device=self.device, dtype=self.dtype)
        q8 = None
        if self.decoder_bits:
            q8 = quantize_decoder_weights(
                params, self.dims, self.decoder_bits, self.lm_head_bits)
        get_engine(self.device).put_params("whisper", {"params": params,
                                                       "q8": q8})
        self._params, self._params_q8 = params, q8
        rm.register_model("asr", self.hbm_required_gb, self)

    def unload(self) -> None:
        """Drop the weights (the engine's record and the manager's booking
        too); the next use loads them again."""
        if not self.is_loaded:
            return
        engine = peek_engine()
        if engine is not None:
            engine.drop_params("whisper")
        self._params = self._params_q8 = None
        get_resource_manager().unregister("asr")

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

    @timed
    def transcribe(self, audio: np.ndarray | str,
                   sample_rate: int | None = None,
                   word_timestamps: bool = False,
                   language: str | None = None) -> list[TranscriptSegment]:
        if not self.is_loaded:
            self.load()
        get_resource_manager().touch("asr")
        self._reset_timings()
        wav, sr = decode_audio(audio, sample_rate)
        if wav.size == 0:
            return []
        c = self.config
        if c.vad_filter:  # transcribe the speech spans only
            t0 = time.perf_counter()
            spans = speech_segments(wav, sr, VADOptions(
                backend=c.vad_backend, threshold=c.vad_threshold),
                device=self.device)
            self.timings["vad_s"] = time.perf_counter() - t0
            if not spans:
                return []
        else:
            spans = [(0.0, len(wav) / sr)]
        windows = self._split_windows(wav, spans)
        if not windows:
            return []

        lang = language or c.language
        lang_off = 0
        if lang:
            try:
                lang_off = language_offset(lang)
            except ValueError:
                log.warning("unknown language %r; defaulting to en", lang)
                lang = "en"
        elif self.dims.n_vocab >= 51865:
            # detected from the first 30 s of the file, as the JAX backend
            t0 = time.perf_counter()
            lang_off, prob = self.detect_language(wav[:N_SAMPLES], sr)
            self.timings["detect_s"] = time.perf_counter() - t0
            lang = WHISPER_LANGUAGES[lang_off]
            log.info("detected language %s (p=%.2f)", lang, prob)
        else:
            lang = "en"

        if c.condition_on_previous_text:
            segments = self._transcribe_conditioned(
                windows, lang, lang_off, want_words=word_timestamps)
        else:
            segments = []
            bs = c.window_batch_size
            pad_to = bs if len(windows) > bs else None
            for i in range(0, len(windows), bs):
                segments.extend(self._transcribe_batch(
                    windows[i: i + bs], lang, lang_off, pad_to,
                    want_words=word_timestamps))
        if word_timestamps:
            for seg in segments:
                if not seg.words:
                    seg.words = interpolate_words(seg)
        return segments

    @torch.inference_mode()
    def detect_language(self, audio: np.ndarray | str,
                        sample_rate: int | None = None) -> tuple[int, float]:
        """(language offset from ``<|en|>``, its probability) of the
        audio's first window: zero-padded or cut to the model's window,
        its log-mel, the encoder, one decoder step over ``<|sot|>``."""
        if not self.is_loaded:
            self.load()
        wav, _ = decode_audio(audio, sample_rate)
        n = 2 * self.dims.n_audio_ctx * HOP_LENGTH
        window = np.zeros((1, n), np.float32)
        window[0, : min(len(wav), n)] = wav[:n]
        mel = log_mel_batch(torch.from_numpy(window).to(self.device),
                            n_mels=self.dims.n_mels)
        enc = encode(self._params, self.dims, mel, dtype=self.dtype)
        lang, prob = detect_language(self._params, self.dims, enc,
                                     self.tokens, self.dtype)
        return int(lang[0]), float(prob[0])

    @torch.inference_mode()
    def detect_language_rows(self, rows: list[np.ndarray],
                             pad_to: int | None = None) -> list[int]:
        """Language offsets of many 16 kHz audio rows in one batch, each
        row detected on its own audio: zero-padded or cut to one model
        window, its log-mel, the encoder, one decoder step over
        ``<|sot|>``. The batch is ``pad_to`` rows when that holds them,
        else the next power of two."""
        if not self.is_loaded:
            self.load()
        n = 2 * self.dims.n_audio_ctx * HOP_LENGTH
        R = len(rows)
        B = pad_to if pad_to and pad_to >= R else 1 << (R - 1).bit_length()
        clips = np.zeros((B, n), np.float32)
        for j, w in enumerate(rows):
            clips[j, : min(len(w), n)] = w[:n]
        mel = log_mel_batch(torch.from_numpy(clips).to(self.device),
                            n_mels=self.dims.n_mels)
        enc = encode(self._params, self.dims, mel, dtype=self.dtype)
        lang, _ = detect_language(self._params, self.dims, enc, self.tokens,
                                  self.dtype)
        return [int(v) for v in lang[:R].tolist()]

    @torch.inference_mode()
    @timed
    def transcribe_chunk_batch(self, chunks: list[np.ndarray],
                               sample_rate: int | None = None,
                               word_timestamps: bool = False,
                               language: str | list[str | None] | None = None,
                               pad_to: int | None = None
                               ) -> list[list[TranscriptSegment]]:
        """Independent chunks of at most about one window (live sessions'
        audio) as one window batch: one segment list per chunk, times
        relative to the chunk, an empty list where the VAD or the
        no-speech gate dropped it.

        Rows are each chunk's speech spans (one VAD call over all chunks
        under ``vad_filter``) cut into windows as :meth:`transcribe` cuts
        them. When they outnumber ``pad_to``, each chunk collapses to its
        spans' envelope cut to one window, so the batch keeps its size.
        ``language`` is one code for all chunks or one per chunk (None:
        the config's); unknown codes become "en"; rows still without one
        detect their own on vocabularies of 51,865 tokens or more
        (:meth:`detect_language_rows`, one batch), else take "en". The
        batch is ``pad_to`` rows when that holds them, else the next power
        of two. :attr:`timings` is set as :meth:`transcribe` sets it."""
        if not self.is_loaded:
            self.load()
        get_resource_manager().touch("asr")
        self._reset_timings()
        wavs = [decode_audio(c, sample_rate)[0] for c in chunks]
        outs: list[list[TranscriptSegment]] = [[] for _ in wavs]
        c = self.config
        if c.vad_filter:  # one VAD call set over every chunk
            t0 = time.perf_counter()
            all_spans = speech_segments_batch(wavs, SAMPLE_RATE, VADOptions(
                backend=c.vad_backend, threshold=c.vad_threshold),
                device=self.device)
            self.timings["vad_s"] = time.perf_counter() - t0
        else:
            all_spans = [[(0.0, len(w) / SAMPLE_RATE)] if len(w) else []
                         for w in wavs]

        def rows_of(spans_per_chunk):
            rows, idx = [], []
            for k, (wav, spans) in enumerate(zip(wavs, spans_per_chunk)):
                for row in self._split_windows(wav, spans):
                    rows.append(row)
                    idx.append(k)
            return rows, idx

        rows, idx = rows_of(all_spans)
        if pad_to and len(rows) > pad_to:
            window_s = self.window_seconds
            rows, idx = rows_of([
                [(s[0][0], min(s[-1][1], s[0][0] + window_s))] if s else []
                for s in all_spans])
        if not rows:
            return outs

        if isinstance(language, list):
            chunk_langs = [lang or c.language for lang in language]
        else:
            chunk_langs = [language or c.language] * len(wavs)
        langs: list = [chunk_langs[k] for k in idx]
        offs = [0] * len(rows)
        to_detect = []
        for j, lang in enumerate(langs):
            if not lang:
                to_detect.append(j)
                continue
            try:
                offs[j] = language_offset(lang)
            except ValueError:
                log.warning("unknown language %r; defaulting to en", lang)
                langs[j] = "en"
        if to_detect and self.dims.n_vocab >= 51865:
            t0 = time.perf_counter()
            det = self.detect_language_rows(
                [rows[j][1] for j in to_detect],
                pad_to=pad_to if pad_to and pad_to >= len(to_detect)
                else None)
            self.timings["detect_s"] = time.perf_counter() - t0
            for j, off in zip(to_detect, det):
                offs[j] = off
                langs[j] = WHISPER_LANGUAGES[off]
            log.info("detected languages %s",
                     sorted({langs[j] for j in to_detect}))
        else:
            for j in to_detect:
                langs[j] = "en"

        B = (pad_to if pad_to and pad_to >= len(rows)
             else 1 << (len(rows) - 1).bit_length())
        per_row = self._transcribe_batch(rows, langs, offs, B,
                                         want_words=word_timestamps,
                                         grouped=True)
        for k, segs in zip(idx, per_row):
            if word_timestamps:
                for seg in segs:
                    if not seg.words:
                        seg.words = interpolate_words(seg)
            outs[k].extend(segs)  # a chunk of 2+ spans has 2+ rows
        return outs

    def transcribe_with_words(self, audio: np.ndarray | str,
                              sample_rate: int | None = None,
                              **kw: Any) -> list[TranscriptSegment]:
        return self.transcribe(audio, sample_rate, word_timestamps=True, **kw)

    # -- internals ---------------------------------------------------------
    def _reset_timings(self) -> None:
        self.timings = {"vad_s": 0.0, "detect_s": 0.0, "mel_s": 0.0,
                        "encode_s": 0.0, "decode_s": 0.0, "align_s": 0.0,
                        "dtw_s": 0.0, "decode_steps": 0, "windows": 0,
                        "batches": 0, "fallback_decodes": 0,
                        "fallback_steps": 0, "fallback_s": 0.0}
        self.window_temps = []

    def _split_windows(self, wav: np.ndarray,
                       spans: list[tuple[float, float]]
                       ) -> list[tuple[float, np.ndarray]]:
        """Each (start_s, end_s) span of 16 kHz ``wav`` cut into windows of
        the model's audio context on integer sample indices: (offset_s,
        samples) pairs; tails under 200 ms are dropped."""
        step = 2 * self.dims.n_audio_ctx * HOP_LENGTH
        windows = []
        for s, e in spans:
            s_idx = int(round(s * SAMPLE_RATE))
            e_idx = min(int(round(e * SAMPLE_RATE)), len(wav))
            for start in range(s_idx, e_idx, step):
                seg = wav[start: min(start + step, e_idx)]
                if seg.size >= int(0.2 * SAMPLE_RATE):
                    windows.append((start / SAMPLE_RATE, seg))
        return windows

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prompt_buckets(self) -> list[int]:
        """History lengths a conditioned prompt may carry: the history is
        cut DOWN to one of these, as the JAX backend cuts it (up to
        faster-whisper's cap of n_text_ctx/2 − 1 tokens)."""
        cap = self.dims.n_text_ctx // 2 - 1
        return sorted({b for b in (4, 8, 16, 32, 64, 128, cap) if b <= cap})

    def _transcribe_conditioned(self, windows: list[tuple[float, np.ndarray]],
                                lang: str, lang_off: int, want_words: bool
                                ) -> list[TranscriptSegment]:
        """``condition_on_previous_text``: windows one at a time, each
        prompted with ``<|startofprev|>`` + the last bucket's worth of the
        tokens decoded since the last reset; a window whose final
        temperature exceeds ``prompt_reset_on_temperature`` resets the
        history."""
        cap = self.dims.n_text_ctx // 2 - 1
        buckets = self._prompt_buckets()
        history: list[int] = []
        reset_since = 0
        segments: list[TranscriptSegment] = []
        for t0, seg in windows:
            prev = history[reset_since:][-cap:]
            prev_ids = None
            if prev:
                b = max((b for b in buckets if b <= len(prev)), default=None)
                if b:
                    prev_ids = prev[-b:]
            segs, meta = self._transcribe_batch(
                [(t0, seg)], lang, lang_off, None, want_words=want_words,
                prev_ids=prev_ids, return_meta=True)
            segments.extend(segs)
            history.extend(meta["clean_ids"][0])
            if float(meta["final_temp"][0]) > \
                    self.config.prompt_reset_on_temperature:
                reset_since = len(history)
        return segments

    @torch.inference_mode()
    def _transcribe_batch(self, windows: list[tuple[float, np.ndarray]],
                          lang: str | list[str], lang_off: int | list[int],
                          pad_to: int | None, want_words: bool = False,
                          prev_ids: list[int] | None = None,
                          return_meta: bool = False, grouped: bool = False):
        """Segments of a window batch (``grouped``: one list per window);
        with ``return_meta`` also ``{"clean_ids", "final_temp"}`` per
        window (the conditioned path's history and reset rule).
        ``lang``/``lang_off`` are one language for all windows or one per
        window. ``prev_ids`` (one window) puts ``<|startofprev|>`` + them
        before the SOT sequence."""
        n_real = len(windows)
        langs = lang if isinstance(lang, list) else [lang] * n_real
        offs = lang_off if isinstance(lang_off, list) else [lang_off] * n_real
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
        sot_seq = [st.sot, st.lang_base, st.transcribe, st.no_timestamps]
        if prev_ids:
            if B != 1:
                raise ValueError("conditioned prompts run one window")
            prompt = np.array([[st.sot_prev, *prev_ids, *sot_seq]], np.int64)
        else:
            prompt = np.tile(np.array([sot_seq], np.int64), (B, 1))
        P = prompt.shape[1]
        for j in range(n_real):  # per-row language (pad rows: en)
            prompt[j, P - 3] = st.lang_base + offs[j]
        prompt_t = torch.from_numpy(prompt).to(self.device)
        toks, avg_lp, no_speech, steps = self._decode(enc, prompt_t)
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

        # the fallback ladder: retry the whole batch at each temperature
        # while a real window fails a gate; failing rows take the retry's
        # tokens whether they pass or not
        final_temp = np.zeros(B, np.float32)
        c = self.config
        if c.temperature_fallback and c.decode == "greedy":
            failed = self._gates_failed(tokens, avg_lp, P)
            failed[n_real:] = False
            for temp in c.fallback_temperatures:
                if not failed.any():
                    break
                t4 = time.perf_counter()
                t_toks, t_lp, _, t_steps = self._decode(enc, prompt_t,
                                                        float(temp))
                t_toks, t_lp = t_toks.cpu().numpy(), t_lp.cpu().numpy()
                self.timings["fallback_s"] += time.perf_counter() - t4
                self.timings["fallback_decodes"] += 1
                self.timings["fallback_steps"] += t_steps
                tokens[failed] = t_toks[failed]
                avg_lp[failed] = t_lp[failed]
                final_temp[failed] = temp
                failed &= self._gates_failed(tokens, avg_lp, P)
        self.window_temps.extend(float(t) for t in final_temp[:n_real])

        # Whisper's no-speech gate: high p(no_speech) AND low confidence
        silent = ((no_speech > c.no_speech_threshold)
                  & (avg_lp < c.logprob_threshold))

        # word times: one teacher-forced pass over every real row's text
        # tokens (pad rows stay empty so that they do not widen the token
        # bucket), silent rows included, as in the JAX backend
        weights, clean = None, []
        if want_words:
            t4 = time.perf_counter()
            for j in range(B):
                ids = self._strip_special(tokens[j], P) if j < n_real else []
                clean.append([i for i in ids if i < st.timestamp_base])
            weights = self._collect_cross_weights(enc, prompt, clean)
            self.timings["align_s"] += time.perf_counter() - t4

        per_window: list[list[TranscriptSegment]] = []
        clean_ids: list[list[int]] = []
        dtw_before = self.timings["dtw_s"]
        for j, (t0w, seg_audio) in enumerate(windows):
            text_ids = self._strip_special(tokens[j], P)
            clean_ids.append([] if silent[j] else text_ids)
            if silent[j]:
                per_window.append([])
                continue
            dur = len(seg_audio) / SAMPLE_RATE
            segs = self._tokens_to_segments(text_ids, t0w, dur, langs[j])
            for s in segs:
                s.avg_logprob = round(float(avg_lp[j]), 4)
            if weights is not None and segs:
                t4 = time.perf_counter()
                self._apply_word_times(segs, weights[j], clean[j], dur, t0w,
                                       prompt_len=P)
                self.timings["dtw_s"] += time.perf_counter() - t4
            per_window.append(segs)
        self.timings["align_s"] += self.timings["dtw_s"] - dtw_before
        if grouped:
            return per_window
        out = [seg for segs in per_window for seg in segs]
        if return_meta:
            return out, {"clean_ids": clean_ids, "final_temp": final_temp}
        return out

    def _gates_failed(self, tokens: np.ndarray, avg_lp: np.ndarray,
                      prompt_len: int) -> np.ndarray:
        """Per row: True where the average log-probability is below
        ``logprob_threshold`` or the text (without timestamp tokens)
        compresses more than ``compression_ratio_threshold`` times."""
        failed = avg_lp < self.config.logprob_threshold
        thr = self.config.compression_ratio_threshold
        if thr:
            for j in range(tokens.shape[0]):
                if failed[j]:
                    continue
                text = self._decode_text([
                    i for i in self._strip_special(tokens[j], prompt_len)
                    if i < self.tokens.timestamp_base])
                if compression_ratio(text) > thr:
                    failed[j] = True
        return failed

    @torch.inference_mode()
    def _collect_cross_weights(self, enc: torch.Tensor, prompt: np.ndarray,
                               clean: list[list[int]]) -> np.ndarray | None:
        """Teacher-forced decoder pass over the already computed encoder
        states → (B, T, Ta) f32 head-averaged cross weights of the upper
        layers, read back through float16 as the JAX backend reads them.

        The tokens are the prompt and each row's text tokens, padded with
        EOT to a power of two (at most ``n_text_ctx − P``). Each layer's
        cross K/V are computed from ``enc`` inside the layer loop, in the
        compute dtype with the full-precision weights, whatever the decode
        profile."""
        max_t = max((len(c) for c in clean), default=0)
        if max_t == 0:
            return None
        P = prompt.shape[1]
        max_t = min(1 << (max_t - 1).bit_length(), self.dims.n_text_ctx - P)
        toks = np.full((len(clean), P + max_t), self.tokens.eot, np.int64)
        toks[:, :P] = prompt
        for j, c in enumerate(clean):
            c = c[:max_t]
            toks[j, P: P + len(c)] = c
        params, dims, dtype = self._params, self.dims, self.dtype
        _, _, w = decoder_forward(
            params, dims, torch.from_numpy(toks).to(self.device),
            lambda i: cross_kv_layer(params, dims, enc, i, dtype),
            dtype=dtype, collect_cross_weights="alignment_mean")
        return w.to(torch.float16).float().cpu().numpy()

    def _apply_word_times(self, segs: list[TranscriptSegment],
                          weights: np.ndarray, clean_ids: list[int],
                          dur: float, t0: float, prompt_len: int) -> None:
        """DTW word times of one window's text tokens, handed out to its
        segments in order; each segment widens to its words' span."""
        if not clean_ids:
            return
        P = prompt_len
        tok_slice = weights[P: P + len(clean_ids), :]
        n_frames = min(int(dur / 0.02), tok_slice.shape[-1])
        times = attention_to_word_times(
            tok_slice, self._token_word_map(clean_ids), max(n_frames, 1),
            time_offset=t0)
        cursor = 0
        for seg in segs:
            words_text = seg.text.split()
            seg_times = times[cursor: cursor + len(words_text)]
            cursor += len(words_text)
            seg.words = [Word(text=w, start=s, end=e, speaker=seg.speaker)
                         for w, (s, e) in zip(words_text, seg_times)]
            if seg.words:
                seg.start = min(seg.start, seg.words[0].start)
                seg.end = max(seg.end, seg.words[-1].end)

    @staticmethod
    def _token_word_map(ids: list[int]) -> list[int]:
        """Word id of each token: without an HF tokenizer every token is a
        word (on tiny-synth's character vocabulary, word k takes
        character k's time), the JAX backend's fallback."""
        return list(range(len(ids)))

    def _decode(self, enc: torch.Tensor, prompt: torch.Tensor,
                temperature: float = 0.0):
        """(tokens, avg_logprob, no_speech_prob, loop iterations) of the
        configured strategy; at a temperature above 0, plain greedy
        sampled from ``PRNGKey(int(temperature * 100))`` (Python's float
        product and truncation: 0.29 gives 28)."""
        c, st = self.config, self.tokens
        B, P = prompt.shape
        max_new = min(self._max_new(), self.dims.n_text_ctx - P)
        common = dict(dtype=self.dtype,
                      cross_kv_quantize=bool(self.cross_kv_bits),
                      cross_kv_bits=self.cross_kv_bits or 8,
                      decoder_q8=self._params_q8)
        if c.decode == "beam" and temperature <= 0.0:
            toks, steps = beam_decode(
                self._params, self.dims, enc, prompt, max_new, st.eot,
                beam_size=c.beam_size, **common)
            zeros = torch.zeros((B,), device=enc.device)
            return toks, zeros, zeros, steps
        if c.speculative_k > 0 and P <= 16 and temperature <= 0.0:
            return speculative_greedy_decode(
                self._params, self.dims, enc, prompt, max_new, st.eot,
                spec_k=c.speculative_k, no_speech_id=st.no_speech, **common)
        toks, avg_lp, no_speech = greedy_decode(
            self._params, self.dims, enc, prompt, max_new, st.eot,
            no_speech_id=st.no_speech, self_kv_int8=c.self_kv_int8,
            temperature=temperature,
            rng=jrandom.PRNGKey(int(temperature * 100)), **common)
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


def compression_ratio(text: str) -> float:
    """UTF-8 bytes over their zlib-compressed bytes (default level):
    Whisper's repetition gate; 0.0 for empty text."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


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
