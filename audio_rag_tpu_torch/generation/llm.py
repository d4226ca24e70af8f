"""The in-process LLM generator of the port (counterpart of
``audio_rag_tpu/generation/llm_jax.py::LLMGenerator``): prompts become
one batched wave decode (:func:`~audio_rag_tpu_torch.models.llm.
llm_generate`) on the configured device.

The JAX generator's batching is copied exactly: the system prompt joined
ahead of each prompt, each prompt's last ``max_prompt_tokens`` tokens
(and never more than the window less 8), left-padding with EOS to a
power-of-two prompt bucket, ``max_new`` cut to the window with a
``GenerationError`` when nothing is left, a power-of-two batch whose
filler rows copy row 0, one key ``PRNGKey(abs(hash(tuple(texts))) %
2**31)`` per batch (Python's string hash is salted per process, so sampled
answers repeat only within one process), and EOS trimming. One departure:
each answer decodes against its own request's words and the side file's
(``HashWordTokenizer.known_words``), not against every word the tokenizer
has encoded, so the same prompt gives the same text whatever else the
process asked before (a reload after an eviction, the stage-grouped batch
against the per-file loop).
``decoder_int8``/``decoder_int4``/``lm_head_int4`` quantize the decode
step's linears once at load (int4 beating int8). A greedy single-row wave
under ``speculative_k`` runs the speculative program
(:func:`~audio_rag_tpu_torch.models.llm.llm_speculative_generate`, the
same tokens) and leaves its drafter's figures in ``last_spec_stats``, as
the JAX generator does. Weights: ``checkpoint_path``
(``{checkpoint_path}/llm.safetensors`` from ``convert_llama``, at the
preset's shapes), else, for "eval-small", the committed trained asset
(raising when it is missing), else weights seeded on the device;
"eval-small" also reads its tokenizer side file. A failure raises;
nothing falls back.
"""

from __future__ import annotations

import threading
from typing import Iterable

import numpy as np
import torch

from audio_rag_tpu_torch.checkpoint import ASSETS_DIR, restore_params
from audio_rag_tpu_torch.config import GenerationConfig
from audio_rag_tpu_torch.core.exceptions import ConfigError, GenerationError
from audio_rag_tpu_torch.device import resolve_device
from audio_rag_tpu_torch.engine.engine import get_engine, peek_engine
from audio_rag_tpu_torch.engine.scheduler import word_chunks
from audio_rag_tpu_torch.models.llm import (
    LLM_PRESETS,
    LLMDims,
    init_llm,
    llm_generate,
    llm_speculative_generate,
    quantize_llm_weights,
)
from audio_rag_tpu_torch.ops import random as jrandom
from audio_rag_tpu_torch.resources.estimates import llm_gb
from audio_rag_tpu_torch.resources.manager import get_resource_manager
from audio_rag_tpu_torch.text.tokenizer import get_tokenizer, load_reverse_map
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.weights import convert_llm, load_llm_small

__all__ = ["LLMGenerator"]


class LLMGenerator:
    def __init__(self, config: GenerationConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or GenerationConfig()
        self.device = resolve_device(device)
        self.model = (self.config.model if self.config.model in LLM_PRESETS
                      else "llama-3.2-3b")
        self.dims: LLMDims = LLM_PRESETS[self.model]
        self.dtype = torch.bfloat16
        # decode-step weight width: int4 > int8 > off; lm_head_int4 narrows
        # the head only
        self._qbits = 4 if self.config.decoder_int4 else (
            8 if self.config.decoder_int8 else 0)
        self._lm_head_bits = 4 if (self._qbits
                                   and self.config.lm_head_int4) else None
        #: the manager's booking: the bf16 weights and the quantized
        #: decode-step copies
        self.hbm_required_gb = llm_gb(self.dims, self.dtype, self._qbits,
                                      self._lm_head_bits)
        self._params = None
        self._params_q8 = None
        self._tok = None
        # guards the (params, q8) pair against an eviction between a
        # reader's load and its read; never held across a manager call
        self._state_lock = threading.Lock()
        #: generated ids per prompt of the last batch, EOS excluded
        self.last_token_counts: list[int] = []
        self.last_token_ids: list[list[int]] = []
        #: the last wave's batch rows, prompt bucket, decode steps (verify
        #: iterations on the speculative path) and prefill / decode seconds
        self.last_stats: dict = {}
        #: the last speculative wave's block verifies, tokens emitted,
        #: tokens per verify and accept rate (None after any other wave)
        self.last_spec_stats: dict | None = None

    @property
    def is_loaded(self) -> bool:
        return self._params is not None

    def load(self) -> None:
        if self.is_loaded:
            return
        ckpt = self.config.checkpoint_path
        tok = get_tokenizer(ckpt, vocab_size=self.dims.vocab)
        rm = get_resource_manager()
        rm.ensure_hbm(self.hbm_required_gb, for_model="generation")
        tree = restore_params(ckpt, "llm") if ckpt else None
        if tree is not None:
            params = convert_llm(tree, self.dims, self.device, self.dtype)
        elif self.model == "eval-small":
            params = load_llm_small(self.device, self.dtype)
            if params is None:
                raise ConfigError(
                    "the trained eval-small generator's asset "
                    "(audio_rag_tpu/assets/llm_small.npz) is missing",
                    context={"model": "eval-small"})
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.config.seed)
            params = init_llm(self.dims, gen, self.dtype)
        q8 = None
        if self._qbits:
            q8 = quantize_llm_weights(params, self.dims, self._qbits,
                                      lm_head_bits=self._lm_head_bits)
        if self.model == "eval-small":
            # the trained asset's emittable words: a fresh process decodes
            # only ids it has encoded without them
            load_reverse_map(tok, ASSETS_DIR / "llm_small_vocab.json")
        get_engine(self.device).put_params("llm", {"params": params,
                                                   "q8": q8})
        with self._state_lock:
            self._tok, self._params_q8, self._params = tok, q8, params
        rm.register_model("generation", self.hbm_required_gb, self)

    def unload(self) -> None:
        """Drop the weights (the engine's record and the manager's booking
        too); the tokenizer, host memory, stays. A wave that already read
        the weights keeps them until it ends."""
        with self._state_lock:
            if self._params is None:
                return
            self._params = self._params_q8 = None
        engine = peek_engine()
        if engine is not None:
            engine.drop_params("llm")
        get_resource_manager().unregister("generation")

    def resident(self) -> tuple:
        """(params, quantized copies) after loading them if needed, read
        as one pair: an eviction in between makes it load again."""
        while True:
            self.load()
            with self._state_lock:
                if self._params is not None:
                    pair = self._params, self._params_q8
                    break
        get_resource_manager().touch("generation")
        return pair

    def check_availability(self) -> bool:
        return self.is_loaded

    @timed
    def generate(self, prompt: str, system: str | None = None,
                 max_tokens: int | None = None,
                 temperature: float | None = None) -> str:
        return self.generate_batch([prompt], system=system,
                                   max_tokens=max_tokens,
                                   temperature=temperature)[0]

    @timed
    def generate_batch(self, prompts: list[str], system: str | None = None,
                       max_tokens: int | None = None,
                       temperature: float | None = None) -> list[str]:
        """Decode the prompts as one wave; answers in prompt order."""
        params, params_q8 = self.resident()
        if not prompts:
            return []
        texts = [f"{system}\n\n{p}" if system else p for p in prompts]
        cap = min(self.config.max_prompt_tokens, self.dims.max_len - 8)
        seqs = [self._tok.encode(t)[-cap:] for t in texts]
        max_p = max(len(s) for s in seqs)
        P = min(1 << (max_p - 1).bit_length(), cap)  # pow-2 prompt bucket
        pad_id = self._tok.eos_id
        batch = np.full((len(seqs), P), pad_id, np.int64)
        mask = np.zeros((len(seqs), P), bool)
        for i, s in enumerate(seqs):  # left-padded: every row ends at P
            s = s[-P:]
            batch[i, P - len(s):] = s
            mask[i, P - len(s):] = True
        max_new = min(max_tokens or self.config.max_tokens,
                      self.dims.max_len - P - 1)
        if max_new <= 0:
            raise GenerationError(
                "prompt exhausts the context window",
                context={"prompt_tokens": max_p,
                         "max_len": self.dims.max_len})
        temp = self.config.temperature if temperature is None else temperature
        # pow-2 batch bucket; filler rows copy row 0 (an all-pad row would
        # softmax over nothing) and are dropped
        B = len(seqs)
        B_pad = 1 << (B - 1).bit_length()
        if B_pad != B:
            batch = np.concatenate([batch, np.tile(batch[:1], (B_pad - B, 1))])
            mask = np.concatenate([mask, np.tile(mask[:1], (B_pad - B, 1))])
        stats: dict = {}
        prompt_t = torch.from_numpy(batch).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        # speculation pays only where the weight read is not shared by
        # other rows: greedy single-row waves
        spec_k = self.config.speculative_k
        spec = temp <= 0.0 and spec_k > 0 and B_pad == 1
        if spec:
            out, n_iter = llm_speculative_generate(
                params, self.dims, prompt_t, max_new, pad_id,
                spec_k=spec_k, dtype=self.dtype, prompt_mask=mask_t,
                decoder_q8=params_q8, stats=stats)
        else:
            out = llm_generate(
                params, self.dims, prompt_t, max_new, pad_id,
                temperature=float(temp),
                rng=jrandom.PRNGKey(abs(hash(tuple(texts))) % (2 ** 31)),
                dtype=self.dtype, prompt_mask=mask_t,
                decoder_q8=params_q8, stats=stats)
        out = out.cpu().numpy()
        results, counts, ids = [], [], []
        for i in range(B):
            gen = out[i, P:]
            eos = np.nonzero(gen == pad_id)[0]
            if eos.size:
                gen = gen[:eos[0]]
            counts.append(int(gen.size))
            ids.append(gen.tolist())
            # the row's own words (and the side file's): the same prompt
            # gives the same text whatever else the tokenizer has seen
            results.append(self._tok.decode(
                gen.tolist(), self._tok.known_words(texts[i])).strip())
        self.last_token_counts = counts
        self.last_token_ids = ids
        self.last_stats = {"rows": B_pad, "prompt_bucket": P, **stats}
        self.last_spec_stats = None
        if spec:
            n_iter = max(n_iter, 1)
            tpv = max(counts[0] - 1, 0) / n_iter
            self.last_spec_stats = {
                "block_verifies": n_iter, "tokens_emitted": counts[0],
                "tokens_per_verify": round(tpv, 3),
                "accept_rate": round(max(tpv - 1.0, 0.0)
                                     / max(spec_k - 1, 1), 4)}
        return results

    def generate_stream(self, prompt: str, system: str | None = None,
                        max_tokens: int | None = None,
                        temperature: float | None = None) -> Iterable[str]:
        return word_chunks(self.generate(prompt, system, max_tokens,
                                         temperature))
