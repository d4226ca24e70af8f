"""The continuous batcher of the port (counterpart of
``audio_rag_tpu/engine/continuous.py::ContinuousBatcher``): slot-based
LLM decode where requests join and leave at segment boundaries, so a short
request never waits for a long one to finish, and each request can stream
its text as segments complete.

The device keeps ``n_slots`` decode slots over one shared (L, slots, HKV,
C, hd) bf16 cache, and a worker thread alternates:

1. **admit**: every waiting request that finds a free slot is prefilled in
   one call (:func:`~audio_rag_tpu_torch.models.llm.llm_prefill_slots`):
   prompts cut to their last C - 8 tokens, right-padded to a power-of-two
   bucket, the rows padded to a power of two by repeating row 0, each
   row's first token picked on the device and read back as R integers;
2. **decode a segment**: every live slot advances ``segment_tokens``
   steps at its own position and temperature
   (:func:`~audio_rag_tpu_torch.models.llm.llm_decode_slots`, no host
   read inside), and the tokens and new positions come back packed in one
   (slots, segment + 1) array — one readback a segment.

Requests leave at EOS, at their ``max_tokens`` or when the cache is full,
and a new one takes the slot at the next boundary. The JAX batcher's
options are kept: adaptive segments (``idle_segment_tokens`` steps while
nobody waits and every slot has that much room), speculative segments
(``spec_k`` > 0: :func:`~audio_rag_tpu_torch.models.llm.
llm_decode_slots_spec` drafting from each slot's last ``SPEC_HISTORY``
tokens; off by default) and pipelined segments (``pipeline_segments``: the
next segment is issued from the current one's device outputs before its
readback, which runs as an asynchronous copy; off by default). Keys:
``PRNGKey(n)`` with n counting admissions and segments, as in the JAX
batcher. A failed admission fails its requests; a failed segment fails
every live request (``_fail_all``); nothing falls back.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from audio_rag_tpu_torch.models.llm import (
    llm_decode_slots,
    llm_decode_slots_spec,
    llm_prefill_slots,
    upload,
)
from audio_rag_tpu_torch.ops import random as jrandom

__all__ = ["ContinuousBatcher", "SPEC_HISTORY"]

#: tokens of each slot's prompt and output shipped to a speculative
#: segment for the drafter to copy from
SPEC_HISTORY = 256


@dataclass
class _Request:
    prompt: str
    system: str | None
    max_tokens: int | None
    temperature: float | None
    future: Future = field(default_factory=Future)
    #: called on the worker thread with each new piece of text
    on_delta: object | None = None
    emitted: str = ""

    @property
    def text(self) -> str:
        """What the model reads: the system prompt, then the prompt."""
        return (f"{self.system}\n\n{self.prompt}" if self.system
                else self.prompt)


@dataclass
class _Slot:
    request: _Request
    tokens: list[int]  # generated so far
    pos: int  # the next cache frame (the sequence's length so far)
    max_new: int
    last_token: int
    done: bool = False
    #: the prompt's last tokens (the speculative drafter's source)
    history: list[int] | None = None


def _readback(t: torch.Tensor):
    """Start copying ``t`` to the host: (host tensor, event to wait on or
    None). On the card the copy is asynchronous into pinned memory, so
    work issued after it does not delay it."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class ContinuousBatcher:
    """``submit`` / ``generate`` / ``stop`` over a loaded
    :class:`~audio_rag_tpu_torch.generation.llm.LLMGenerator`."""

    def __init__(self, generator, n_slots: int = 8,
                 segment_tokens: int = 16, context_tokens: int = 2048,
                 spec_k: int | None = None,
                 pipeline_segments: bool = False,
                 idle_segment_tokens: int = 0):
        self.generator = generator
        self.n_slots = n_slots
        self.segment = segment_tokens
        self.idle_segment = idle_segment_tokens
        self.ctx = context_tokens
        #: speculative segments (off unless asked for: the generator's
        #: ``speculative_k`` is for single streams)
        self.spec_k = 0 if spec_k is None else spec_k
        self.pipeline = pipeline_segments
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._slots: list[_Slot | None] = [None] * n_slots
        self._cache: tuple[torch.Tensor, torch.Tensor] | None = None
        self._rng_seed = 0
        self._stopped = False
        #: segments read back, requests answered, generated ids delivered
        #: (EOS excluded, capped at each request's max_tokens)
        self.segments_run = 0
        self.requests_served = 0
        self.tokens_generated = 0
        self._thread = threading.Thread(target=self._run,
                                        name="llm-continuous", daemon=True)
        self._thread.start()

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: str, system: str | None = None,
               max_tokens: int | None = None,
               temperature: float | None = None, on_delta=None) -> Future:
        if self._stopped:
            raise RuntimeError("scheduler stopped")
        req = _Request(prompt, system, max_tokens, temperature,
                       on_delta=on_delta)
        self._queue.put(req)
        return req.future

    def generate(self, prompt: str, **kw) -> str:
        return self.submit(prompt, **kw).result()

    def stop(self) -> None:
        """Stop the worker (live and waiting requests fail with "scheduler
        stopped"), join it and free the cache."""
        self._stopped = True
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        self._cache = None

    # -- the worker's steps -------------------------------------------------
    @property
    def _C(self) -> int:
        return min(self.generator.dims.max_len, self.ctx)

    def _temperature(self, req: _Request) -> float:
        t = req.temperature
        return self.generator.config.temperature if t is None else t

    def _ensure_cache(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._cache is None:
            d = self.generator.dims
            shape = (d.n_layers, self.n_slots, d.n_kv_heads, self._C,
                     d.d_model // d.n_heads)
            dev = self.generator.device
            self._cache = (torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev),
                           torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev))
        return self._cache

    def _admit_many(self, reqs: list[_Request], free_slots: list[int]
                    ) -> None:
        """Prefill every request of ``reqs`` into ``free_slots`` in one
        call; rows padded to a power of two by repeating row 0 (same slot,
        same keys and values)."""
        gen = self.generator
        params, _ = gen.resident()
        tok, C = gen._tok, self._C
        seqs = [tok.encode(r.text)[-(C - 8):] for r in reqs]
        R = len(reqs)
        Rb = 1 << max(R - 1, 0).bit_length()
        Pb = 1 << max(max(map(len, seqs)) - 1, 0).bit_length()
        Pb = min(max(Pb, 8), C - 8)
        prompts = np.full((Rb, Pb), tok.eos_id, np.int64)
        n_valid = np.zeros(Rb, np.int64)
        temps, slots = [], []
        for i in range(Rb):
            j = i if i < R else 0
            seq = seqs[j][:Pb]
            prompts[i, :len(seq)] = seq
            n_valid[i] = len(seq)
            temps.append(self._temperature(reqs[j]))
            slots.append(free_slots[j])
        ck, cv = self._ensure_cache()
        self._rng_seed += 1
        dev = gen.device
        ck, cv, first = llm_prefill_slots(
            params, gen.dims, upload(prompts, torch.long, dev),
            upload(n_valid, torch.long, dev), ck, cv, slots, temps,
            jrandom.PRNGKey(self._rng_seed), dtype=gen.dtype)
        first = first.cpu().numpy()  # the admission's one readback
        for i, req in enumerate(reqs):
            tok0 = int(first[i])
            max_new = min(req.max_tokens or gen.config.max_tokens,
                          C - int(n_valid[i]) - 1)
            slot = _Slot(request=req, tokens=[tok0], pos=int(n_valid[i]),
                         max_new=max_new, last_token=tok0,
                         history=list(seqs[i][-SPEC_HISTORY:]))
            if tok0 == tok.eos_id or max_new <= 1:
                self._finish(slot)
                slot.done = True
            self._slots[free_slots[i]] = None if slot.done else slot

    def _finish(self, slot: _Slot) -> None:
        tok = self.generator._tok
        ids = slot.tokens
        if tok.eos_id in ids:
            ids = ids[:ids.index(tok.eos_id)]
        ids = ids[:slot.max_new]
        # counted before the caller wakes (it may read the counters next)
        self.requests_served += 1
        self.tokens_generated += len(ids)
        if not slot.request.future.done():
            slot.request.future.set_result(tok.decode(
                ids, tok.known_words(slot.request.text)).strip())

    def _dispatch_segment(self, chain: dict | None = None) -> dict:
        """Issue one segment and start its readback; the record goes to
        :meth:`_process_segment`. ``chain``: the previous segment, not yet
        read back, whose packed output gives this one's last tokens and
        positions on the device."""
        gen = self.generator
        B, dev = self.n_slots, gen.device
        seg = self._segment_for_dispatch() if chain is None else self.segment
        active = np.zeros(B, bool)
        temps = [0.0] * B
        for i, s in enumerate(self._slots):
            if s is not None:
                active[i] = True
                temps[i] = self._temperature(s.request)
        ck, cv = self._cache
        self._rng_seed += 1
        key = jrandom.PRNGKey(self._rng_seed)
        active_t = upload(active, torch.bool, dev)
        # after an eviction the same seeded weights load again, so the
        # slots' cache stays valid
        params, q8 = gen.resident()
        if chain is not None:
            prev = chain["packed"]
            toks, ck, cv, pos, _ = llm_decode_slots(
                params, gen.dims, prev[:, self.segment - 1], ck, cv,
                prev[:, self.segment], active_t, temps, key, seg,
                gen._tok.eos_id, dtype=gen.dtype, q8=q8)
        elif self.spec_k > 0:
            # each slot's recent tokens right-aligned (-1 pads match no
            # 2-gram); the last real token in the last column
            hist = np.full((B, SPEC_HISTORY), -1, np.int64)
            for i, s in enumerate(self._slots):
                if s is not None:
                    tail = ((s.history or []) + s.tokens)[-SPEC_HISTORY:]
                    hist[i, SPEC_HISTORY - len(tail):] = tail
            toks, ck, cv, pos, _ = llm_decode_slots_spec(
                params, gen.dims, upload(hist, torch.long, dev), ck,
                cv, self._positions(dev), active_t, temps, key, seg,
                gen._tok.eos_id, spec_k=self.spec_k, dtype=gen.dtype, q8=q8)
        else:
            last = upload([s.last_token if s else 0 for s in self._slots],
                          torch.long, dev)
            toks, ck, cv, pos, _ = llm_decode_slots(
                params, gen.dims, last, ck, cv, self._positions(dev),
                active_t, temps, key, seg, gen._tok.eos_id,
                dtype=gen.dtype, q8=q8)
        self._cache = (ck, cv)
        # tokens and new positions in one array: one readback a segment
        packed = torch.cat([toks, pos[:, None]], dim=1)
        host, event = _readback(packed)
        return {"packed": packed, "host": host, "event": event,
                "slots": list(self._slots), "seg": seg}

    def _positions(self, dev) -> torch.Tensor:
        return upload([s.pos if s else 0 for s in self._slots], torch.long,
                      dev)

    def _segment_for_dispatch(self) -> int:
        """``idle_segment`` steps when nobody waits to join and every live
        slot has that many tokens of quota and cache left, else the
        configured segment."""
        long_seg = self.idle_segment
        if long_seg <= self.segment or not self._queue.empty():
            return self.segment
        cap = self._C - 2
        live = [s for s in self._slots if s is not None]
        if live and all(len(s.tokens) + long_seg <= s.max_new
                        and s.pos + long_seg < cap for s in live):
            return long_seg
        return self.segment

    def _process_segment(self, flight: dict) -> None:
        """Apply a segment's readback to the slots it was issued for (a
        slot that finished since, while a chained segment was in flight,
        drops its rows: the next admission overwrites what they wrote)."""
        if flight["event"] is not None:
            flight["event"].synchronize()
        packed = flight["host"].numpy()
        toks, new_pos = packed[:, :-1], packed[:, -1]
        self.segments_run += 1
        eos = self.generator._tok.eos_id
        cap = self._C - 2
        for i, s in enumerate(flight["slots"]):
            if s is None or self._slots[i] is not s:
                continue
            s.tokens.extend(int(t) for t in toks[i])
            s.pos = int(new_pos[i])
            s.last_token = int(toks[i, -1])
            if s.request.on_delta is not None:
                self._emit_delta(s)
            if eos in s.tokens or len(s.tokens) >= s.max_new or s.pos >= cap:
                self._finish(s)
                self._slots[i] = None

    def _can_pipeline(self) -> bool:
        """Issue the next segment before reading this one back? Only with
        nothing to decide at the boundary: nobody waiting, no speculative
        drafting (it needs the host's history), and every live slot with
        two segments of quota and cache left."""
        if not self.pipeline or self.spec_k > 0 or not self._queue.empty():
            return False
        cap = self._C - 2
        live = [s for s in self._slots if s is not None]
        return bool(live) and all(
            len(s.tokens) + 2 * self.segment <= s.max_new
            and s.pos + 2 * self.segment < cap for s in live)

    def _emit_delta(self, slot: _Slot) -> None:
        """Hand the slot's consumer the text decoded since the last
        segment."""
        tok = self.generator._tok
        ids = slot.tokens
        if tok.eos_id in ids:
            ids = ids[:ids.index(tok.eos_id)]
        text = tok.decode(ids[:slot.max_new],
                          tok.known_words(slot.request.text))
        delta = text[len(slot.request.emitted):]
        if delta:
            slot.request.emitted = text
            try:
                slot.request.on_delta(delta)
            except Exception:  # a consumer's fault: stop streaming to it
                slot.request.on_delta = None

    def _fail_all(self, exc: BaseException) -> None:
        for i, s in enumerate(self._slots):
            if s is not None:
                if not s.request.future.done():
                    s.request.future.set_exception(exc)
                self._slots[i] = None

    def _shut(self) -> None:
        """The stop signal: every live and waiting request fails."""
        stopped = RuntimeError("scheduler stopped")
        self._fail_all(stopped)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(stopped)
        self._cache = None

    def _run(self) -> None:
        flight = None  # an issued segment not yet read back
        while True:
            if flight is None:
                busy = any(s is not None for s in self._slots)
                try:  # block only when idle
                    item = self._queue.get(timeout=0.001 if busy else None)
                except queue.Empty:
                    item = False
                if item is None:
                    self._shut()
                    return
                pending = [] if item is False else [item]
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._queue.put(None)  # stop on the next turn
                        break
                    pending.append(nxt)
                if pending:
                    free = [i for i, s in enumerate(self._slots) if s is None]
                    admit = pending[:len(free)]
                    for req in pending[len(free):]:
                        self._queue.put(req)  # joins at a later boundary
                    if admit:
                        try:
                            self._admit_many(admit, free)
                        except Exception as exc:
                            for req in admit:
                                if not req.future.done():
                                    req.future.set_exception(exc)
                if not any(s is not None for s in self._slots):
                    continue
                try:
                    flight = self._dispatch_segment()
                except Exception as exc:
                    self._fail_all(exc)
                    continue
            nxt_flight = None
            if self._can_pipeline() and flight["seg"] == self.segment:
                try:
                    nxt_flight = self._dispatch_segment(chain=flight)
                except Exception as exc:
                    self._fail_all(exc)
            try:
                self._process_segment(flight)
            except Exception as exc:
                self._fail_all(exc)
                nxt_flight = None
            flight = nxt_flight
