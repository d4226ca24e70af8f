"""Generation scheduling of the port (counterpart of
``audio_rag_tpu/engine/scheduler.py``). Wave mode: concurrent generation
requests that arrive within ``max_wait_ms`` of the first (up to
``max_batch``) and share their decode parameters run as one
``generate_batch`` wave; each caller waits on a future. Continuous mode:
the requests go to the
:class:`~audio_rag_tpu_torch.engine.continuous.ContinuousBatcher`, and
``generate_stream`` yields text as each segment completes. A failure sets
its exception on the futures of the requests it hit, so each caller's
``generate`` raises it."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Iterator

__all__ = ["GenerationScheduler", "ScheduledGenerator", "word_chunks"]


def word_chunks(text: str) -> Iterator[str]:
    """A finished answer streamed in groups of eight words (how both
    packages stream under wave batching)."""
    words = text.split()
    for i in range(0, len(words), 8):
        yield " ".join(words[i: i + 8]) + " "


@dataclass
class _Request:
    prompt: str
    system: str | None
    max_tokens: int | None
    temperature: float | None
    future: Future = field(default_factory=Future)

    def batch_key(self) -> tuple:
        """Requests share a wave only when their decode parameters agree."""
        return (self.system, self.max_tokens, self.temperature)


class GenerationScheduler:
    def __init__(self, generator, max_batch: int = 16,
                 max_wait_ms: float = 10.0):
        self.generator = generator  # has generate_batch(prompts, ...)
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._stopped = False
        #: waves run and requests answered so far
        self.batches_run = 0
        self.requests_served = 0
        self._thread = threading.Thread(target=self._run,
                                        name="gen-scheduler", daemon=True)
        self._thread.start()

    def submit(self, prompt: str, system: str | None = None,
               max_tokens: int | None = None,
               temperature: float | None = None) -> Future:
        if self._stopped:
            raise RuntimeError("scheduler stopped")
        req = _Request(prompt, system, max_tokens, temperature)
        self._queue.put(req)
        return req.future

    def generate(self, prompt: str, **kw: Any) -> str:
        return self.submit(prompt, **kw).result()

    def stop(self) -> None:
        self._stopped = True
        self._queue.put(None)
        self._thread.join(timeout=5.0)

    def _collect_wave(self) -> list[_Request] | None:
        first = self._queue.get()
        if first is None:
            return None
        wave = [first]
        key = first.batch_key()
        while len(wave) < self.max_batch:
            try:
                nxt = self._queue.get(timeout=self.max_wait_s)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # stop once this wave is done
                break
            if nxt.batch_key() != key:
                self._queue.put(nxt)  # other parameters: a later wave
                break
            wave.append(nxt)
        return wave

    def _run(self) -> None:
        while True:
            wave = self._collect_wave()
            if wave is None:
                return
            try:
                results = self.generator.generate_batch(
                    [r.prompt for r in wave], system=wave[0].system,
                    max_tokens=wave[0].max_tokens,
                    temperature=wave[0].temperature)
                error = None
            except Exception as exc:  # handed to every caller of the wave
                error = exc
            # counted before any caller wakes: a caller that reads the
            # counters after its answer sees its own wave
            self.batches_run += 1
            self.requests_served += len(wave)
            if error is None:
                for r, text in zip(wave, results):
                    r.future.set_result(text)
            else:
                for r in wave:
                    if not r.future.done():
                        r.future.set_exception(error)


class ScheduledGenerator:
    """A generator's interface over a :class:`GenerationScheduler` (mode
    "wave") or a continuous batcher (mode "continuous"), so that answers,
    HyDE passages and headers asked for at the same time share the
    device."""

    def __init__(self, generator, max_batch: int = 16,
                 max_wait_ms: float = 10.0, mode: str = "wave",
                 n_slots: int = 8, segment_tokens: int = 16,
                 context_tokens: int = 2048,
                 idle_segment_tokens: int = 0):
        self.inner = generator
        if mode == "continuous":
            from audio_rag_tpu_torch.engine.continuous import (
                ContinuousBatcher,
            )

            self.scheduler = ContinuousBatcher(
                generator, n_slots=n_slots, segment_tokens=segment_tokens,
                context_tokens=context_tokens,
                idle_segment_tokens=idle_segment_tokens)
        else:
            self.scheduler = GenerationScheduler(generator, max_batch,
                                                 max_wait_ms)

    @property
    def is_loaded(self) -> bool:
        return self.inner.is_loaded

    def load(self) -> None:
        self.inner.load()

    def unload(self) -> None:
        self.scheduler.stop()
        self.inner.unload()

    def check_availability(self) -> bool:
        return self.inner.check_availability()

    def generate(self, prompt: str, system: str | None = None,
                 max_tokens: int | None = None,
                 temperature: float | None = None) -> str:
        return self.scheduler.generate(prompt, system=system,
                                       max_tokens=max_tokens,
                                       temperature=temperature)

    def generate_batch(self, prompts: list[str], **kw: Any) -> list[str]:
        futures = [self.scheduler.submit(p, **kw) for p in prompts]
        return [f.result() for f in futures]

    def generate_stream(self, prompt: str, **kw: Any) -> Iterator[str]:
        """The answer's text as the continuous batcher decodes it, segment
        by segment (a failure raises once the deltas stop); under waves the
        finished answer in groups of eight words."""
        if isinstance(self.scheduler, GenerationScheduler):
            yield from word_chunks(self.generate(prompt, **kw))
            return
        deltas: queue.Queue[str | None] = queue.Queue()
        fut = self.scheduler.submit(prompt, on_delta=deltas.put, **kw)
        fut.add_done_callback(lambda _: deltas.put(None))
        while (d := deltas.get()) is not None:
            yield d
        fut.result()
