"""Query coalescer (counterpart of ``audio_rag_tpu/engine/query_coalescer.py``):
concurrent single queries share one batched query-engine call.

Built on :class:`~audio_rag_tpu_torch.utils.coalescer.KeyedCoalescer`:
queries that arrive while a batch runs accumulate and go out together in
the next :meth:`AudioRAG.query_batch <audio_rag_tpu_torch.pipeline.AudioRAG.
query_batch>`. Queries batch only when ``(top_k, search_type, collection,
rerank)`` agree.

The coalescer's own thread never touches the device: each batch runs
through ``run_in(fn) -> result`` (the API passes its single device-work
executor; by default the batch runs inline on the coalescer's worker
thread). ``linger_s``: keep draining this long after each arrival, so that
clients woken together by one batch's end, resubmitting one at a time,
ride the next batch together instead of the first of them going alone.
"""

from __future__ import annotations

from concurrent.futures import Future

from audio_rag_tpu_torch.utils.coalescer import KeyedCoalescer

__all__ = ["QueryCoalescer"]


class QueryCoalescer(KeyedCoalescer):
    worker_name = "query-coalescer"
    join_timeout_s = 10.0

    def __init__(self, pipeline, max_batch: int = 64, run_in=None,
                 linger_s: float = 0.0):
        """``pipeline`` provides ``query_batch`` (an ``AudioRAG`` or its
        ``QueryPipeline``)."""
        self.pipeline = pipeline
        self._run_in = run_in or (lambda fn: fn())
        super().__init__(max_batch=max_batch, linger_s=linger_s)

    @property
    def requests_served(self) -> int:
        return self.items_served

    def submit(self, query: str, top_k=None, search_type=None,
               collection=None, rerank=None) -> Future:
        return self._submit(query, (top_k, search_type, collection, rerank))

    def query(self, query: str, **kw):
        return self.submit(query, **kw).result()

    def _run_batch(self, payloads: list, key: tuple):
        top_k, search_type, collection, rerank = key
        return self._run_in(lambda: self.pipeline.query_batch(
            payloads, top_k=top_k, search_type=search_type,
            collection=collection, rerank=rerank))
