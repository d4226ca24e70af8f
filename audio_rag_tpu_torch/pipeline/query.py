"""Query pipeline of the port (counterpart of
``audio_rag_tpu/pipeline/query.py``).

Without a metadata filter and with the query's own text, a query runs the
batched :class:`~audio_rag_tpu_torch.engine.query_engine.QueryEngine`
(embed → dense / sparse / hybrid (RRF) search → top ``initial_k`` →
cross-encoder → top ``top_k``) when the embedder is BGE-M3, as the JAX
pipeline's fused engine; otherwise embed → search of ``initial_k``
(``top_k`` without reranking) → rerank with the original query. Reranking
is on unless the config's backend is "none" or the call passes
``rerank=False``. Expansion (``use_hyde``, on by default when
``expansion.backend`` is "hyde" or "prf") embeds the HyDE passage the
generator writes, or the query with PRF's terms appended.
``generate_answer=True`` asks the generator for an answer from
``SYSTEM_PROMPT`` and ``build_rag_prompt`` over the results;
``speak_answer=True`` speaks a non-empty answer through the configured TTS
backend into ``audio`` (WAV bytes), falling back to
``tts.fallback_backend`` when the configured one fails to load. A failing
answer, passage or synthesis raises (the JAX pipeline logs it and goes on).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from audio_rag_tpu_torch.config import AudioRAGConfig
from audio_rag_tpu_torch.core.types import RetrievalResult
from audio_rag_tpu_torch.engine.query_engine import QueryEngine
from audio_rag_tpu_torch.expansion import HyDEExpander, PRFExpander
from audio_rag_tpu_torch.generation.prompts import (
    SYSTEM_PROMPT,
    build_rag_prompt,
    format_timestamp,
)
from audio_rag_tpu_torch.pipeline.stages import SharedStages
from audio_rag_tpu_torch.reranking import create_reranker
from audio_rag_tpu_torch.tts import create_tts
from audio_rag_tpu_torch.utils.decorators import timed
from audio_rag_tpu_torch.utils.tracing import span

log = logging.getLogger(__name__)

__all__ = ["QueryPipeline", "QueryResult", "format_context"]


def format_context(results: list[RetrievalResult]) -> str:
    """The XML-like context block for an external LLM."""
    parts = ["<context>"]
    for i, r in enumerate(results, 1):
        parts.append(
            f'  <excerpt id="{i}" speaker="{r.speaker or "unknown"}" '
            f'start="{r.start:.1f}" end="{r.end:.1f}">')
        parts.append(f"    {r.text}")
        parts.append("  </excerpt>")
    parts.append("</context>")
    return "\n".join(parts)


def _build_response(results: list[RetrievalResult]) -> str:
    """``[speaker at MM:SS] text`` lines, one per result."""
    if not results:
        return "No relevant content found."
    return "\n\n".join(
        f"[{r.speaker or 'Speaker'} at {format_timestamp(r.start)}] {r.text}"
        for r in results)


@dataclass
class QueryResult:
    query: str
    results: list[RetrievalResult]
    response: str
    answer: str | None = None
    audio: bytes | None = None
    expanded_query: str | None = None
    elapsed_s: float = 0.0
    stage_timings: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "query": self.query,
            "results": [r.to_dict() for r in self.results],
            "response": self.response,
            "answer": self.answer,
            "expanded_query": self.expanded_query,
            "elapsed_s": self.elapsed_s,
            "stage_timings": self.stage_timings,
            "has_audio": self.audio is not None,
        }


class QueryPipeline:
    def __init__(self, config: AudioRAGConfig | None = None,
                 stages: SharedStages | None = None):
        self.stages = stages or SharedStages(config)
        self.config = self.stages.config
        self._reranker = None
        self._reranker_built = False
        self._expander: HyDEExpander | PRFExpander | None = None
        self._tts = None
        self._tts_built = False

    @property
    def reranker(self):
        """The configured reranker, loaded; None for backend "none"."""
        if not self._reranker_built:
            self._reranker = create_reranker(self.config.reranking,
                                             device=self.stages.device)
            self._reranker_built = True
        if self._reranker is not None:
            self._reranker.load()
        return self._reranker

    @property
    def expander(self) -> HyDEExpander | PRFExpander:
        """PRF over the embedder and the store for ``expansion.backend``
        "prf" (mining the default collection, as the JAX pipeline's does),
        else HyDE over the generator."""
        if self._expander is None:
            if self.config.expansion.backend == "prf":
                self._expander = PRFExpander(self.config.expansion,
                                             self.stages.embedder,
                                             self.stages.store)
            else:
                self._expander = HyDEExpander(self.config.expansion,
                                              self.stages.generator)
        return self._expander

    @property
    def tts(self):
        """The configured TTS backend, loaded; when it fails to load, the
        ``fallback_backend`` (with a warning), as the JAX pipeline's chain;
        None for "none" or when the fallback fails too."""
        if not self._tts_built:
            cfg = self.config.tts
            self._tts = self._load_tts(cfg)
            if self._tts is None and cfg.fallback_backend != "none" \
                    and cfg.backend not in ("none", cfg.fallback_backend):
                self._tts = self._load_tts(dataclasses.replace(
                    cfg, backend=cfg.fallback_backend), "fallback ")
            self._tts_built = True
        return self._tts

    def _load_tts(self, cfg, what: str = ""):
        tts = create_tts(cfg, device=self.stages.device)
        if tts is not None and not tts.is_loaded:
            try:
                tts.load()
            except Exception as exc:
                log.warning("TTS %sbackend %r failed to load: %s", what,
                            cfg.backend, exc)
                return None
        return tts

    def unload(self) -> None:
        """Drop the stages this pipeline built (rebuilt on next use)."""
        if self._tts is not None:
            self._tts.unload()
        self._reranker = self._expander = self._tts = None
        self._reranker_built = self._tts_built = False

    def _do_rerank(self, rerank: bool | None) -> bool:
        return (self.config.reranking.backend != "none" if rerank is None
                else rerank)

    def _engine_for(self, collection: str | None,
                    do_rerank: bool) -> QueryEngine | None:
        engine = self.stages.query_engine
        if engine is not None:
            engine.collection = collection
            engine.reranker = self.reranker if do_rerank else None
        return engine

    @timed
    def query(self, query: str, top_k: int | None = None,
              search_type: str | None = None,
              collection: str | None = None, use_hyde: bool | None = None,
              rerank: bool | None = None, generate_answer: bool = False,
              speak_answer: bool = False,
              metadata_filter: dict[str, Any] | None = None) -> QueryResult:
        """The top ``top_k`` chunks for ``query``; ``response`` holds them
        as ``[speaker at MM:SS] text`` lines, ``answer`` the generator's
        answer with ``generate_answer``, ``expanded_query`` the expanded
        text (HyDE's passage or PRF's query) when expansion ran, ``audio``
        the spoken answer with ``speak_answer`` (None without an answer)."""
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        top_k = top_k or self.config.retrieval.top_k
        search_type = search_type or self.config.retrieval.search_type
        do_rerank = self._do_rerank(rerank)
        initial_k = self.config.reranking.initial_k
        if use_hyde is None:
            use_hyde = self.config.expansion.backend in ("hyde", "prf")

        def clock(name: str, t0: float) -> float:
            timings[name] = round(time.perf_counter() - t0, 4)
            return time.perf_counter()

        t0 = time.perf_counter()
        expanded = None
        embed_text = query
        if use_hyde:
            expanded = self.expander.expand_single(query)
            if expanded != query:
                embed_text = expanded
            t0 = clock("hyde", t0)
        engine = (self._engine_for(collection, do_rerank)
                  if embed_text == query and metadata_filter is None
                  else None)
        if engine is not None:
            with span("query.fused"):
                results = engine.query_batch(
                    [query], top_k=top_k, search_type=search_type,
                    initial_k=initial_k, rerank=do_rerank)[0]
            t0 = clock("fused", t0)
        else:
            with span("query.embed"):
                emb = self.stages.embedder.embed_query(embed_text)
            t0 = clock("embed", t0)
            with span("query.search"):
                results = self.stages.store.search(
                    emb, top_k=initial_k if do_rerank else top_k,
                    search_type=search_type, collection=collection,
                    metadata_filter=metadata_filter)
            t0 = clock("search", t0)
            reranker = self.reranker if do_rerank else None
            if reranker is not None and results:
                # the original query, not the expansion
                with span("query.rerank"):
                    results = reranker.rerank(query, results, top_k)
                t0 = clock("rerank", t0)
            else:
                results = results[:top_k]
        answer = None
        if generate_answer and results and self.stages.generator is not None:
            answer = self.stages.generator.generate(
                build_rag_prompt(query, results), system=SYSTEM_PROMPT)
            t0 = clock("generate", t0)
        audio = None
        if speak_answer and answer and self.tts is not None:
            with span("query.tts"):
                audio = self.tts.synthesize(answer)
            clock("tts", t0)
        return QueryResult(
            query=query, results=results,
            response=_build_response(results), answer=answer, audio=audio,
            expanded_query=expanded,
            elapsed_s=round(time.perf_counter() - t_start, 4),
            stage_timings=timings)

    def query_batch(self, queries: list[str], top_k: int | None = None,
                    search_type: str | None = None,
                    collection: str | None = None,
                    rerank: bool | None = None) -> list[QueryResult]:
        """Many queries through the query engine at once (each result's
        ``elapsed_s`` the batch's time over the query count); one
        :meth:`query` each when the embedder has no engine."""
        top_k = top_k or self.config.retrieval.top_k
        search_type = search_type or self.config.retrieval.search_type
        do_rerank = self._do_rerank(rerank)
        engine = self._engine_for(collection, do_rerank)
        if engine is None:
            return [self.query(q, top_k=top_k, search_type=search_type,
                               collection=collection, rerank=do_rerank)
                    for q in queries]
        t0 = time.perf_counter()
        rows = engine.query_batch(
            queries, top_k=top_k, search_type=search_type,
            initial_k=self.config.reranking.initial_k, rerank=do_rerank)
        dt = round((time.perf_counter() - t0) / max(len(queries), 1), 4)
        return [QueryResult(query=q, results=row,
                            response=_build_response(row), elapsed_s=dt)
                for q, row in zip(queries, rows)]

    def get_context_for_llm(self, query: str, top_k: int | None = None,
                            search_type: str | None = None,
                            collection: str | None = None) -> str:
        """:func:`format_context` of :meth:`query`'s results."""
        return format_context(self.query(
            query, top_k=top_k, search_type=search_type,
            collection=collection).results)
