"""Query endpoints (counterpart of ``audio_rag_tpu/api/v1/query.py``):
``POST /api/v1/query`` with the pipeline's parameters (search_type,
use_hyde, rerank, generate_answer, speak_answer, include_context,
metadata_filter) and ``GET /api/v1/status``.

Device work never runs on the event loop. Search-only requests go through
the process-wide :class:`~audio_rag_tpu_torch.engine.query_coalescer.
QueryCoalescer`, whose batches run on the app's single device executor
(``run_in``) with the config's ``coalesce_linger_ms``; HyDE, answers,
speech and filtered requests run whole on that same executor.
"""

from __future__ import annotations

import asyncio
import base64

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.deps import authenticate, check_rate_limit
from audio_rag_tpu_torch.api.http import App, HTTPError, Request, Response
from audio_rag_tpu_torch.api.schemas import (
    QueryRequest,
    QueryResponse,
    RetrievalResultModel,
)

__all__ = ["register_query_routes"]


def _coalescer(app: App, rag):
    """The app's query coalescer, built at the first search-only
    request; its batches run on the app's device executor."""
    c = app.state.get("query_coalescer")
    if c is None:
        from audio_rag_tpu_torch.engine.query_coalescer import QueryCoalescer

        executor = app.state["executor"]
        config = app.state["config"]
        c = QueryCoalescer(
            rag.querying,
            run_in=lambda fn: executor.submit(fn).result(),
            linger_s=getattr(config, "coalesce_linger_ms", 0.0) / 1000.0,
        )
        app.state["query_coalescer"] = c
    return c


def register_query_routes(app: App) -> None:
    config: APIConfig = app.state["config"]

    @app.on_shutdown
    async def _stop_coalescer() -> None:
        c = app.state.get("query_coalescer")
        if c is not None:
            c.stop()

    @app.post("/api/v1/query")
    async def query(request: Request) -> Response:
        authenticate(request, config)
        check_rate_limit(request, config, "query", app.state["store"])
        body = QueryRequest(**(request.json() or {}))

        rag = app.state.get("rag")
        if rag is None:
            raise HTTPError(503, "query pipeline not initialized")

        loop = asyncio.get_running_loop()
        coalescible = (
            config.coalesce_queries
            and not body.use_hyde and not body.generate_answer
            and not body.speak_answer and not body.metadata_filter
        )
        if coalescible:
            result = await asyncio.wrap_future(
                _coalescer(app, rag).submit(
                    body.query, top_k=body.top_k,
                    search_type=body.search_type,
                    collection=body.collection, rerank=body.rerank,
                ))
        else:
            def run():
                return rag.query(
                    body.query,
                    top_k=body.top_k,
                    search_type=body.search_type,
                    collection=body.collection,
                    use_hyde=body.use_hyde,
                    rerank=body.rerank,
                    generate_answer=body.generate_answer,
                    speak_answer=body.speak_answer,
                    metadata_filter=body.metadata_filter,
                )

            result = await loop.run_in_executor(app.state["executor"], run)
        context = None
        if body.include_context and result.results:
            # this request's own results: another query from the loop
            # would block it and race the device executor
            from audio_rag_tpu_torch.pipeline.query import format_context

            context = format_context(result.results)
        audio_b64 = None
        if body.speak_answer and getattr(result, "audio", None):
            audio_b64 = base64.b64encode(result.audio).decode("ascii")
        payload = QueryResponse(
            query=result.query,
            results=[
                RetrievalResultModel(**r.to_dict()) for r in result.results
            ],
            response=result.response,
            answer=result.answer,
            expanded_query=result.expanded_query,
            context=context,
            answer_audio_b64=audio_b64,
            elapsed_s=result.elapsed_s,
            stage_timings=result.stage_timings,
            request_id=request.context.get("request_id"),
        )
        return Response.json(payload.to_dict())

    @app.get("/api/v1/status")
    async def status(request: Request) -> Response:
        authenticate(request, config)
        rag = app.state.get("rag")
        if rag is None:
            raise HTTPError(503, "pipeline not initialized")
        return Response.json(rag.status())
