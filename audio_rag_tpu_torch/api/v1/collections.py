"""Collection endpoints (counterpart of
``audio_rag_tpu/api/v1/collections.py``): list, info and delete over the
pipeline's vector store (``rag.store``; the app keeps it as
``state["retriever"]``).
"""

from __future__ import annotations

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.deps import authenticate
from audio_rag_tpu_torch.api.http import App, HTTPError, Request, Response
from audio_rag_tpu_torch.api.schemas import CollectionInfo

__all__ = ["register_collection_routes"]


def _info(name: str, info: dict) -> dict:
    return CollectionInfo(name=name, count=info["count"], dim=info["dim"],
                          hbm_bytes=info["hbm_bytes"]).to_dict()


def register_collection_routes(app: App) -> None:
    config: APIConfig = app.state["config"]

    def retriever():
        r = app.state.get("retriever")
        if r is None:
            raise HTTPError(503, "vector store not initialized")
        return r

    @app.get("/api/v1/collections")
    async def list_collections(request: Request) -> Response:
        authenticate(request, config)
        r = retriever()
        return Response.json({"collections": [
            _info(name, r.collection_info(name))
            for name in r.list_collections()]})

    @app.get("/api/v1/collections/{name}")
    async def collection_info(request: Request) -> Response:
        authenticate(request, config)
        r = retriever()
        name = request.path_params["name"]
        if not r.collection_exists(name):
            raise HTTPError(404, f"collection {name!r} not found")
        return Response.json(_info(name, r.collection_info(name)))

    @app.delete("/api/v1/collections/{name}")
    async def delete_collection(request: Request) -> Response:
        authenticate(request, config)
        r = retriever()
        name = request.path_params["name"]
        existed = r.delete_collection(name)
        if not existed:
            raise HTTPError(404, f"collection {name!r} not found")
        return Response.json({"deleted": name})
