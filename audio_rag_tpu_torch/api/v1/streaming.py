"""WebSocket live transcription (counterpart of
``audio_rag_tpu/api/v1/streaming.py``): ``WS /api/v1/ws/transcribe`` takes
JSON command frames (``{"command": "stop" | "reset"}``) and binary int16
PCM frames at 16 kHz, and answers with transcript, status and error
messages; ``GET /api/v1/streaming/status`` reports the live sessions.

The key comes in the ``x-api-key`` header or ``?api_key=`` (a browser
cannot set a WebSocket header); without a known one the route closes with
4401. Each connection gets its own
:class:`~audio_rag_tpu_torch.asr.streaming.StreamingASR`, loaded off the
event loop; every session's chunks go through one process-wide
:class:`~audio_rag_tpu_torch.asr.mux.StreamingMux` over one ASR backend,
so concurrent sessions share one window-batch dispatch on the mux's
thread. The backend is the pipeline config's ASR on the pipeline's device
(the fake ASR when its backend is "fake"), its decode budget capped by
``streaming.max_decode_tokens`` when ``asr.max_decode_tokens`` is unset.
Sessions past ``streaming.max_sessions`` are refused with 4429, the slot
reserved before the first await. At shutdown the mux stops off the loop.
The module's lock, as the JAX module's, binds to no event loop: nothing
awaits while it is held, so no connection ever waits on it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging

from audio_rag_tpu_torch.api.config import APIConfig
from audio_rag_tpu_torch.api.deps import authenticate
from audio_rag_tpu_torch.api.http import App, Request, Response, WebSocket

log = logging.getLogger(__name__)

__all__ = ["register_streaming_routes"]

_mux_lock = asyncio.Lock()


async def _get_streaming_mux(app: App):
    """The app's shared ASR backend and chunk mux (built once)."""
    async with _mux_lock:
        mux = app.state.get("streaming_mux")
        if mux is None:
            from audio_rag_tpu_torch.asr.mux import StreamingMux
            from audio_rag_tpu_torch.config import ASRConfig

            rag_cfg = app.state.get("rag_config")
            asr_cfg = rag_cfg.asr if rag_cfg is not None else ASRConfig()
            if asr_cfg.backend == "fake":
                from audio_rag_tpu_torch.asr.fake import FakeASR

                backend = FakeASR(asr_cfg)
            else:
                from audio_rag_tpu_torch.asr.whisper import WhisperASR

                if asr_cfg.max_decode_tokens is None:
                    stream_cfg = (rag_cfg.streaming if rag_cfg is not None
                                  else None)
                    asr_cfg = dataclasses.replace(
                        asr_cfg, max_decode_tokens=(
                            stream_cfg.max_decode_tokens
                            if stream_cfg is not None else 64))
                backend = WhisperASR(
                    asr_cfg, device=(rag_cfg.device if rag_cfg is not None
                                     else "cuda"))
            mux = StreamingMux(backend)
            app.state["streaming_mux"] = mux
            app.state["streaming_sessions"] = set()

            @app.on_shutdown
            async def stop_mux():
                # stop() joins the mux's thread (a dispatch in flight can
                # hold it for seconds): off the loop, so that other
                # connections drain meanwhile
                await asyncio.get_running_loop().run_in_executor(
                    None, mux.stop)
        return mux


def _new_session(app: App, mux):
    from audio_rag_tpu_torch.asr.streaming import StreamingASR
    from audio_rag_tpu_torch.config import ASRConfig

    rag_cfg = app.state.get("rag_config")
    asr_cfg = rag_cfg.asr if rag_cfg is not None else ASRConfig()
    stream_cfg = (
        rag_cfg.streaming.to_runtime() if rag_cfg is not None else None
    )
    return StreamingASR(asr_cfg, stream_cfg, mux=mux)


def register_streaming_routes(app: App) -> None:
    config: APIConfig = app.state["config"]

    def _max_sessions() -> int:
        rag_cfg = app.state.get("rag_config")
        if rag_cfg is not None:
            return rag_cfg.streaming.max_sessions
        return 8

    @app.websocket("/api/v1/ws/transcribe")
    async def transcribe(request: Request, ws: WebSocket) -> None:
        api_key = request.header("x-api-key") or request.query.get("api_key")
        if not api_key or api_key not in config.api_keys:
            await ws.send_json({"type": "error", "error": "unauthorized"})
            await ws.close(4401)
            return

        mux = await _get_streaming_mux(app)
        sessions: set = app.state["streaming_sessions"]
        if len(sessions) >= _max_sessions():
            await ws.send_json({
                "type": "error",
                "error": f"session limit {_max_sessions()} reached",
            })
            await ws.close(4429)
            return

        loop = asyncio.get_running_loop()
        asr = _new_session(app, mux)
        # the check and the add are one step of the loop: a burst of
        # connections during the first (long) load cannot all pass it
        sessions.add(asr)
        try:
            # the first session pays the backend's load and warm-up
            await loop.run_in_executor(None, asr.load)
            await asr.start()
            await ws.send_json({"type": "status", "status": "listening"})
            while True:
                frame = await ws.recv()
                if frame is None:
                    break
                kind, data = frame
                if kind == "text":
                    try:
                        cmd = json.loads(data).get("command")
                    except json.JSONDecodeError:
                        await ws.send_json(
                            {"type": "error", "error": "invalid JSON"}
                        )
                        continue
                    if cmd == "stop":
                        final = await asr.stop()
                        if final is not None:
                            await ws.send_json(
                                {"type": "transcript", **final.to_dict()}
                            )
                        await ws.send_json(
                            {"type": "status", "status": "stopped"}
                        )
                        break
                    if cmd == "reset":
                        await asr.reset()
                        await ws.send_json(
                            {"type": "status", "status": "reset"}
                        )
                        continue
                    await ws.send_json(
                        {"type": "error",
                         "error": f"unknown command {cmd!r}"}
                    )
                else:  # binary PCM int16 at 16 kHz
                    result = await asr.add_audio(data)
                    if result is not None:
                        await ws.send_json(
                            {"type": "transcript", **result.to_dict()}
                        )
        except ConnectionError:
            pass
        finally:
            sessions.discard(asr)
            if asr.state.value != "stopped":
                await asr.stop()

    @app.get("/api/v1/streaming/status")
    async def streaming_status(request: Request) -> Response:
        authenticate(request, config)
        mux = app.state.get("streaming_mux")
        sessions = app.state.get("streaming_sessions") or set()
        if mux is None:
            return Response.json({
                "active": False, "state": "idle", "sessions": 0,
                "max_sessions": _max_sessions(),
            })
        return Response.json({
            "active": bool(sessions),
            "state": "listening" if sessions else "idle",
            "sessions": len(sessions),
            "max_sessions": _max_sessions(),
            "chunks_served": mux.chunks_served,
            "batches_run": mux.batches_run,
            "buffered_s": [
                round(s.buffer.buffered_duration, 2) for s in sessions
            ],
        })
