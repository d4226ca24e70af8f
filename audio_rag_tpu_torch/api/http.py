"""Minimal asyncio HTTP/1.1 + WebSocket server (counterpart of
``audio_rag_tpu/api/http.py``, the standard library only): a route table
with ``{param}`` captures, an async middleware chain, JSON helpers,
multipart uploads spooled to ``upload_dir`` in 1 MB pieces, and an RFC 6455
WebSocket (handshake, masked frames, text/binary/ping/close).

A misbehaving client cannot pin a task: the request head and the body
have their own timeouts (408), an oversized head is refused (431), past
``max_connections`` a connection is shed at once with 503, and a
WebSocket closes with 1001 when a frame does not arrive within
``ws_idle_timeout`` (pings reset it) or 1009 when a frame declares more
than ``max_ws_frame_bytes``. Connections keep alive between requests
unless the client sends ``Connection: close``; an idle kept-alive
connection closes silently after ``header_timeout``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import re
import struct
import tempfile
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Awaitable, Callable

log = logging.getLogger(__name__)

__all__ = ["Request", "Response", "HTTPError", "App", "WebSocket",
           "UploadedFile"]

MAX_HEADER_BYTES = 64 * 1024
DEFAULT_MAX_BODY = 600 * 1024 * 1024
WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# -- abuse bounds: without them one slowloris client pins a task forever ---
DEFAULT_HEADER_TIMEOUT = 10.0    # s to receive the full request head
DEFAULT_BODY_TIMEOUT = 300.0     # s to receive the body (500 MB uploads)
DEFAULT_WS_IDLE_TIMEOUT = 300.0  # s between WS frames (pings reset it)
DEFAULT_MAX_CONNECTIONS = 256    # concurrent connections before 503 shed
DEFAULT_MAX_WS_FRAME = 16 * 1024 * 1024  # bytes; larger frames → 1009


class HTTPError(Exception):
    def __init__(self, status: int, detail: str = "",
                 headers: dict[str, str] | None = None,
                 payload: dict[str, Any] | None = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = headers or {}
        self.payload = payload


@dataclass
class UploadedFile:
    field_name: str
    filename: str
    content_type: str
    path: Path  # spooled to disk
    size: int


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes = b""
    path_params: dict[str, str] = field(default_factory=dict)
    files: list[UploadedFile] = field(default_factory=list)
    form: dict[str, str] = field(default_factory=dict)
    context: dict[str, Any] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except json.JSONDecodeError:
            raise HTTPError(400, "invalid JSON body") from None

    def header(self, name: str, default: str | None = None) -> str | None:
        return self.headers.get(name.lower(), default)


_STATUS_TEXT = {
    200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}


class Response:
    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "application/octet-stream",
                 headers: dict[str, str] | None = None):
        self.body = body
        self.status = status
        self.headers = {"content-type": content_type, **(headers or {})}

    @classmethod
    def json(cls, data: Any, status: int = 200,
             headers: dict[str, str] | None = None) -> "Response":
        return cls(json.dumps(data).encode(), status,
                   "application/json", headers)

    @classmethod
    def text(cls, s: str, status: int = 200) -> "Response":
        return cls(s.encode(), status, "text/plain; charset=utf-8")

    def encode(self, keep_alive: bool = False) -> bytes:
        reason = _STATUS_TEXT.get(self.status, "")
        head = [f"HTTP/1.1 {self.status} {reason}"]
        hdrs = dict(self.headers)
        hdrs.setdefault("content-length", str(len(self.body)))
        hdrs.setdefault("connection",
                        "keep-alive" if keep_alive else "close")
        head.extend(f"{k}: {v}" for k, v in hdrs.items())
        return ("\r\n".join(head) + "\r\n\r\n").encode() + self.body


Handler = Callable[[Request], Awaitable[Response]]
Middleware = Callable[[Request, Callable[[Request], Awaitable[Response]]],
                      Awaitable[Response]]

_PARAM_RE = re.compile(r"\{(\w+)\}")


def _compile(pattern: str) -> re.Pattern:
    regex = _PARAM_RE.sub(r"(?P<\1>[^/]+)", pattern.rstrip("/") or "/")
    return re.compile(f"^{regex}/?$")


class _FrameTooBig(Exception):
    pass


class WebSocket:
    """Server-side RFC6455 connection (post-handshake).

    ``idle_timeout`` bounds the wait for each frame (a half-sent frame
    header counts — truncated-frame stalls close the same way); pings
    reset it. ``max_frame_bytes`` rejects frames whose declared length
    exceeds the cap with close code 1009 before buffering anything.
    """

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 idle_timeout: float | None = DEFAULT_WS_IDLE_TIMEOUT,
                 max_frame_bytes: int = DEFAULT_MAX_WS_FRAME):
        self._r = reader
        self._w = writer
        self.closed = False
        self.idle_timeout = idle_timeout
        self.max_frame_bytes = max_frame_bytes

    async def _read_frame(self) -> tuple[int, bytes]:
        hdr = await self._r.readexactly(2)
        fin_op, mask_len = hdr
        opcode = fin_op & 0x0F
        masked = mask_len & 0x80
        length = mask_len & 0x7F
        if length == 126:
            (length,) = struct.unpack(">H", await self._r.readexactly(2))
        elif length == 127:
            (length,) = struct.unpack(">Q", await self._r.readexactly(8))
        if length > self.max_frame_bytes:
            raise _FrameTooBig
        mask = await self._r.readexactly(4) if masked else b"\x00" * 4
        payload = await self._r.readexactly(length) if length else b""
        if masked:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return opcode, payload

    async def recv(self) -> tuple[str, Any] | None:
        """Returns ("text", str) | ("bytes", bytes) | None on close."""
        while True:
            try:
                opcode, payload = await asyncio.wait_for(
                    self._read_frame(), self.idle_timeout)
            except (asyncio.TimeoutError, TimeoutError):
                await self.close(1001)  # idle/stalled client: going away
                return None
            except _FrameTooBig:
                await self.close(1009)  # message too big
                return None
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            if opcode == 0x8:  # close
                await self.close()
                return None
            if opcode == 0x9:  # ping → pong
                await self._send_frame(0xA, payload)
                continue
            if opcode == 0xA:  # pong
                continue
            if opcode == 0x1:
                return "text", payload.decode("utf-8", "replace")
            if opcode == 0x2:
                return "bytes", payload
            # continuation frames not needed for our clients
            continue

    async def _send_frame(self, opcode: int, payload: bytes,
                          force: bool = False) -> None:
        if self.closed and not force:
            return
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < (1 << 16):
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        self._w.write(header + payload)
        await self._w.drain()

    async def send_text(self, s: str) -> None:
        await self._send_frame(0x1, s.encode())

    async def send_json(self, data: Any) -> None:
        await self.send_text(json.dumps(data))

    async def send_bytes(self, b: bytes) -> None:
        await self._send_frame(0x2, b)

    async def close(self, code: int = 1000) -> None:
        # flag first (idempotent even across concurrent closers), then
        # force the close frame past _send_frame's closed-guard — the
        # old order dropped every close code and clients saw 1006
        if self.closed:
            return
        self.closed = True
        try:
            await self._send_frame(0x8, struct.pack(">H", code),
                                   force=True)
        except Exception:  # best-effort: socket may already be dead
            pass


WSHandler = Callable[[Request, WebSocket], Awaitable[None]]


class App:
    def __init__(self, max_body_bytes: int = DEFAULT_MAX_BODY,
                 upload_dir: str | None = None,
                 header_timeout: float | None = DEFAULT_HEADER_TIMEOUT,
                 body_timeout: float | None = DEFAULT_BODY_TIMEOUT,
                 ws_idle_timeout: float | None = DEFAULT_WS_IDLE_TIMEOUT,
                 max_connections: int = DEFAULT_MAX_CONNECTIONS,
                 max_ws_frame_bytes: int = DEFAULT_MAX_WS_FRAME):
        self._routes: list[tuple[str, re.Pattern, Handler, str]] = []
        self._ws_routes: list[tuple[re.Pattern, WSHandler]] = []
        self._middleware: list[Middleware] = []
        self._error_handlers: dict[type, Callable] = {}
        self.max_body_bytes = max_body_bytes
        self.upload_dir = upload_dir
        self.header_timeout = header_timeout
        self.body_timeout = body_timeout
        self.ws_idle_timeout = ws_idle_timeout
        self.max_ws_frame_bytes = max_ws_frame_bytes
        self._conn_sema = asyncio.Semaphore(max_connections)
        self.state: dict[str, Any] = {}
        self._on_startup: list[Callable[[], Awaitable[None]]] = []
        self._on_shutdown: list[Callable[[], Awaitable[None]]] = []

    # -- registration ------------------------------------------------------
    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self._routes.append(
                (method.upper(), _compile(pattern), fn, pattern))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def delete(self, pattern: str):
        return self.route("DELETE", pattern)

    def websocket(self, pattern: str):
        def deco(fn: WSHandler) -> WSHandler:
            self._ws_routes.append((_compile(pattern), fn))
            return fn

        return deco

    def middleware(self, fn: Middleware) -> Middleware:
        self._middleware.append(fn)
        return fn

    def exception_handler(self, exc_type: type):
        def deco(fn):
            self._error_handlers[exc_type] = fn
            return fn

        return deco

    def on_startup(self, fn):
        self._on_startup.append(fn)
        return fn

    def on_shutdown(self, fn):
        self._on_shutdown.append(fn)
        return fn

    # -- dispatch ----------------------------------------------------------
    async def dispatch(self, request: Request) -> Response:
        async def endpoint(req: Request) -> Response:
            allowed = []
            for method, pattern, handler, template in self._routes:
                m = pattern.match(req.path)
                if m:
                    if method == req.method:
                        req.path_params = m.groupdict()
                        # the route TEMPLATE (not the raw path) keeps
                        # metrics label cardinality bounded
                        req.context["route"] = template
                        return await handler(req)
                    allowed.append(method)
            if allowed:
                raise HTTPError(405, "method not allowed",
                                {"allow": ", ".join(allowed)})
            raise HTTPError(404, "not found")

        call = endpoint
        for mw in reversed(self._middleware):
            call = (lambda mw, nxt: lambda r: mw(r, nxt))(mw, call)
        try:
            return await call(request)
        except HTTPError as exc:
            payload = exc.payload or {
                "error": _STATUS_TEXT.get(exc.status, "error"),
                "detail": exc.detail,
            }
            return Response.json(payload, exc.status, exc.headers)
        except Exception as exc:  # noqa: BLE001
            for etype, handler in self._error_handlers.items():
                if isinstance(exc, etype):
                    return await handler(request, exc)
            log.exception("unhandled error on %s %s", request.method,
                          request.path)
            return Response.json(
                {"error": "Internal Server Error",
                 "detail": f"{type(exc).__name__}"}, 500
            )

    # -- connection handling -----------------------------------------------
    async def _read_request(
        self, reader: asyncio.StreamReader
    ) -> Request | None:
        try:
            # wait_for bounds a slowloris client drip-feeding header
            # bytes; the stream limit (serve() passes MAX_HEADER_BYTES)
            # bounds oversized heads with LimitOverrunError
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), self.header_timeout)
        except (asyncio.TimeoutError, TimeoutError):
            raise HTTPError(408, "timed out reading request head") from None
        except asyncio.LimitOverrunError:
            raise HTTPError(431, "headers too large") from None
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            raise HTTPError(431, "headers too large")
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            raise HTTPError(400, "malformed request line") from None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        parsed = urllib.parse.urlsplit(target)
        query = dict(urllib.parse.parse_qsl(parsed.query))

        length = int(headers.get("content-length", "0") or 0)
        if length > self.max_body_bytes:
            raise HTTPError(413, "request body too large")
        req = Request(method=method.upper(), path=parsed.path or "/",
                      query=query, headers=headers)

        ctype = headers.get("content-type", "")
        try:
            if ctype.startswith("multipart/form-data"):
                await asyncio.wait_for(
                    self._read_multipart(reader, req, ctype, length),
                    self.body_timeout)
            elif length:
                req.body = await asyncio.wait_for(
                    reader.readexactly(length), self.body_timeout)
        except (asyncio.TimeoutError, TimeoutError):
            raise HTTPError(408, "timed out reading request body") from None
        except asyncio.IncompleteReadError:
            # client hung up mid-body: nobody is listening for a reply
            return None
        return req

    async def _read_multipart(
        self, reader: asyncio.StreamReader, req: Request,
        ctype: str, length: int,
    ) -> None:
        """Streamed multipart parse: file parts spool to disk in 1 MB
        chunks; the body's size was checked against ``max_body_bytes``."""
        m = re.search(r"boundary=([^;]+)", ctype)
        if not m:
            raise HTTPError(400, "multipart without boundary")
        boundary = b"--" + m.group(1).strip('"').encode()
        remaining = length
        buf = b""
        CHUNK = 1 << 20

        async def fill(n: int = CHUNK) -> bool:
            nonlocal buf, remaining
            if remaining <= 0:
                return False
            data = await reader.read(min(n, remaining))
            if not data:
                remaining = 0
                return False
            remaining -= len(data)
            buf += data
            return True

        # find first boundary
        while boundary not in buf and await fill():
            pass
        if boundary not in buf:
            raise HTTPError(400, "malformed multipart body")
        buf = buf.split(boundary, 1)[1]

        upload_root = Path(self.upload_dir or tempfile.gettempdir())
        upload_root.mkdir(parents=True, exist_ok=True)

        while True:
            # part headers
            while b"\r\n\r\n" not in buf and await fill():
                pass
            if buf.startswith(b"--"):
                break  # final boundary
            if b"\r\n\r\n" not in buf:
                break
            raw_hdr, buf = buf.split(b"\r\n\r\n", 1)
            part_headers: dict[str, str] = {}
            for line in raw_hdr.decode("latin-1").split("\r\n"):
                if ":" in line:
                    k, v = line.split(":", 1)
                    part_headers[k.strip().lower()] = v.strip()
            disp = part_headers.get("content-disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            field_name = name_m.group(1) if name_m else "field"

            marker = b"\r\n" + boundary
            if file_m:  # file part → spool to disk
                fd = tempfile.NamedTemporaryFile(
                    dir=upload_root, delete=False,
                    suffix=Path(file_m.group(1)).suffix or ".bin",
                )
                size = 0
                try:
                    while True:
                        idx = buf.find(marker)
                        if idx >= 0:
                            fd.write(buf[:idx])
                            size += idx
                            buf = buf[idx + len(marker):]
                            break
                        keep = len(marker)
                        if len(buf) > keep:
                            fd.write(buf[:-keep])
                            size += len(buf) - keep
                            buf = buf[-keep:]
                        if not await fill():
                            fd.write(buf)
                            size += len(buf)
                            buf = b""
                            break
                finally:
                    fd.close()
                req.files.append(
                    UploadedFile(
                        field_name=field_name,
                        filename=file_m.group(1),
                        content_type=part_headers.get(
                            "content-type", "application/octet-stream"
                        ),
                        path=Path(fd.name),
                        size=size,
                    )
                )
            else:  # simple field
                while marker not in buf and await fill():
                    pass
                idx = buf.find(marker)
                value = buf[:idx] if idx >= 0 else buf
                buf = buf[idx + len(marker):] if idx >= 0 else b""
                req.form[field_name] = value.decode("utf-8", "replace")

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        if self._conn_sema.locked():
            # at the cap: shed immediately instead of queueing behind
            # (possibly deliberately) slow connections
            try:
                writer.write(Response.json(
                    {"error": "too many connections"}, 503,
                    {"retry-after": "1"},
                ).encode())
                await writer.drain()
            except Exception:
                pass
            finally:
                writer.close()
            return
        async with self._conn_sema:
            await self._handle_conn_inner(reader, writer)

    async def _handle_conn_inner(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """Serve requests on one connection with HTTP/1.1 keep-alive;
        clients opt out with ``Connection: close``. An idle keep-alive
        connection closes silently when no new request head arrives
        within ``header_timeout`` (a 408 is only for a FIRST request
        that started and stalled)."""
        try:
            first = True
            while True:
                try:
                    req = await self._read_request(reader)
                except HTTPError as exc:
                    if exc.status == 408 and not first:
                        return  # idle keep-alive connection: just close
                    writer.write(Response.json(
                        {"error": exc.detail}, exc.status
                    ).encode())
                    await writer.drain()
                    return
                if req is None:
                    return

                # WebSocket upgrade?
                if req.header("upgrade", "").lower() == "websocket":
                    for pattern, handler in self._ws_routes:
                        m = pattern.match(req.path)
                        if m:
                            req.path_params = m.groupdict()
                            await self._ws_handshake(
                                req, reader, writer, handler)
                            return
                    writer.write(Response.json(
                        {"error": "not found"}, 404).encode())
                    await writer.drain()
                    return

                resp = await self.dispatch(req)
                keep = req.header("connection", "").lower() != "close"
                writer.write(resp.encode(keep_alive=keep))
                await writer.drain()
                if not keep:
                    return
                first = False
        except ConnectionError:
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _ws_handshake(
        self, req: Request, reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter, handler: WSHandler,
    ) -> None:
        key = req.header("sec-websocket-key")
        if not key:
            writer.write(Response.json({"error": "bad handshake"}, 400).encode())
            await writer.drain()
            return
        accept = base64.b64encode(
            hashlib.sha1((key + WS_MAGIC).encode()).digest()
        ).decode()
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"upgrade: websocket\r\nconnection: Upgrade\r\n"
            + f"sec-websocket-accept: {accept}\r\n\r\n".encode()
        )
        await writer.drain()
        ws = WebSocket(reader, writer,
                       idle_timeout=self.ws_idle_timeout,
                       max_frame_bytes=self.max_ws_frame_bytes)
        try:
            await handler(req, ws)
        except ConnectionError:
            pass
        finally:
            await ws.close()

    # -- server ------------------------------------------------------------
    async def serve(self, host: str = "0.0.0.0", port: int = 8000):
        for fn in self._on_startup:
            await fn()
        server = await asyncio.start_server(
            self._handle_conn, host, port,
            limit=MAX_HEADER_BYTES,
        )
        log.info("serving on %s:%d", host, port)
        try:
            async with server:
                await server.serve_forever()
        finally:
            for fn in self._on_shutdown:
                await fn()

    def run(self, host: str = "0.0.0.0", port: int = 8000) -> None:
        try:
            asyncio.run(self.serve(host, port))
        except KeyboardInterrupt:
            pass
