"""Standard-library clients of the API (``audio_rag_tpu.api`` and
``audio_rag_tpu_torch.api`` alike), shared by ``tests/test_torch_api*.py``
and ``chip_smoke.py``'s ``api`` phase: a server on 127.0.0.1 port 0 in a
thread of its own (startup hooks, then serving, then shutdown hooks, as
``App.serve`` runs them), HTTP requests through ``http.client``, a
multipart body built by hand, and a raw-socket WebSocket client. This
module imports nothing but the standard library."""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import os
import socket
import struct
import sys
import threading
import uuid
from typing import Any

__all__ = ["Served", "request", "request_json", "multipart", "WSClient",
           "pcm_frames", "parse_metrics"]


class Served:
    """``app`` served on ``host`` at a port the OS picks (``.port``) by an
    event loop on its own thread; :meth:`stop` runs the app's shutdown
    hooks on that loop, cancels what is left and joins the thread."""

    def __init__(self, app, host: str = "127.0.0.1"):
        self.app = app
        self.host = host
        self.port: int | None = None
        self.loop = asyncio.new_event_loop()
        self._stop: asyncio.Event | None = None
        self._ready = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="api-server",
                                        daemon=True)
        self._thread.start()
        self._ready.wait(60)
        if self._error is not None:
            raise self._error
        if self.port is None:
            raise RuntimeError("the server did not start")

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self._serve())
        finally:
            pending = [t for t in asyncio.all_tasks(self.loop)
                       if not t.done()]
            for t in pending:
                t.cancel()
            if pending:
                self.loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            self.loop.close()

    async def _serve(self) -> None:
        limit = sys.modules[type(self.app).__module__].MAX_HEADER_BYTES
        self._stop = asyncio.Event()
        try:
            for fn in self.app._on_startup:
                await fn()
            server = await asyncio.start_server(
                self.app._handle_conn, self.host, 0, limit=limit)
        except BaseException as exc:
            self._error = exc
            self._ready.set()
            raise
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            async with server:
                await self._stop.wait()
        finally:
            for fn in self.app._on_shutdown:
                await fn()

    def stop(self) -> None:
        if self._thread.is_alive():
            self.loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(60)

    def __enter__(self) -> "Served":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def request(port: int, method: str, path: str, body: bytes | None = None,
            headers: dict[str, str] | None = None,
            timeout: float = 60.0) -> tuple[int, dict[str, str], bytes]:
    """One request on its own connection: (status, lower-cased headers,
    body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
    finally:
        conn.close()


def request_json(port: int, method: str, path: str, payload: Any = None,
                 headers: dict[str, str] | None = None,
                 raw: bytes | None = None, timeout: float = 60.0):
    """``payload`` as a JSON body (or ``raw`` bytes); returns (status,
    headers, the parsed JSON body or None)."""
    hdrs = dict(headers or {})
    body = raw
    if payload is not None:
        body = json.dumps(payload).encode()
    if body is not None:
        hdrs.setdefault("content-type", "application/json")
    status, rh, data = request(port, method, path, body, hdrs, timeout)
    try:
        parsed = json.loads(data) if data else None
    except ValueError:
        parsed = None
    return status, rh, parsed


def multipart(fields: dict[str, str],
              files: list[tuple[str, str, bytes, str]]
              ) -> tuple[bytes, str]:
    """A ``multipart/form-data`` body of text ``fields`` and ``files``
    ((field, filename, bytes, content type)); returns (body, the
    content-type header)."""
    boundary = uuid.uuid4().hex
    parts: list[bytes] = []
    for name, value in fields.items():
        parts.append(
            f'--{boundary}\r\ncontent-disposition: form-data; '
            f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    for name, filename, data, ctype in files:
        parts.append(
            f'--{boundary}\r\ncontent-disposition: form-data; '
            f'name="{name}"; filename="{filename}"\r\n'
            f'content-type: {ctype}\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


class WSClient:
    """A blocking RFC 6455 client on a raw socket: masked frames out,
    ``recv()`` → ("text", str) | ("bytes", bytes) | ("close", code)."""

    def __init__(self, port: int, path: str,
                 headers: dict[str, str] | None = None,
                 timeout: float = 60.0):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        self.sock.sendall(
            (f"GET {path} HTTP/1.1\r\nhost: 127.0.0.1\r\n"
             f"upgrade: websocket\r\nconnection: Upgrade\r\n"
             f"sec-websocket-key: {key}\r\nsec-websocket-version: 13\r\n"
             f"{extra}\r\n").encode())
        self._buf = b""
        while b"\r\n\r\n" not in self._buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("closed during the handshake")
            self._buf += chunk
        head, self._buf = self._buf.split(b"\r\n\r\n", 1)
        self.status = int(head.split(b"\r\n")[0].split()[1])
        if self.status != 101:
            raise ConnectionError(f"handshake answered {head!r}")

    def _send(self, opcode: int, payload: bytes) -> None:
        mask = os.urandom(4)
        n = len(payload)
        if n < 126:
            head = bytes([0x80 | opcode, 0x80 | n])
        elif n < (1 << 16):
            head = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n)
        else:
            head = bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(head + mask + masked)

    def send_text(self, s: str) -> None:
        self._send(0x1, s.encode())

    def send_json(self, data: Any) -> None:
        self.send_text(json.dumps(data))

    def send_bytes(self, b: bytes) -> None:
        self._send(0x2, b)

    def _read(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def recv(self) -> tuple[str, Any]:
        while True:
            b0, b1 = self._read(2)
            opcode, n = b0 & 0x0F, b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", self._read(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", self._read(8))
            payload = self._read(n) if n else b""
            if opcode == 0x1:
                return "text", payload.decode()
            if opcode == 0x2:
                return "bytes", payload
            if opcode == 0x8:
                return "close", (struct.unpack(">H", payload[:2])[0]
                                 if len(payload) >= 2 else None)

    def recv_json(self) -> dict:
        kind, data = self.recv()
        if kind != "text":
            raise ConnectionError(f"expected a text frame, got {kind} {data}")
        return json.loads(data)

    def close(self) -> None:
        try:
            self._send(0x8, struct.pack(">H", 1000))
        except OSError:
            pass
        self.sock.close()

    def __enter__(self) -> "WSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def pcm_frames(audio, sample_rate: int = 16000,
               seconds: float = 1.0) -> list[bytes]:
    """Float PCM (a sequence or array in [-1, 1]) as little-endian int16
    frames of ``seconds`` each."""
    step = int(sample_rate * seconds)
    out = []
    for i in range(0, len(audio), step):
        vals = [max(-32768, min(32767, round(float(x) * 32767)))
                for x in audio[i:i + step]]
        out.append(struct.pack(f"<{len(vals)}h", *vals))
    return out


def parse_metrics(text: str) -> dict[tuple[str, tuple], float]:
    """The exposition text as {(name, sorted label pairs): value}; a line
    that does not parse raises ValueError."""
    out: dict[tuple[str, tuple], float] = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        labels: tuple = ()
        if "{" in series:
            name, inner = series.split("{", 1)
            if not inner.endswith("}"):
                raise ValueError(f"bad series {line!r}")
            pairs = []
            for item in inner[:-1].split('",'):
                k, v = item.split('="', 1)
                pairs.append((k, v.rstrip('"')))
            labels = tuple(sorted(pairs))
        else:
            name = series
        if not name.replace("_", "").isalnum():
            raise ValueError(f"bad metric name {line!r}")
        out[(name, labels)] = float(value)
    return out
