"""The port's HTTP/WebSocket server (``audio_rag_tpu_torch/api/http.py``)
under misbehaving clients, against the JAX package's
(``audio_rag_tpu/api/http.py``): the raw-socket transcripts of
``tests/integration/test_http_hardening.py`` run against an ``App`` of
each package, built with the same tiny timeouts and caps and served on
127.0.0.1 at a port the OS picks, both at once; each transcript's outcome
(status line, close code, echoed frame, kept-alive replies) must be the
same from both, and the one the JAX test expects."""

import asyncio
import base64
import concurrent.futures as cf
import hashlib
import json
import socket
import struct

import pytest

from audio_rag_tpu.api import http as jhttp
from audio_rag_tpu_torch.api import http as thttp
from torch_api_client import Served

HOST = "127.0.0.1"
WS_KEY = base64.b64encode(b"0123456789abcdef").decode()


def make_app(http):
    app = http.App(header_timeout=0.5, body_timeout=0.5, ws_idle_timeout=0.5,
                   max_connections=3, max_ws_frame_bytes=1024)

    @app.get("/ping")
    async def ping(req):
        return http.Response.json({"ok": True})

    @app.post("/echo")
    async def echo(req):
        return http.Response.json({"n": len(req.body)})

    @app.websocket("/ws")
    async def ws_handler(req, ws):
        while True:
            msg = await ws.recv()
            if msg is None:
                return
            kind, data = msg
            await ws.send_json({"kind": kind, "n": len(data)})

    return app


@pytest.fixture(scope="module")
def ports():
    servers = [Served(make_app(http)) for http in (jhttp, thttp)]
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def status_line(out: bytes) -> bytes:
    return out.split(b"\r\n")[0]


async def _raw(port, data: bytes) -> bytes:
    r, w = await asyncio.open_connection(HOST, port)
    try:
        if data:
            w.write(data)
            await w.drain()
        return await asyncio.wait_for(r.read(65536), 5.0)
    finally:
        w.close()


# -- HTTP transcripts (test_http_hardening.py:100-194) ----------------------------------

async def normal_request(port):
    return await _raw(port, b"GET /ping HTTP/1.1\r\nhost: x\r\n\r\n")


async def slowloris_header_drip(port):
    return status_line(await _raw(port, b"GET /ping HTTP/1.1\r\nx-a: 1\r\n"))


async def stalled_body(port):
    head = (b"POST /echo HTTP/1.1\r\nhost: x\r\n"
            b"content-length: 1000\r\n\r\n")
    return status_line(await _raw(port, head + b"only-ten-b"))


async def oversized_headers(port):
    huge = (b"GET /ping HTTP/1.1\r\n" + b"x-pad: "
            + b"a" * (jhttp.MAX_HEADER_BYTES + 1024) + b"\r\n\r\n")
    r, w = await asyncio.open_connection(HOST, port)
    try:
        w.write(huge)
        try:
            await w.drain()
        except ConnectionError:
            pass
        try:
            out = await asyncio.wait_for(r.read(65536), 5.0)
        except ConnectionError:
            out = b""
    finally:
        w.close()
    # 431 when the server got to reply; a reset frees the task as well
    return b"431 or reset" if out == b"" or b"431" in status_line(out) \
        else status_line(out)


async def malformed_request_line(port):
    return status_line(await _raw(port, b"NONSENSE\r\n\r\n"))


async def connection_cap_sheds_then_releases(port):
    holders = []
    for _ in range(3):
        r, w = await asyncio.open_connection(HOST, port)
        w.write(b"GET /ping HTTP/1.1\r\n")  # partial: holds a slot
        await w.drain()
        holders.append((r, w))
    await asyncio.sleep(0.05)
    try:
        shed = status_line(await _raw(
            port, b"GET /ping HTTP/1.1\r\nhost: x\r\n\r\n"))
    finally:
        for _, hw in holders:
            hw.close()
    await asyncio.sleep(0.1)
    after = status_line(await _raw(
        port, b"GET /ping HTTP/1.1\r\nhost: x\r\n\r\n"))
    return shed, after


# -- WebSocket transcripts (test_http_hardening.py:196-315) ------------------------------

def _mask_frame(opcode: int, payload: bytes) -> bytes:
    mask = b"\x11\x22\x33\x44"
    n = len(payload)
    if n < 126:
        head = bytes([0x80 | opcode, 0x80 | n])
    elif n < (1 << 16):
        head = bytes([0x80 | opcode, 0x80 | 126]) + struct.pack(">H", n)
    else:
        head = bytes([0x80 | opcode, 0x80 | 127]) + struct.pack(">Q", n)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return head + mask + masked


async def _ws_connect(port):
    r, w = await asyncio.open_connection(HOST, port)
    w.write((f"GET /ws HTTP/1.1\r\nhost: x\r\nupgrade: websocket\r\n"
             f"connection: Upgrade\r\nsec-websocket-key: {WS_KEY}\r\n\r\n"
             ).encode())
    await w.drain()
    head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 5.0)
    assert b"101" in status_line(head)
    expect = base64.b64encode(hashlib.sha1(
        (WS_KEY + thttp.WS_MAGIC).encode()).digest())
    assert expect in head
    return r, w


async def _read_close_code(r):
    while True:
        hdr = await asyncio.wait_for(r.readexactly(2), 5.0)
        opcode, length = hdr[0] & 0x0F, hdr[1] & 0x7F
        if length == 126:
            (length,) = struct.unpack(
                ">H", await asyncio.wait_for(r.readexactly(2), 5.0))
        payload = (await asyncio.wait_for(r.readexactly(length), 5.0)
                   if length else b"")
        if opcode == 0x8:
            return struct.unpack(">H", payload[:2])[0] if payload else None


async def _read_json(r):
    hdr = await asyncio.wait_for(r.readexactly(2), 5.0)
    return json.loads(await asyncio.wait_for(
        r.readexactly(hdr[1] & 0x7F), 5.0))


async def ws_echo(port):
    r, w = await _ws_connect(port)
    w.write(_mask_frame(0x1, b"hello"))
    await w.drain()
    out = await _read_json(r)
    w.close()
    return out


async def ws_truncated_frame(port):
    r, w = await _ws_connect(port)
    w.write(b"\x81")  # half a frame header, then a stall
    await w.drain()
    code = await _read_close_code(r)
    w.close()
    return code


async def ws_idle(port):
    r, w = await _ws_connect(port)
    code = await _read_close_code(r)  # nothing sent at all
    w.close()
    return code


async def ws_oversized_frame(port):
    r, w = await _ws_connect(port)
    # declares 1 MB (the cap is 1024) and never sends it
    w.write(bytes([0x82, 0x80 | 127]) + struct.pack(">Q", 1 << 20)
            + b"\x00\x00\x00\x00")
    await w.drain()
    code = await _read_close_code(r)
    w.close()
    return code


async def ws_ping_resets_idle(port):
    r, w = await _ws_connect(port)
    pongs = []
    for _ in range(3):
        await asyncio.sleep(0.3)  # under the 0.5 s idle timeout each
        w.write(_mask_frame(0x9, b"hb"))
        await w.drain()
        hdr = await asyncio.wait_for(r.readexactly(2), 5.0)
        pongs.append(hdr[0] & 0x0F)
        await asyncio.wait_for(r.readexactly(hdr[1] & 0x7F), 5.0)
    # ~0.9 s in, past the idle timeout, and still served
    w.write(_mask_frame(0x1, b"ok"))
    await w.drain()
    out = await _read_json(r)
    w.close()
    return pongs, out


# -- keep-alive (test_http_hardening.py:318-376) --------------------------------------

def _response(s: socket.socket, buf: bytes = b"") -> tuple[bytes, bytes]:
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    head, rest = buf.split(b"\r\n\r\n", 1)
    clen = int([ln for ln in head.lower().split(b"\r\n")
                if ln.startswith(b"content-length")][0].split(b":")[1])
    while len(rest) < clen:
        rest += s.recv(4096)
    return head.lower(), rest[clen:]


async def two_requests_one_connection(port):
    s = socket.create_connection((HOST, port), timeout=5)
    out = []
    try:
        for _ in range(2):
            s.sendall(b"GET /ping HTTP/1.1\r\nHost: t\r\n\r\n")
            head, _ = _response(s)
            out.append((status_line(head),
                        b"connection: keep-alive" in head))
    finally:
        s.close()
    return out


async def connection_close_honored(port):
    s = socket.create_connection((HOST, port), timeout=5)
    try:
        s.sendall(b"GET /ping HTTP/1.1\r\nHost: t\r\n"
                  b"Connection: close\r\n\r\n")
        head, tail = _response(s)
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            tail += chunk
    finally:
        s.close()
    return b"connection: close" in head, tail


async def idle_keepalive_closes_silently(port):
    s = socket.create_connection((HOST, port), timeout=5)
    try:
        s.sendall(b"GET /ping HTTP/1.1\r\nHost: t\r\n\r\n")
        _, tail = _response(s)
        s.settimeout(3)  # idle past header_timeout (0.5 s)
        while True:
            chunk = s.recv(4096)
            if not chunk:
                break
            tail += chunk
    finally:
        s.close()
    return tail


CASES = {
    normal_request: None,  # checked below: the whole response
    slowloris_header_drip: b"HTTP/1.1 408 ",  # no reason phrase in either
    stalled_body: b"HTTP/1.1 408 ",
    oversized_headers: b"431 or reset",
    malformed_request_line: b"HTTP/1.1 400 Bad Request",
    connection_cap_sheds_then_releases: (
        b"HTTP/1.1 503 Service Unavailable", b"HTTP/1.1 200 OK"),
    ws_echo: {"kind": "text", "n": 5},
    ws_truncated_frame: 1001,
    ws_idle: 1001,
    ws_oversized_frame: 1009,
    ws_ping_resets_idle: ([0xA] * 3, {"kind": "text", "n": 2}),
    two_requests_one_connection: [(b"http/1.1 200 ok", True)] * 2,
    connection_close_honored: (True, b""),
    idle_keepalive_closes_silently: b"",
}


def _run(scenario, port):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(scenario(port))
    finally:
        loop.close()


@pytest.mark.parametrize("scenario", list(CASES),
                         ids=lambda f: f.__name__)
def test_misbehaving_clients_meet_the_jax_server(ports, scenario):
    with cf.ThreadPoolExecutor(2) as pool:
        jax_out, port_out = pool.map(lambda p: _run(scenario, p), ports)
    want = CASES[scenario]
    if want is None:  # the whole response, but its varying header values
        assert jax_out.split(b"\r\n\r\n")[1] == \
            port_out.split(b"\r\n\r\n")[1] == b'{"ok": true}'
        assert status_line(port_out) == b"HTTP/1.1 200 OK"
        return
    assert port_out == jax_out == want
