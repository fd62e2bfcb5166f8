"""The port's pooled HTTP/1.1 client (``seldon_core_tpu_torch/wire/h1client.py``)
against the cases of the JAX package's ``tests/test_h1client.py``: framing
modes, keep-alive recycling, stale-connection replay and the failure
classes a retry policy reads.  Every server is a loopback one."""

import asyncio
import time

import pytest
from aiohttp import web

from seldon_core_tpu_torch.wire.h1client import H1ConnectError, H1Pool, H1SentError

run = asyncio.run


async def _server(handler):
    app = web.Application()
    app.router.add_post("/echo", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, runner.addresses[0][1]


def test_roundtrip_and_keepalive_reuse():
    async def echo(request):
        return web.json_response({"got": (await request.read()).decode()})

    async def go():
        runner, port = await _server(echo)
        pool = H1Pool("127.0.0.1", port)
        try:
            for i in range(5):
                resp = await pool.post("/echo", f"b{i}".encode())
                assert resp.status == 200 and f"b{i}".encode() in resp.body
            # all five rode ONE recycled connection
            assert len(pool._idle) == 1 and pool.opened == 1
        finally:
            await pool.close()
            await runner.cleanup()

    run(go())


def test_extra_headers_forwarded():
    async def echo(request):
        return web.json_response({"tp": request.headers.get("traceparent", "")})

    async def go():
        runner, port = await _server(echo)
        pool = H1Pool("127.0.0.1", port)
        try:
            resp = await pool.post("/echo", b"{}", headers={"traceparent": "00-aa-bb-01"})
            assert b"00-aa-bb-01" in resp.body
        finally:
            await pool.close()
            await runner.cleanup()

    run(go())


def test_stale_keepalive_replays_once():
    async def echo(request):
        return web.json_response({"ok": True})

    async def go():
        runner, port = await _server(echo)
        pool = H1Pool("127.0.0.1", port)
        try:
            assert (await pool.post("/echo", b"{}")).status == 200
            # poison the idle socket as an upstream keep-alive timeout would
            _r, w = pool._idle[0]
            w.close()
            await asyncio.sleep(0.05)
            assert (await pool.post("/echo", b"{}")).status == 200  # on a fresh connection
            assert pool.opened == 2
        finally:
            await pool.close()
            await runner.cleanup()

    run(go())


def test_connect_refused_is_connect_error():
    async def go():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()  # the port is free again: nothing listens there
        with pytest.raises(H1ConnectError):
            await H1Pool("127.0.0.1", port).post("/echo", b"{}")

    run(go())


def test_chunked_response():
    async def chunked(request):
        resp = web.StreamResponse()
        resp.enable_chunked_encoding()
        await resp.prepare(request)
        await resp.write(b"hello ")
        await resp.write(b"world")
        await resp.write_eof()
        return resp

    async def go():
        runner, port = await _server(chunked)
        pool = H1Pool("127.0.0.1", port)
        try:
            assert (await pool.post("/echo", b"{}")).body == b"hello world"
        finally:
            await pool.close()
            await runner.cleanup()

    run(go())


def test_connection_close_response():
    async def close_after(request):
        resp = web.json_response({"bye": True})
        resp.headers["Connection"] = "close"
        return resp

    async def go():
        runner, port = await _server(close_after)
        pool = H1Pool("127.0.0.1", port)
        try:
            resp = await pool.post("/echo", b"{}")
            assert resp.status == 200 and b"bye" in resp.body
            assert pool._idle == []  # a closed connection is not recycled
        finally:
            await pool.close()
            await runner.cleanup()

    run(go())


def test_fresh_connection_death_is_sent_error():
    async def go():
        async def kill(reader, writer):
            await reader.read(64)  # the request partly read, then the connection dies
            writer.close()

        server = await asyncio.start_server(kill, "127.0.0.1", 0)
        pool = H1Pool("127.0.0.1", server.sockets[0].getsockname()[1])
        try:
            with pytest.raises(H1SentError):
                await pool.post("/echo", b"{}")
        finally:
            await pool.close()
            server.close()

    run(go())


def test_mid_response_death_on_reused_conn_does_not_replay():
    """Only a reused connection that died before any response byte replays:
    a death mid-response is an H1SentError (the upstream may have processed
    the request)."""
    served = {"n": 0}

    async def handler(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        await reader.readexactly(2)
        served["n"] += 1
        writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok")
        await writer.drain()
        # the second request on the SAME connection: a status line, then death
        await reader.readuntil(b"\r\n\r\n")
        await reader.readexactly(2)
        served["n"] += 1
        writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: 99\r\n\r\npart")
        await writer.drain()
        writer.close()

    async def go():
        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        pool = H1Pool("127.0.0.1", server.sockets[0].getsockname()[1])
        try:
            resp = await pool.post("/echo", b"{}")
            assert resp.status == 200 and resp.body == b"ok"
            with pytest.raises(H1SentError):
                await pool.post("/echo", b"{}")
            assert served["n"] == 2  # NOT replayed on a fresh connection
        finally:
            await pool.close()
            server.close()

    run(go())


def test_timeout_covers_connect():
    """The one budget covers the connect: a connect that never completes
    fails the post within its timeout (the connect is made to hang here,
    on loopback, in place of an unroutable address)."""

    class HangingConnect(H1Pool):
        async def _open(self):
            await asyncio.sleep(3600)

    async def go():
        pool = HangingConnect("127.0.0.1", 9)
        t0 = time.monotonic()
        with pytest.raises(asyncio.TimeoutError):
            await pool.post("/echo", b"{}", timeout=0.3)
        return time.monotonic() - t0

    assert run(go()) < 2.0
