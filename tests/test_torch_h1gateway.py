"""The port's h1 splice front (``seldon_core_tpu_torch/gateway/h1gateway.py``)
against the cases of the JAX package's ``tests/test_h1gateway.py``: the
splice hot path (auth, verbatim forward, keep-alive, pipelined
multiplexing), the fallback routes (oauth, ops, feedback), framing
strictness, chunked/SSE forwarding, engine failure, and the four guards the
JAX file carries (header-name strictness, the replay cap, an evicted pool
failing fast, backpressure in both directions).

Tolerance: statuses exact; every bad request's whole response (status line,
headers and JSON error body) byte-equal to the JAX front's on the same
bytes; replies equal after dropping ``puid``.  The upstream is the port's
engine (a ``SIMPLE_MODEL`` graph) or a loopback stub, in-process."""

import asyncio
import socket

import aiohttp
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from seldon_core_tpu.gateway.app import GatewayApp as JaxGatewayApp
from seldon_core_tpu.gateway.h1gateway import H1SpliceFrontend as JaxFrontend
from seldon_core_tpu.gateway.store import DeploymentRecord as JaxRecord
from seldon_core_tpu.gateway.store import DeploymentStore as JaxStore
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.gateway import h1gateway
from seldon_core_tpu_torch.gateway.app import GatewayApp
from seldon_core_tpu_torch.gateway.h1gateway import H1SpliceFrontend, _Job, _UpstreamPool
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore
from seldon_core_tpu_torch.graph.spec import PredictorSpec

run = asyncio.run

SIMPLE = {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}


async def _engine():
    app = EngineApp(PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu"))
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


def _record(cls, engine_port: int):
    return cls(name="dep", oauth_key="key1", oauth_secret="sec1", engine_host="127.0.0.1",
               engine_rest_port=engine_port)


async def _frontend(engine_port: int, jax: bool = False):
    store_cls, rec_cls, gw_cls, fe_cls = (
        (JaxStore, JaxRecord, JaxGatewayApp, JaxFrontend) if jax
        else (DeploymentStore, DeploymentRecord, GatewayApp, H1SpliceFrontend))
    store = store_cls()
    store.put(_record(rec_cls, engine_port))
    gw = gw_cls(store)
    frontend = fe_cls(gw)
    port = await frontend.start(0, host="127.0.0.1")
    return frontend, gw, port


async def _token(session: aiohttp.ClientSession, port: int) -> str:
    resp = await session.post(
        f"http://127.0.0.1:{port}/oauth/token",
        data={"grant_type": "client_credentials", "client_id": "key1", "client_secret": "sec1"},
    )
    assert resp.status == 200
    return (await resp.json())["access_token"]


async def _raw(port: int, payload: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(payload)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(4096), timeout=5)
    writer.close()
    return data


class TestSplicePredict:
    def test_predict_keepalive_and_ops(self):
        async def go():
            engine = await _engine()
            frontend, gw, port = await _frontend(engine.port)
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                hdrs = {"Authorization": f"Bearer {tok}"}
                out = []
                # three spliced requests over ONE keep-alive connection
                for _ in range(3):
                    r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                     json={"data": {"ndarray": [[1.0, 2.0]]}}, headers=hdrs)
                    out.append((r.status, await r.json()))
                ping = await s.get(f"http://127.0.0.1:{port}/ping")
                ready = await s.get(f"http://127.0.0.1:{port}/ready")
                prom = await s.get(f"http://127.0.0.1:{port}/prometheus")
                prom_text = await prom.text()
            await frontend.stop()
            await engine.close()
            return out, ping.status, ready.status, prom.status, prom_text, frontend.spliced

        out, ping, ready, prom, prom_text, spliced = run(go())
        assert all(st == 200 for st, _ in out) and spliced == 3
        assert out[0][1]["data"]["ndarray"] == [[0.1, 0.9, 0.5]]
        assert (ping, ready, prom) == (200, 200, 200)
        assert "ingress" in prom_text

    def test_auth_rejected_on_splice_path(self):
        async def go():
            engine = await _engine()
            frontend, gw, port = await _frontend(engine.port)
            async with aiohttp.ClientSession() as s:
                r1 = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions", json={})
                b1 = await r1.json()
                r2 = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions", json={},
                                  headers={"Authorization": "Bearer junk"})
                # the connection stays usable after an auth failure
                tok = await _token(s, port)
                r3 = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                  json={"data": {"ndarray": [[1.0]]}},
                                  headers={"Authorization": f"Bearer {tok}"})
            await frontend.stop()
            await engine.close()
            return r1.status, b1, r2.status, r3.status

        s1, b1, s2, s3 = run(go())
        assert s1 == 401 and b1["status"]["code"] == 401
        assert s2 == 401 and s3 == 200

    def test_concurrent_requests_multiplex(self):
        async def go():
            engine = await _engine()
            frontend, gw, port = await _frontend(engine.port)
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                hdrs = {"Authorization": f"Bearer {tok}"}

                async def one(i):
                    r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                     json={"data": {"ndarray": [[float(i), 2.0]]}}, headers=hdrs)
                    return r.status, (await r.json())["status"]["code"]

                results = await asyncio.gather(*(one(i) for i in range(24)))
                n_conns = len(next(iter(frontend._pools.values())).conns)
            await frontend.stop()
            await engine.close()
            return results, n_conns

        results, n_conns = run(go())
        assert all(r == (200, 200) for r in results)
        assert 1 <= n_conns <= h1gateway._MAX_UPSTREAM_CONNS

    def test_feedback_fallback_and_reward(self):
        async def go():
            engine = await _engine()
            frontend, gw, port = await _frontend(engine.port)
            fb = gw.metrics.feedback_reward.labels("dep", "dep", "gateway")
            before = fb.get()
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/feedback",
                                 json={"reward": 1.0},
                                 headers={"Authorization": f"Bearer {tok}"})
                status = r.status
            await frontend.stop()
            await engine.close()
            return status, fb.get() - before, frontend.fallbacks

        status, moved, fallbacks = run(go())
        assert status == 200 and moved == 1.0 and fallbacks == 2  # the token and the feedback

    def test_engine_down_gives_503(self):
        async def go():
            frontend, gw, port = await _frontend(1)  # port 1: refused
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                 json={"data": {"ndarray": [[1.0]]}},
                                 headers={"Authorization": f"Bearer {tok}"})
                body = await r.json()
            await frontend.stop()
            return r.status, body

        status, body = run(go())
        assert status == 503 and body["status"]["code"] == 503


# each bad request, sent raw to both fronts: the whole response must be
# byte-equal (status line, headers, JSON error body)
BAD_REQUESTS = {
    "bad_content_length": b"POST /api/v0.1/predictions HTTP/1.1\r\nhost: x\r\n"
                          b"content-length: 5_0\r\n\r\n",
    "conflicting_content_lengths": b"POST /api/v0.1/predictions HTTP/1.1\r\nhost: x\r\n"
                                   b"content-length: 3\r\ncontent-length: 5\r\n\r\nabc",
    "chunked_upload": b"POST /api/v0.1/predictions HTTP/1.1\r\nhost: x\r\n"
                      b"transfer-encoding: chunked\r\n\r\n",
    "whitespace_before_colon": b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                               b"Content-Length : 2\r\n\r\n{}",
    "obs_fold_continuation": b"POST /api/v0.1/predictions HTTP/1.1\r\nx-first: a\r\n"
                             b" folded-continuation\r\ncontent-length: 2\r\n\r\n{}",
    "control_chars_in_name": b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                             b"x\x01bad: a\r\ncontent-length: 2\r\n\r\n{}",
    "malformed_request_line": b"POST /api/v0.1/predictions\r\ncontent-length: 0\r\n\r\n",
    "no_token": b"POST /api/v0.1/predictions HTTP/1.1\r\nhost: x\r\n"
                b"content-length: 2\r\nconnection: close\r\n\r\n{}",
    "junk_token": b"POST /api/v0.1/predictions HTTP/1.1\r\nauthorization: Bearer junk\r\n"
                  b"content-length: 2\r\nconnection: close\r\n\r\n{}",
    "wrong_secret": b"POST /oauth/token HTTP/1.1\r\ncontent-length: 37\r\n"
                    b"connection: close\r\n\r\nclient_id=key1&client_secret=not-sec1",
    "unknown_route": b"GET /nope HTTP/1.1\r\nconnection: close\r\n\r\n",
    "bad_basic_auth": b"POST /oauth/token HTTP/1.1\r\nauthorization: Basic /w==\r\n"
                      b"content-length: 0\r\nconnection: close\r\n\r\n",
    "timeline_without_trace": b"GET /stats/timeline HTTP/1.1\r\nconnection: close\r\n\r\n",
}
STATUS = {"bad_content_length": 400, "conflicting_content_lengths": 400, "chunked_upload": 411,
          "whitespace_before_colon": 400, "obs_fold_continuation": 400,
          "control_chars_in_name": 400, "malformed_request_line": 400, "no_token": 401,
          "junk_token": 401, "wrong_secret": 401, "unknown_route": 404, "bad_basic_auth": 400,
          "timeline_without_trace": 400}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_request_answers_byte_equal_to_the_jax_front(case):
    """Status exact, and the whole response byte-equal to the JAX front's."""
    async def go():
        out = []
        for jax in (True, False):
            frontend, gw, port = await _frontend(1, jax=jax)
            out.append(await _raw(port, BAD_REQUESTS[case]))
            await frontend.stop()
        return out

    want, got = run(go())
    assert got.split(b"\r\n")[0] == b"HTTP/1.1 %d %s" % (STATUS[case],
                                                         h1gateway._REASONS[STATUS[case]])
    assert got == want


class TestChunkedResponseSplice:
    def test_chunked_stream_forwards(self):
        """SSE-shaped chunked responses forward through the splice."""
        async def go():
            async def stream(request):
                resp = web.StreamResponse()
                resp.content_type = "text/event-stream"
                resp.enable_chunked_encoding()
                await resp.prepare(request)
                for i in range(3):
                    await resp.write(f"data: tok{i}\n\n".encode())
                await resp.write_eof()
                return resp

            app = web.Application()
            app.router.add_post("/api/v0.1/predictions/stream", stream)
            engine = TestClient(TestServer(app))
            await engine.start_server()
            frontend, gw, port = await _frontend(engine.server.port)
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions/stream",
                                 data=b"{}", headers={"Authorization": f"Bearer {tok}"})
                body = await r.content.read()
                status = r.status
            await frontend.stop()
            await engine.close()
            return status, body

        status, body = run(go())
        assert status == 200 and body.count(b"data: tok") == 3


class TestUpstreamReplayCap:
    def test_engine_that_always_closes_yields_502(self):
        """An engine that answers by closing the connection exhausts the
        replay budget (2) and fails the client with 502."""
        async def go():
            connects = []

            async def handle(reader, writer):
                connects.append(1)
                await reader.read(64)
                writer.close()

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            frontend, gw, port = await _frontend(server.sockets[0].getsockname()[1])
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                 json={"data": {"ndarray": [[1.0]]}},
                                 headers={"Authorization": f"Bearer {tok}"})
                status, body = r.status, await r.json()
            await frontend.stop()
            server.close()
            await server.wait_closed()
            return status, body, len(connects)

        status, body, connects = run(go())
        assert status == 502 and body["status"]["code"] == 502
        assert connects == 1 + h1gateway._MAX_REPLAYS == 3


class TestEvictedPoolFailsFast:
    def test_spawn_send_on_closed_pool_fails_job_promptly(self):
        """A connect that lands after the pool was evicted fails the job
        and the parked one with a prompt 503, not at the 504 reaper."""
        async def go():
            async def handle(reader, writer):
                await reader.read()  # until the gateway closes its end
                writer.close()

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            fails = []

            class Down:
                def upstream_failed(self, reason, forwarded, status=503):
                    fails.append((reason, forwarded, status))

            pool = _UpstreamPool("127.0.0.1", server.sockets[0].getsockname()[1],
                                 asyncio.get_running_loop())
            pool.closed = True
            pool.pending.append(_Job(Down(), b"POST /y HTTP/1.1\r\ncontent-length: 0\r\n\r\n",
                                     False))
            pool.spawn_send(_Job(Down(), b"POST /x HTTP/1.1\r\ncontent-length: 0\r\n\r\n", False))
            for _ in range(100):
                if len(fails) >= 2:
                    break
                await asyncio.sleep(0.02)
            server.close()
            await server.wait_closed()
            return fails

        assert run(go()) == [("deployment removed", False, 503)] * 2


class TestSpliceBackpressure:
    def test_pipelined_flood_pauses_downstream_reads(self):
        """A client pipelining ahead of its response parks in the kernel
        buffer: the front pauses its reads past the cap."""
        async def go():
            release = asyncio.Event()

            async def handle(reader, writer):
                await reader.readuntil(b"\r\n\r\n")
                await release.wait()
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: application/json\r\n"
                             b"content-length: 2\r\n\r\n{}")
                await writer.drain()
                await reader.read()
                writer.close()

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            frontend, gw, port = await _frontend(server.sockets[0].getsockname()[1])
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                         + f"authorization: Bearer {tok}\r\n".encode()
                         + b"content-length: 2\r\n\r\n{}")
            await writer.drain()
            writer.write(b"X" * (1 << 20))  # 1 MB pipelined while the reply is pending
            paused = None
            for _ in range(200):
                await asyncio.sleep(0.01)
                paused = next((c for c in frontend._conns if c._read_paused), None)
                if paused is not None:
                    break
            buffered = len(paused.buf) if paused is not None else -1
            release.set()
            data = await asyncio.wait_for(reader.read(200), timeout=5)
            writer.close()
            await frontend.stop()
            server.close()
            await server.wait_closed()
            return paused is not None, buffered, data

        paused, buffered, data = run(go())
        assert paused and 0 <= buffered < (1 << 19), buffered
        assert data.startswith(b"HTTP/1.1 200")

    def test_fast_engine_stream_pauses_upstream_reads(self):
        """A fast engine response toward a client that does not read pauses
        the engine connection's reads; the stream then completes intact."""
        async def go():
            total = 4 * (1 << 20)

            async def handle(reader, writer):
                await reader.readuntil(b"\r\n\r\n")
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: application/octet-stream\r\n"
                             + b"content-length: %d\r\n\r\n" % total)
                chunk = b"Y" * (1 << 16)
                for _ in range(total // len(chunk)):
                    writer.write(chunk)
                    await writer.drain()
                await reader.read()
                writer.close()

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            frontend, gw, port = await _frontend(server.sockets[0].getsockname()[1])
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
            sock = socket.socket()
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8192)
            sock.connect(("127.0.0.1", port))
            reader, writer = await asyncio.open_connection(sock=sock, limit=1 << 16)
            writer.write(b"POST /api/v0.1/predictions HTTP/1.1\r\n"
                         + f"authorization: Bearer {tok}\r\n".encode()
                         + b"content-length: 2\r\n\r\n{}")
            await writer.drain()
            for _ in range(100):
                await asyncio.sleep(0.01)
                if frontend._conns:
                    for c in frontend._conns:
                        if c.transport is not None:
                            c.transport.set_write_buffer_limits(high=4096)
                    break
            saw_pause = False
            for _ in range(500):
                await asyncio.sleep(0.01)
                if any(c._write_paused and c._up_paused is not None for c in frontend._conns):
                    saw_pause = True
                    break
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), timeout=10)
            got = 0
            while got < total:
                blob = await asyncio.wait_for(reader.read(1 << 20), timeout=10)
                if not blob:
                    break
                got += len(blob)
            writer.close()
            await frontend.stop()
            server.close()
            await server.wait_closed()
            return saw_pause, head, got

        saw_pause, head, got = run(go())
        assert saw_pause, "a fast engine stream never paused the upstream reads"
        assert head.startswith(b"HTTP/1.1 200") and got == 4 * (1 << 20)


def test_gw_h1_chaos_site_kills_the_upstream_conn():
    """``gw.h1``: the splice's upstream send under a plan; a reset on the
    first arrival is replayed on a fresh connection and the request
    answers 200 (the site counts one arrival per send)."""
    from seldon_core_tpu_torch import chaos

    async def go():
        engine = await _engine()
        frontend, gw, port = await _frontend(engine.port)
        chaos.configure("gw.h1:reset:only=1")
        try:
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                 json={"data": {"ndarray": [[1.0]]}},
                                 headers={"Authorization": f"Bearer {tok}"})
                status = r.status
            return status, chaos.snapshot()
        finally:
            chaos.reset()
            await frontend.stop()
            await engine.close()

    status, snap = run(go())
    assert status == 200
    assert snap["arrivals"]["gw.h1"] == 2 and snap["fired"]["gw.h1"] == 1


def test_a_refused_replica_moves_to_another_and_opens_its_breaker():
    """Beyond the JAX front: a two-replica record whose first replica
    refuses every connect.  Each spliced request p2c sends there is moved
    to the live replica (it was never sent) and answers 200; the failures
    open the dead replica's breaker, after which it is no longer picked."""
    async def go():
        engine = await _engine()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))  # bound, never listening: connects are refused
        dead_key = f"127.0.0.1:{dead.getsockname()[1]}"
        store = DeploymentStore()
        store.put(DeploymentRecord(name="dep", oauth_key="key1", oauth_secret="sec1",
                                   endpoints=(dead_key, f"127.0.0.1:{engine.port}")))
        gw = GatewayApp(store)
        frontend = H1SpliceFrontend(gw)
        port = await frontend.start(0, host="127.0.0.1")
        try:
            async with aiohttp.ClientSession() as s:
                tok = await _token(s, port)
                codes = []
                for i in range(8):
                    r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                     json={"data": {"ndarray": [[float(i)]]}},
                                     headers={"Authorization": f"Bearer {tok}"})
                    codes.append(r.status)
            snap = gw.router.snapshot()
            return codes, frontend.rerouted, snap["deployments"]["key1"][dead_key], snap
        finally:
            await frontend.stop()
            await gw.close()
            await engine.close()
            dead.close()

    codes, rerouted, dead_st, snap = run(go())
    assert codes == [200] * 8
    assert rerouted == dead_st["picked"] == snap["cb_fails"] == 3
    assert dead_st["breaker"]["open"] and snap["cb_opens"] == 1 and snap["cb_skipped_picks"] >= 1
