"""The port's telemetry plane on the CPU, against the JAX package.

* trace context (``obs/spans.py``): the JAX package's cases
  (``tests/test_obs.py`` TestTraceContext) and the same answers as
  ``utils/tracectx.py``; the engine echoes ``x-sct-trace-id``;
* wire accounting (``obs/wire.py``): the engine's front counts exactly the
  request and reply bodies, the REST hop to a wrapper runtime exactly the
  bytes the runtime read and wrote;
* the engine's ``/stats/wire``, ``/stats/summary`` and ``/stats/warmup``
  carry the JAX engine's keys, ``/stats/warmup`` every bucket;
* ``/profile/start`` and ``/profile/stop`` on ``torch.profiler`` write a
  Chrome trace; a second start and a stop with none running are 409s, a
  directory that cannot be made a 500;
* the loop-lag probe and the span gauges reach ``/prometheus`` and the
  probe stops when its server closes; the wrapper runtime serves
  ``/prometheus``;
* ``otlp_payload`` equals the JAX one for spans with the same fields (the
  instrumentation scope's name aside: the port's package name); the
  OTLP exporter posts to a stdlib collector; a dead collector never
  blocks ``offer``;
* the handoff keeps its trace: for the same traced request on ``tiny``
  (float32) the port's frame carries the JAX frame's envelope
  (``traceparent``, ``origin_span``, priority), and the JAX encoder makes
  the same bytes of the port's KV and envelope.
"""

import asyncio
import json
import os
import re
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from seldon_core_tpu.disagg import handoff as jh
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.obs import export as jexport
from seldon_core_tpu.obs.spans import Span as JaxSpan
from seldon_core_tpu.utils import tracectx as jtc
from seldon_core_tpu_torch.disagg import handoff as th
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.generation import GenerativeModel
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax
from seldon_core_tpu_torch.obs import LOOP_LAG, RECORDER, WIRE, export, spans
from seldon_core_tpu_torch.obs.spans import Span
from seldon_core_tpu_torch.runtime.server import MicroserviceApp

run = asyncio.run
TRACEPARENT_RE = re.compile(r"^00-[0-9a-f]{32}-[0-9a-f]{16}-0[01]$")
SIMPLE = {"name": "simple", "graph": {"name": "m", "type": "MODEL",
                                      "implementation": "SIMPLE_MODEL"}}


def _call(port, path, body=None, headers=None, method=None):
    """-> (status, headers, body bytes)."""
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})},
                                 method=method or ("POST" if data is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, {k.lower(): v for k, v in r.headers.items()}, r.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


async def _engine(spec=SIMPLE, **kw):
    app = EngineApp(PredictionService(PredictorSpec.from_dict(spec), device="cpu"), **kw)
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


async def _jax_client(spec=SIMPLE):
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.engine.app import EngineApp as JaxEngine
    from seldon_core_tpu.engine.service import PredictionService as JaxService
    from seldon_core_tpu.graph.spec import PredictorSpec as JaxSpec

    client = TestClient(TestServer(JaxEngine(JaxService(JaxSpec.model_validate(spec))).build()))
    await client.start_server()
    return client


# ------------------------------------------------------------ trace context


class TestTraceContext:
    def test_new_traceparent_is_spec_valid(self):
        for _ in range(50):
            tp = spans.new_traceparent()
            assert TRACEPARENT_RE.match(tp), tp
            trace_id, span_id, flags = spans.parse_traceparent(tp)
            assert trace_id != "0" * 32 and span_id != "0" * 16
            assert flags & 0x01

    def test_parse_rejects_malformed_as_the_jax_parser_does(self):
        cases = [
            None, "", "junk", "00-abc-def-01",
            "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
            "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
            "ff-" + "1" * 32 + "-" + "2" * 16 + "-01",
            "00-" + "Z" * 32 + "-" + "2" * 16 + "-01",
            "00-" + "a" * 32 + "-" + "b" * 16 + "-00",
            "01-" + "a" * 32 + "-" + "b" * 16 + "-01-extra",
        ]
        for tp in cases:
            assert spans.parse_traceparent(tp) == jtc.parse_traceparent(tp), tp
        assert all(spans.parse_traceparent(tp) is None for tp in cases[:8])

    def test_ensure_generates_and_keeps(self):
        async def go():
            spans.set_traceparent(None)
            tp, generated = spans.ensure_traceparent()
            assert generated and TRACEPARENT_RE.match(tp)
            tp2, generated2 = spans.ensure_traceparent()
            assert not generated2 and tp2 == tp
            spans.set_traceparent("not-a-traceparent")
            tp3, generated3 = spans.ensure_traceparent()
            assert generated3 and TRACEPARENT_RE.match(tp3)

        run(go())

    @pytest.mark.parametrize("tp", [None, "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                                    "00-" + "a" * 32 + "-" + "b" * 16 + "-00", "junk"])
    def test_current_trace_id_sampled_and_outgoing_headers_match_jax(self, tp):
        async def go():
            spans.set_traceparent(tp)
            jtc.set_traceparent(tp)
            return ((spans.current_trace_id(), spans.is_sampled(), spans.outgoing_headers()),
                    (jtc.current_trace_id(), jtc.is_sampled(), jtc.outgoing_headers()))

        mine, jax_ = run(go())
        assert mine == jax_
        assert spans.TRACE_RESPONSE_HEADER == jtc.TRACE_RESPONSE_HEADER == "x-sct-trace-id"

    def test_the_engine_echoes_the_trace_id(self):
        tid = "c" * 32

        async def go():
            app = await _engine()
            try:
                body = {"data": {"ndarray": [[1.0, 2.0]]}}
                traced = await asyncio.to_thread(
                    _call, app.port, "/api/v0.1/predictions", body,
                    {"traceparent": f"00-{tid}-{'d' * 16}-01"})
                fresh = await asyncio.to_thread(_call, app.port, "/api/v0.1/predictions", body)
                ping = await asyncio.to_thread(_call, app.port, "/ping")
                return traced, fresh, ping
            finally:
                await app.close()

        traced, fresh, ping = run(go())
        assert traced[0] == 200 and traced[1]["x-sct-trace-id"] == tid
        minted = fresh[1]["x-sct-trace-id"]
        assert re.fullmatch("[0-9a-f]{32}", minted) and minted != tid
        assert any(t["trace_id"] == minted for t in RECORDER.recent_traces(50))
        assert "x-sct-trace-id" not in ping[1]  # no route span, no trace


# ------------------------------------------------------------------- wire


class _Doubler:
    def predict(self, X, names):
        return np.asarray(X) * 2


def test_wire_bytes_equal_the_bodies_at_the_front_and_on_the_rest_hop():
    seen = {"in": 0, "out": 0}

    async def go():
        rt = MicroserviceApp(_Doubler(), name="dbl")
        inner = rt.dispatch

        async def counting(method, path, body, headers):
            reply = await inner(method, path, body, headers)
            seen["in"] += len(body)
            seen["out"] += len(reply[1])
            return reply

        rt.dispatch = counting
        await rt.start("127.0.0.1", 0)
        spec = {"name": "wiredep", "graph": {"name": "dbl", "type": "MODEL", "endpoint": {
            "service_host": "127.0.0.1", "service_port": rt.port, "type": "REST"}}}
        app = await _engine(spec)
        front = WIRE.counter("engine-rest", "wiredep")
        node = WIRE.counter("engine-node", "dbl")
        base = [(c.requests, c.bytes_in, c.bytes_out) for c in (front, node)]
        sent = recv = 0
        try:
            for rows in ([[1.0]], [[1.0, 2.0], [3.0, 4.0]], [[5.5] * 7]):
                body = json.dumps({"data": {"ndarray": rows}}).encode()
                status, _, reply = await asyncio.to_thread(
                    _call, app.port, "/api/v0.1/predictions", body)
                assert status == 200
                sent, recv = sent + len(body), recv + len(reply)
        finally:
            await app.close()
            await rt.close()
        return base, [(c.requests, c.bytes_in, c.bytes_out) for c in (front, node)], sent, recv

    base, after, sent, recv = run(go())
    (f0, n0), (f1, n1) = base, after
    assert (f1[0] - f0[0], f1[1] - f0[1], f1[2] - f0[2]) == (3, sent, recv)
    # the client edge: out = what the runtime read, in = what it wrote
    assert (n1[0] - n0[0], n1[2] - n0[2], n1[1] - n0[1]) == (3, seen["in"], seen["out"])


def test_stats_payload_keys_equal_the_jax_engines():
    async def jax_side():
        client = await _jax_client()
        try:
            return {p: await (await client.get(p)).json()
                    for p in ("/stats/wire", "/stats/summary", "/stats/warmup")}
        finally:
            await client.close()

    async def port_side():
        app = await _engine()
        try:
            return {p: json.loads((await asyncio.to_thread(_call, app.port, p))[2])
                    for p in ("/stats/wire", "/stats/summary", "/stats/warmup")}
        finally:
            await app.close()

    want, got = run(jax_side()), run(port_side())
    for path in want:
        assert set(got[path]) == set(want[path]), path
    assert set(got["/stats/wire"]["loop_lag"]) == set(want["/stats/wire"]["loop_lag"])
    assert set(got["/stats/wire"]["wire"]) == {"stages", "totals"}
    assert set(got["/stats/summary"]["wire"]) == set(want["/stats/summary"]["wire"])
    assert set(got["/stats/warmup"]["warmup"]) == set(want["/stats/warmup"]["warmup"])


def test_stats_warmup_lists_every_bucket():
    spec = {"name": "zoo", "graph": {
        "name": "mlp", "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
            {"name": "family", "value": "mlp", "type": "STRING"},
            {"name": "preset", "value": "tiny", "type": "STRING"},
            {"name": "buckets", "value": "1,2,4", "type": "STRING"}]}}

    async def go():
        app = await _engine(spec)
        try:
            return json.loads((await asyncio.to_thread(_call, app.port, "/stats/warmup"))[2])
        finally:
            await app.close()

    w = run(go())["warmup"]
    assert w["warmed"] is True and w["error"] is None and w["total_seconds"] > 0
    assert w["programs"] == {"mlp": 3} and w["seconds"]["mlp"] >= 0
    assert w["variants"] == {"mlp": ["bucket:1", "bucket:2", "bucket:4"]}


# --------------------------------------------------------------- profiler


def test_profile_start_stop_and_conflict(tmp_path):
    target = str(tmp_path / "capture" / "run1")
    blocker = tmp_path / "a-file"
    blocker.write_text("x")

    async def go():
        app = await _engine()
        try:
            call = lambda *a: asyncio.to_thread(_call, app.port, *a)  # noqa: E731
            r1 = await call("/profile/start", {"dir": target})
            exists = os.path.isdir(target)
            r2 = await call("/profile/start", {"dir": target})
            await call("/api/v0.1/predictions", {"data": {"ndarray": [[1.0]]}})
            r3 = await call("/profile/stop", {})
            r4 = await call("/profile/stop", {})
            r5 = await call("/profile/start", {"dir": str(blocker / "sub")})
            r6 = await call("/profile/start", None, None, "GET")
            return r1, exists, r2, r3, r4, r5, r6
        finally:
            await app.close()

    r1, exists, r2, r3, r4, r5, r6 = run(go())
    b1 = json.loads(r1[2])
    assert r1[0] == 200 and b1 == {"status": "profiling", "dir": target} and exists
    assert r2[0] == 409 and json.loads(r2[2])["dir"] == target
    b3 = json.loads(r3[2])
    assert r3[0] == 200 and b3["dir"] == target and b3["status"] == "stopped"
    trace = json.loads(open(b3["trace"]).read())
    assert trace["traceEvents"], "the Chrome trace holds events"
    assert r4[0] == 409 and r5[0] == 500 and r6[0] == 405


# -------------------------------------------------------------- the probes


def test_loop_lag_and_span_gauges_reach_prometheus_and_stop_with_the_engine(monkeypatch):
    monkeypatch.setattr(LOOP_LAG, "interval_s", 0.02)

    async def go():
        app = await _engine()
        try:
            await asyncio.sleep(0.1)
            status, headers, prom = await asyncio.to_thread(_call, app.port, "/prometheus")
            wire = json.loads((await asyncio.to_thread(_call, app.port, "/stats/wire"))[2])
            running = LOOP_LAG.running
        finally:
            await app.close()
        return status, headers, prom.decode(), wire, running, LOOP_LAG.running

    status, headers, prom, wire, running, after = run(go())
    assert status == 200 and headers["content-type"].startswith("text/plain; version=0.0.4")
    for fam in ("seldon_eventloop_lag_seconds", "seldon_obs_spans", "seldon_obs_span_export",
                "seldon_wire_bytes"):
        assert fam in prom
    assert 'seldon_eventloop_lag_seconds{service="engine"}' in prom
    assert 'seldon_obs_spans{state="recorded"}' in prom
    assert wire["loop_lag"]["samples"] >= 1 and running and not after


def test_the_runtime_serves_prometheus():
    async def go():
        rt = MicroserviceApp(_Doubler(), name="dbl")
        await rt.start("127.0.0.1", 0)
        try:
            return await asyncio.to_thread(_call, rt.port, "/prometheus"), LOOP_LAG.running
        finally:
            await rt.close()

    (status, headers, body), running = run(go())
    assert status == 200 and b"# TYPE seldon_api_engine_server_requests_duration_seconds" in body
    assert running and not LOOP_LAG.running


# --------------------------------------------------------------- exporters


def _span_pairs(n=3):
    kw = [dict(trace_id="ab" * 16, span_id=f"{i:016x}", parent_id=None if i == 1 else "1" * 16,
               name=f"s{i}", service="svc", start=1000.0 + i, duration_s=0.25,
               status="ERROR" if i == 2 else "OK",
               attrs={"code": 200, "ok": True, "ratio": 0.5, "who": "x"},
               events=[("first-token", 1000.5, {"ms": 1.5})]) for i in range(1, n + 1)]
    return [Span(**k) for k in kw], [JaxSpan(**k) for k in kw]


def _unscoped(payload: dict) -> dict:
    """The payload with its instrumentation scope's name cleared: the port
    exports under its own package's name."""
    payload["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] = ""
    return payload


def test_otlp_payload_equals_the_jax_payload_but_for_its_scope():
    mine, theirs = _span_pairs()
    assert export.otlp_payload(mine)["resourceSpans"][0]["scopeSpans"][0]["scope"] == {
        "name": "seldon_core_tpu_torch.obs"}
    assert _unscoped(export.otlp_payload(mine)) == _unscoped(jexport.otlp_payload(theirs))
    assert (_unscoped(export.otlp_payload(mine, "svc"))
            == _unscoped(jexport.otlp_payload(theirs, "svc")))
    json.dumps(export.otlp_payload(mine))


async def _collector(received: list):
    """A stdlib OTLP/HTTP collector: every POST body, parsed, into ``received``."""

    async def handle(reader, writer):
        while True:
            line = await reader.readline()
            if not line:
                break
            length = 0
            while (h := await reader.readline()) not in (b"\r\n", b""):
                name, _, value = h.decode().partition(":")
                if name.strip().lower() == "content-length":
                    length = int(value)
            received.append(json.loads(await reader.readexactly(length)))
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\n{}")
            await writer.drain()
        writer.close()

    return await asyncio.start_server(handle, "127.0.0.1", 0)


def test_otlp_exporter_posts_to_a_collector():
    received: list = []

    async def go():
        srv = await _collector(received)
        port = srv.sockets[0].getsockname()[1]
        exp = export.OtlpJsonExporter(f"http://127.0.0.1:{port}/v1/traces", timeout_s=2.0)
        for s in _span_pairs(3)[0]:
            exp.offer(s)
        deadline = time.monotonic() + 5
        while exp.exported < 3 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        await exp.close()
        srv.close()
        return exp.exported, exp.dropped

    exported, dropped = run(go())
    assert (exported, dropped) == (3, 0)
    names = [s["name"] for r in received for s in r["resourceSpans"][0]["scopeSpans"][0]["spans"]]
    assert names == ["s1", "s2", "s3"]


def test_a_dead_collector_never_blocks_offer():
    import socket

    with socket.socket() as sock:  # a port nothing listens on
        sock.bind(("127.0.0.1", 0))
        socket_port = sock.getsockname()[1]

    async def go():
        exp = export.OtlpJsonExporter(f"http://127.0.0.1:{socket_port}/v1/traces",
                                      timeout_s=0.05, max_queue=32)
        t0 = time.perf_counter()
        for s in _span_pairs(200)[0]:
            exp.offer(s)
        cost = time.perf_counter() - t0
        await asyncio.sleep(0.3)
        await exp.close()
        return cost, exp

    cost, dead = run(go())
    assert cost < 0.5, "offer must never block"
    assert dead.dropped >= 200 - 32 and dead.exported == 0
    exp = export.OtlpJsonExporter("http://127.0.0.1:9/v1/traces")
    for s in _span_pairs(3)[0]:
        exp.offer(s)  # no running loop: dropped, never raised
    assert exp.dropped == 3


def test_exporters_from_env():
    assert export.exporters_from_env({}) == []
    (otlp,) = export.exporters_from_env({"SCT_OTLP_ENDPOINT": "http://127.0.0.1:4318/v1/traces"})
    assert isinstance(otlp, export.OtlpJsonExporter) and otlp.endpoint.endswith("/v1/traces")
    with pytest.raises(ValueError, match="SCT_SPANS_BROKER"):
        export.exporters_from_env({"SCT_SPANS_BROKER": "127.0.0.1:7780"})
    with pytest.raises(ValueError, match="http://"):
        export.OtlpJsonExporter("grpc://collector:4317")


# ------------------------------------------------- the handoff keeps its trace


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def test_the_handoff_frame_carries_the_jax_envelope_and_byte_equal_kv(tiny):
    """The port's frame for a traced request: the JAX frame's envelope
    (traceparent, origin_span = the export span's id, priority, the
    request's fields), KV within 1e-5 of the JAX export's (float32 on two
    frameworks), and byte for byte the frame the JAX encoder makes of the
    port's KV and envelope.  Before the repair the port's frame had no
    traceparent, so the decode engine began a new trace."""
    cfg, jparams, tcfg, tparams = tiny
    prompt = np.asarray(list(range(3, 40)), np.int32)
    tp = f"00-{'e' * 32}-{'f' * 16}-01"
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4)
    pm = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, seq_impl="dense",
                         device="cpu")

    async def frames():
        jtc.set_traceparent(tp)
        spans.set_traceparent(tp)
        jtok = jm.admit(0, prompt, 0.0, 0, reserve_tokens=4)
        ptok = pm.admit(0, prompt, 0.0, 0, reserve_tokens=4)
        assert int(jtok) == int(ptok)
        return (await asyncio.to_thread(jh.build_handoff_frame, jm, 0, prompt, int(jtok),
                                        max_new_tokens=9),
                await asyncio.to_thread(th.build_handoff_frame, pm, 0, prompt, int(ptok),
                                        max_new_tokens=9))

    jframe, pframe = run(frames())
    want, got = jh.decode_handoff(jframe), th.decode_handoff(pframe)
    assert got["traceparent"] == want["traceparent"] == tp
    assert got["origin_span"] == want["origin_span"] == "f" * 16
    envelope = set(want) - {"k", "v", "prompt"}
    assert envelope == set(got) - {"k", "v", "prompt"}
    for key in envelope:
        assert got[key] == want[key], key
    assert np.asarray(got["prompt"]).tolist() == np.asarray(want["prompt"]).tolist()
    for key in ("k", "v"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=1e-5)
    assert pframe == jh.encode_handoff(
        prompt, int(got["first_token"]), np.asarray(got["k"]), np.asarray(got["v"]),
        block_size=pm.kv_block_size, max_new_tokens=9, temperature=0.0, eos_id=None,
        traceparent=tp, origin_span="f" * 16, priority=got["priority"])
