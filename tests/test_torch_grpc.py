"""The port's gRPC plane against the JAX package's, and the slice as a
whole, on the h2 data plane of each package (grpcio and protobuf on the
test side only).

- The JAX ``tests/test_grpc.py`` cases on the port: the wrapper runtime's
  Model, Router (route and feedback), Combiner and a user error as a
  FAILURE status, each reply byte-equal to the JAX runtime's for the same
  request, one through a stock grpcio client; the engine's Seldon Predict
  over the default graph; the engine walking a GRPC unit, across both
  packages' engines and runtimes.
- The StreamPredict refusals (INVALID_ARGUMENT, status 3) with the JAX
  texts: a graph with no generative unit, no ``strData``, a nested
  prompt, a malformed option.
- The slice: the port's gateway gRPC relay over the port's engine and the
  JAX gateway's over the JAX engine, both on ``tiny`` from one JAX
  checkpoint (float32, the CPU): equal greedy Predict and StreamPredict
  tokens, each equal to the direct call; the relay's refusals (no token,
  a wrong token) byte-equal to the JAX relay's; the ``gateway-grpc`` and
  ``engine-grpc`` wire edges count the client's bytes; one
  ``traceparent`` reaches the engine's timeline; a client that drops its
  connection mid-StreamPredict through the gateway frees the engine's
  slot long before ``max_new_tokens``.
- A graph with GRPC nodes (a transformer and a model in the wrapper
  runtime) answers as its REST twin.
- A gRPC port that does not bind fails the engine's start, unless
  ``ENGINE_GRPC_OPTIONAL=1`` (REST alone); an unreachable engine answers
  through the relay as through the JAX relay (a 503 FAILURE); a client's
  reset (on the relay's cold and warm paths) and a client's lost
  connection each cancel the engine's handler; a replica that leaves a
  record has its relay channel closed.
- The port and ``chip_smoke.py`` import neither grpc nor protobuf.

Tolerance: tokens and reply bytes exact (``puid`` cleared where an engine
draws one)."""

import asyncio
import json
import re
import time
from pathlib import Path

import grpc
import jax
import numpy as np
import pytest

from seldon_core_tpu.contract import Payload as JPayload
from seldon_core_tpu.contract import payload_to_proto as jpayload_to_proto
from seldon_core_tpu.engine import grpc_app as jgrpc_app
from seldon_core_tpu.engine.service import PredictionService as JaxPredictionService
from seldon_core_tpu.executor import checkpoint as jck
from seldon_core_tpu.gateway import grpc_gateway as jgw_grpc
from seldon_core_tpu.gateway import store as jstore
from seldon_core_tpu.gateway.app import GatewayApp as JaxGatewayApp
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.proto import grpc_defs as jdefs
from seldon_core_tpu.proto import prediction_pb2 as pb
from seldon_core_tpu.runtime import grpc_service as jrt
from seldon_core_tpu.utils.tracectx import set_traceparent as jset_traceparent
from seldon_core_tpu.wire import FastGrpcServer as JaxFastGrpcServer
from seldon_core_tpu_torch.contract import Payload, payload_from_proto, payload_to_proto
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.grpc_app import start_engine_grpc
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.gateway import store as tstore
from seldon_core_tpu_torch.gateway.app import GatewayApp
from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.obs import TIMELINE, WIRE, WIRE_ENGINE_GRPC, WIRE_GATEWAY_GRPC
from seldon_core_tpu_torch.proto import prediction as tp
from seldon_core_tpu_torch.runtime.grpc_service import start_grpc
from seldon_core_tpu_torch.runtime.server import MicroserviceApp
from seldon_core_tpu_torch.wire import FastGrpcChannel, FastGrpcServer, GrpcCallError
from seldon_core_tpu_torch.wire.h1client import H1Pool

ROOT = Path(__file__).resolve().parents[1]
LO = "127.0.0.1"
run = asyncio.run


class Doubler:
    def predict(self, X, names):
        return np.asarray(X) * 2.0


class AddOne:
    def transform_input(self, X, names):
        return np.asarray(X) + 1.0


class PickSecond:
    def route(self, X, names):
        return 1

    def send_feedback(self, X, names, reward, truth=None, routing=None):
        self.last = (reward, routing)


class Averager:
    def aggregate(self, Xs, names):
        return np.mean(np.stack([np.asarray(x) for x in Xs]), axis=0)


class Broken:
    def predict(self, X, names):
        raise RuntimeError("nope")


def _sm(values) -> bytes:
    return payload_to_proto(Payload.from_array(np.asarray(values))).SerializeToString()


async def _jax_runtime(component, name: str, service_type: str = "MODEL"):
    """The JAX runtime's services on its own h2 plane, bound to loopback."""
    handler = jrt.ComponentGrpc(component, name=name, service_type=service_type)
    paths: dict = {}
    for service, table in jrt._service_tables(handler).items():
        paths.update(jdefs.raw_handlers(service, table))
    server = JaxFastGrpcServer(paths)
    await server.start(0, host=LO)
    return server


async def _both_runtimes(make, name, service_type, calls):
    """Each call ``(path, request bytes)`` against the port's runtime and
    the JAX runtime, each with a fresh component from ``make``: the raw
    reply bytes and the components."""
    out = []
    for port_pkg in (True, False):
        comp = make()
        server = (await start_grpc(comp, 0, name=name, service_type=service_type, host=LO)
                  if port_pkg else await _jax_runtime(comp, name, service_type))
        ch = FastGrpcChannel(f"{LO}:{server.bound_port}")
        try:
            out.append(([await ch.call(path, raw) for path, raw in calls], comp))
        finally:
            await ch.close()
            await server.stop()
    return out


# -- the wrapper runtime --------------------------------------------------------

def test_model_predict():
    (got, _), (want, _) = run(_both_runtimes(
        Doubler, "d", "MODEL", [("/seldon.protos.Model/Predict", _sm([[1.0, 2.0]])),
                                ("/seldon.protos.Generic/TransformInput", _sm([[3.0]]))]))
    assert got == want
    np.testing.assert_allclose(
        payload_from_proto(tp.SeldonMessage.FromString(got[0])).array, [[2.0, 4.0]])


def test_router_route_and_feedback():
    fb = pb.Feedback(reward=0.7)
    fb.response.meta.routing["r"] = 1
    (got, comp), (want, jcomp) = run(_both_runtimes(
        PickSecond, "r", "ROUTER", [("/seldon.protos.Router/Route", _sm([[1.0]])),
                                    ("/seldon.protos.Router/SendFeedback",
                                     fb.SerializeToString())]))
    assert got == want
    out = payload_from_proto(tp.SeldonMessage.FromString(got[0]))
    assert int(np.asarray(out.array).ravel()[0]) == 1
    assert comp.last == jcomp.last == (pytest.approx(0.7), 1)


def test_combiner_aggregate():
    req = tp.SeldonMessageList(seldonMessages=[
        tp.SeldonMessage.FromString(_sm([[0.0, 2.0]])),
        tp.SeldonMessage.FromString(_sm([[2.0, 4.0]]))]).SerializeToString()
    (got, _), (want, _) = run(_both_runtimes(
        Averager, "c", "COMBINER", [("/seldon.protos.Combiner/Aggregate", req),
                                    ("/seldon.protos.Combiner/Aggregate", b"")]))
    assert got == want
    np.testing.assert_allclose(
        payload_from_proto(tp.SeldonMessage.FromString(got[0])).array, [[1.0, 3.0]])
    empty = tp.SeldonMessage.FromString(got[1]).status
    assert (empty.code, empty.info) == (400, "seldonMessages list is empty")


def test_error_maps_to_failure_status():
    (got, _), (want, _) = run(_both_runtimes(
        Broken, "b", "MODEL", [("/seldon.protos.Model/Predict", _sm([[1.0]]))]))
    assert got == want
    st = tp.SeldonMessage.FromString(got[0]).status
    assert st.status == tp.Status.FAILURE and st.code == 500 and "nope" in st.info


def test_a_grpcio_client_is_served_by_the_port_runtime():
    async def go():
        server = await start_grpc(Doubler(), 0, name="d", host=LO)
        try:
            async with grpc.aio.insecure_channel(f"{LO}:{server.bound_port}") as ch:
                reply = await jdefs.Stub(ch, "Model").Predict(
                    jpayload_to_proto(JPayload.from_array(np.array([[1.0, 2.0]]))))
        finally:
            await server.stop()
        return reply

    reply = run(go())
    np.testing.assert_allclose(
        payload_from_proto(tp.SeldonMessage.FromString(reply.SerializeToString())).array,
        [[2.0, 4.0]])


# -- the engine -------------------------------------------------------------------

SIMPLE = {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}}


async def _jax_engine_grpc(svc):
    """The JAX engine's Seldon service (``start_engine_grpc``'s h2 server)
    bound to loopback."""
    handler = jgrpc_app.SeldonGrpc(svc)

    def seed(headers):
        jset_traceparent(next((v.decode() for k, v in headers if k == b"traceparent"), None))

    server = JaxFastGrpcServer(
        jdefs.raw_handlers("Seldon", {"Predict": handler.Predict,
                                      "SendFeedback": handler.SendFeedback}),
        on_request_headers=seed,
        stream_handlers={"/seldon.protos.Seldon/StreamPredict": handler.stream_predict_raw})
    await server.start(0, host=LO)
    return server


async def _stream(ch: FastGrpcChannel, body: dict | None, raw: bytes | None = None,
                  metadata=()) -> tuple[list, tuple | None]:
    """StreamPredict: (decoded messages, (status, message) of a failure)."""
    req = raw if raw is not None else tp.SeldonMessage(
        strData=json.dumps(body)).SerializeToString()
    msgs = []
    try:
        async for m in ch.call_stream("/seldon.protos.Seldon/StreamPredict", req, timeout=60,
                                      metadata=metadata):
            msgs.append(json.loads(tp.SeldonMessage.FromString(m).strData))
    except GrpcCallError as e:
        return msgs, (e.status, e.message)
    return msgs, None


def _without_puid(raw: bytes) -> bytes:
    msg = tp.SeldonMessage.FromString(raw)
    if msg.meta is not None:
        msg.meta.puid = ""
    return msg.SerializeToString()


def test_seldon_predict_default_graph_and_refusals_of_a_graph_with_no_generative_unit():
    async def go(port_pkg: bool):
        if port_pkg:
            svc = PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu")
            svc.start()
            server = await start_engine_grpc(svc, 0, host=LO)
        else:
            svc = JaxPredictionService(JaxPredictorSpec.model_validate(SIMPLE))
            await svc.start()
            server = await _jax_engine_grpc(svc)
        ch = FastGrpcChannel(f"{LO}:{server.bound_port}")
        try:
            reply = await ch.call("/seldon.protos.Seldon/Predict", _sm([[5.0, 6.0, 7.0]]))
            refusal = await _stream(ch, {"tokens": [1, 2]})
        finally:
            await ch.close()
            await server.stop()
            await svc.close()
        return reply, refusal

    got, got_refusal = run(go(True))
    want, want_refusal = run(go(False))
    msg = tp.SeldonMessage.FromString(got)
    assert msg.status.code == 200 and msg.status.status == tp.Status.SUCCESS
    assert msg.meta.puid  # the engine drew a request id
    np.testing.assert_allclose(payload_from_proto(msg).array, [[0.1, 0.9, 0.5]])
    assert _without_puid(got) == _without_puid(want)
    assert got_refusal == want_refusal == (
        [], (3, "streaming needs exactly one generative unit in the graph (found 0)"))


def _remote(port: int, kind: str, name: str, typ: str = "MODEL") -> dict:
    return {"name": name, "type": typ,
            "endpoint": {"service_host": LO, "service_port": port, "type": kind}}


def test_engine_walks_remote_grpc_unit_across_both_packages():
    """A GRPC node: each package's engine over each package's runtime."""

    async def go():
        outs = []
        for runtime_port_pkg in (True, False):
            server = (await start_grpc(Doubler(), 0, name="d", host=LO) if runtime_port_pkg
                      else await _jax_runtime(Doubler(), "d"))
            spec = {"name": "p", "graph": _remote(server.bound_port, "GRPC", "d")}
            try:
                svc = PredictionService(PredictorSpec.from_dict(spec), device="cpu")
                svc.start()
                out = await svc.predict(Payload.from_array(np.array([[3.0, 4.0]])))
                await svc.close()  # also closes the engine's channel cache
                jsvc = JaxPredictionService(JaxPredictorSpec.model_validate(spec))
                await jsvc.start()
                jout = await jsvc.predict(JPayload.from_array(np.array([[3.0, 4.0]])))
                await jsvc.close()
            finally:
                await server.stop()
            outs.append((out, jout))
        return outs

    for out, jout in run(go()):
        np.testing.assert_allclose(out.array, [[6.0, 8.0]])
        np.testing.assert_array_equal(out.array, jout.array)
        assert out.meta.request_path["d"] == jout.meta.request_path["d"]


def test_a_graph_of_grpc_nodes_answers_as_its_rest_twin():
    async def go():
        grpc_t = await start_grpc(AddOne(), 0, name="t", service_type="TRANSFORMER", host=LO)
        grpc_m = await start_grpc(Doubler(), 0, name="m", host=LO)
        rest_t, rest_m = MicroserviceApp(AddOne(), "t", "TRANSFORMER"), MicroserviceApp(
            Doubler(), "m")
        await rest_t.start(LO, 0)
        await rest_m.start(LO, 0)
        replies = []
        try:
            for kind, (t, m) in (("GRPC", (grpc_t.bound_port, grpc_m.bound_port)),
                                 ("REST", (rest_t.port, rest_m.port))):
                graph = _remote(t, kind, "t", "TRANSFORMER")
                graph["children"] = [_remote(m, kind, "m")]
                app = EngineApp(PredictionService(PredictorSpec.from_dict(
                    {"name": "p", "graph": graph}), device="cpu"))
                await app.start(LO, 0, grpc_port=0)
                await app.boot()
                ch = FastGrpcChannel(f"{LO}:{app.grpc_port}")
                try:
                    reply = tp.SeldonMessage.FromString(await ch.call(
                        "/seldon.protos.Seldon/Predict", _sm([[1.0, 2.0], [3.0, 4.0]])))
                finally:
                    await ch.close()
                    await app.close()
                reply.meta.puid = ""
                reply.meta.requestPath = {}
                replies.append(reply)
        finally:
            for s in (grpc_t, grpc_m):
                await s.stop()
            for a in (rest_t, rest_m):
                await a.close()
        return replies

    via_grpc, via_rest = run(go())
    assert via_grpc == via_rest
    np.testing.assert_allclose(payload_from_proto(via_grpc).array, [[4.0, 6.0], [8.0, 10.0]])


# -- the slice on a tiny llama ---------------------------------------------------

MAX_SEQ = 128
WAVE = [[5, 9, 2, 17, 3], [30, 7, 1], [1, 2, 3, 4, 8, 11]]
NEW = 6
TRACE = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = jl.Config.tiny(max_seq=MAX_SEQ)
    params = jax.device_get(jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg))
    path = str(tmp_path_factory.mktemp("grpc") / "tiny.npz")
    jck.save_params(path, jax.tree.map(np.asarray, params))
    return path


def _graph(path: str) -> dict:
    params = {"family": "llama", "preset": "tiny", "max_seq": MAX_SEQ, "checkpoint": path,
              "dtype": "float32", "n_slots": 2, "decode_block": 4, "max_new_tokens": NEW}
    types = {int: "INT", str: "STRING"}
    return {"name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [{"name": k, "value": str(v), "type": types[type(v)]}
                           for k, v in params.items()]}


def _prompt(tokens, **opts) -> bytes:
    return tp.SeldonMessage(strData=json.dumps({"tokens": tokens, **opts})).SerializeToString()


def _tokens(raw: bytes) -> list[int]:
    return json.loads(tp.SeldonMessage.FromString(raw).strData)["tokens"]


async def _port_side(path: str):
    app = EngineApp(PredictionService(PredictorSpec.from_dict(
        {"name": "chat", "graph": _graph(path)}), device="cpu"))
    await app.start(LO, 0, grpc_port=0)
    await app.boot()
    store = tstore.DeploymentStore()
    store.put(tstore.DeploymentRecord(
        name="chat", oauth_key="chat-key", oauth_secret="chat-secret",
        endpoints=({"host": LO, "rest_port": app.port, "grpc_port": app.grpc_port},)))
    gw = GatewayApp(store, timeout_s=120.0)
    server = await start_gateway_grpc(gw, 0, host=LO)

    async def close():
        await server.gateway_handler.close()
        await server.stop()
        await gw.close()
        await app.close()
    return app, gw, app.grpc_port, server.bound_port, close


async def _jax_side(path: str):
    svc = JaxPredictionService(JaxPredictorSpec.model_validate(
        {"name": "chat", "graph": _graph(path)}))
    await svc.start()
    engine = await _jax_engine_grpc(svc)
    store = jstore.DeploymentStore()
    store.put(jstore.DeploymentRecord(
        name="chat", oauth_key="chat-key", oauth_secret="chat-secret",
        endpoints=({"host": LO, "rest_port": 1, "grpc_port": engine.bound_port},)))
    gw = JaxGatewayApp(store, timeout_s=120.0)
    handler = jgw_grpc.FastGatewayGrpc(gw, loop=asyncio.get_running_loop())
    server = JaxFastGrpcServer(
        {}, on_request_headers=handler.seed_metadata,
        stream_handlers={"/seldon.protos.Seldon/StreamPredict": handler.stream_predict_raw},
        relay_handlers={"/seldon.protos.Seldon/Predict": handler.make_relay("Predict"),
                        "/seldon.protos.Seldon/SendFeedback": handler.make_relay("SendFeedback")})
    await server.start(0, host=LO)

    async def close():
        await handler.close()
        await server.stop()
        await engine.stop()
        await gw.close()
        await svc.close()
    return None, gw, engine.bound_port, server.bound_port, close


async def _slice(port_pkg: bool, path: str) -> dict:
    app, gw, eport, gport, close = await (_port_side(path) if port_pkg else _jax_side(path))
    token = gw.issue_token("chat-key", "chat-secret")[1]["access_token"]
    auth = (("oauth_token", token),)
    direct, front = FastGrpcChannel(f"{LO}:{eport}"), FastGrpcChannel(f"{LO}:{gport}")
    predict = "/seldon.protos.Seldon/Predict"
    out: dict = {}
    try:
        out["direct"] = [_tokens(await direct.call(predict, _prompt(p, max_new_tokens=NEW)))
                         for p in WAVE]
        replies = await asyncio.gather(*(front.call(predict, _prompt(p, max_new_tokens=NEW),
                                                    metadata=auth) for p in WAVE))
        out["gateway"] = [_tokens(r) for r in replies]
        out["stream_direct"] = await _stream(direct, {"tokens": WAVE[0], "max_new_tokens": NEW})
        out["stream_gateway"] = await _stream(front, {"tokens": WAVE[0], "max_new_tokens": NEW},
                                              metadata=auth)
        out["refusals"] = [
            await _stream(direct, None, raw=tp.SeldonMessage(binData=b"x").SerializeToString()),
            await _stream(direct, {"tokens": [[1, 2], [3]]}),
            await _stream(direct, {"tokens": [1, 2], "max_new_tokens": "many"}),
            await _stream(front, {"tokens": [1, 2]}),  # no token
        ]
        out["no_token"] = await front.call(predict, _prompt(WAVE[0]))
        out["bad_token"] = await front.call(predict, _prompt(WAVE[0]),
                                            metadata=(("oauth_token", "nope"),))
        if port_pkg:
            gw_wire = WIRE.counter(WIRE_GATEWAY_GRPC, "chat")
            eng_wire = WIRE.counter(WIRE_ENGINE_GRPC, "chat")
            before = (gw_wire.bytes_in, gw_wire.bytes_out, eng_wire.bytes_in, eng_wire.bytes_out)
            req = _prompt(WAVE[1], max_new_tokens=NEW)
            reply = await front.call(predict, req, metadata=auth + (("traceparent", TRACE),))
            after = (gw_wire.bytes_in, gw_wire.bytes_out, eng_wire.bytes_in, eng_wire.bytes_out)
            out["wire"] = ([a - b for a, b in zip(after, before)], len(req), len(reply))
            out["timeline"] = TIMELINE.by_trace(TRACE.split("-")[1])
            out["dropped"] = await _drop_mid_stream(app, gport, auth)
    finally:
        await direct.close()
        await front.close()
        await close()
    return out


async def _drop_mid_stream(app, gport: int, auth) -> dict:
    """A client that loses its connection after two streamed tokens: the
    gateway's dead connection cancels its relay, whose upstream reset
    cancels the engine's request and frees its slot."""
    model = app.service.walker.component.model
    free0, emitted0 = model.free_block_count, model.tokens_emitted
    fetch = model.step_k_fetch

    def slow_fetch(handle):  # blocks slow enough for the client to leave mid-stream
        time.sleep(0.02)
        return fetch(handle)

    model.step_k_fetch = slow_fetch
    ch = FastGrpcChannel(f"{LO}:{gport}")
    got = 0
    try:
        async for _ in ch.call_stream("/seldon.protos.Seldon/StreamPredict",
                                      _prompt([5, 9, 2, 17, 3], max_new_tokens=100),
                                      timeout=60, metadata=auth):
            got += 1
            if got == 2:
                ch._conn.transport.abort()  # the connection dies, no RST first
                break
    except (ConnectionError, GrpcCallError):
        pass
    await ch.close()
    deadline = time.perf_counter() + 30
    while model.free_block_count != free0 and time.perf_counter() < deadline:
        await asyncio.sleep(0.02)
    model.step_k_fetch = fetch
    return {"freed": model.free_block_count == free0,
            "emitted": model.tokens_emitted - emitted0, "received": got}


def test_the_slice_matches_the_jax_gateway_and_engine_over_grpc(ckpt):
    want = run(_slice(False, ckpt))
    got = run(_slice(True, ckpt))
    assert got["direct"] == want["direct"] == got["gateway"] == want["gateway"]
    assert all(len(t) == NEW for t in got["direct"])
    for out in (got, want):
        msgs, err = out["stream_direct"]
        assert err is None and [m["token"] for m in msgs[:-1]] == out["direct"][0]
        assert msgs[-1] == {"done": True, "tokens": out["direct"][0]}
    assert got["stream_gateway"] == want["stream_gateway"] == got["stream_direct"]
    assert got["refusals"] == want["refusals"]
    statuses = [err[0] for _, err in got["refusals"]]
    assert statuses == [3, 3, 3, 16]
    assert got["refusals"][0][1][1] == "StreamPredict takes strData JSON"
    assert "ONE prompt" in got["refusals"][1][1][1]
    assert got["refusals"][2][1][1].startswith("bad stream request: ")
    assert got["no_token"] == want["no_token"]
    assert got["bad_token"] == want["bad_token"]
    st = tp.SeldonMessage.FromString(got["no_token"]).status
    assert (st.code, st.info, st.status) == (401, "missing oauth_token metadata",
                                             tp.Status.FAILURE)
    (gw_in, gw_out, eng_in, eng_out), req_len, reply_len = got["wire"]
    # the relay counts the framed bytes (5-byte gRPC prefix), the engine
    # the messages
    assert (gw_in, gw_out) == (req_len + 5, reply_len + 5)
    assert (eng_in, eng_out) == (req_len, reply_len)
    assert got["timeline"] and all(t["trace_id"] == TRACE.split("-")[1]
                                   for t in got["timeline"])
    dropped = got["dropped"]
    assert dropped["received"] == 2 and dropped["freed"]
    assert dropped["emitted"] < 100  # reaped, not run to its end


# -- boot, the relay's failures and its channels -----------------------------------

def test_a_grpc_bind_conflict_fails_the_boot_unless_optional(monkeypatch):
    async def go(optional: bool):
        first_svc = PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu")
        first_svc.start()
        first = await start_engine_grpc(first_svc, 0, host=LO)
        app = EngineApp(PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu"))
        try:
            if not optional:
                with pytest.raises(RuntimeError, match="bind"):
                    await app.start(LO, 0, grpc_port=first.bound_port)
                return None
            monkeypatch.setenv("ENGINE_GRPC_OPTIONAL", "1")
            await app.start(LO, 0, grpc_port=first.bound_port)
            await app.boot()
            pool = H1Pool(LO, app.port)
            try:
                resp = await pool.post("/api/v0.1/predictions",
                                       b'{"data": {"ndarray": [[1.0]]}}', {}, timeout=10)
            finally:
                await pool.close()
            return resp.status, app.grpc_server
        finally:
            await app.close()
            await first.stop()
            await first_svc.close()

    assert run(go(False)) is None
    assert run(go(True)) == (200, None)  # REST alone


async def _relay(engine_grpc_port: int, port_pkg: bool = True):
    """A gateway relay (the port's or the JAX one) in front of one engine
    gRPC port -> (gateway app, server, a valid token, close)."""
    mod = tstore if port_pkg else jstore
    store = mod.DeploymentStore()
    store.put(mod.DeploymentRecord(
        name="dep", oauth_key="k", oauth_secret="s",
        # a replica's key is its host and REST port; none listens on REST here
        endpoints=({"host": LO, "rest_port": engine_grpc_port,
                    "grpc_port": engine_grpc_port},)))
    if port_pkg:
        gw = GatewayApp(store, timeout_s=30.0)
        server = await start_gateway_grpc(gw, 0, host=LO)
        handler = server.gateway_handler
    else:
        gw = JaxGatewayApp(store, timeout_s=30.0)
        handler = jgw_grpc.FastGatewayGrpc(gw, loop=asyncio.get_running_loop())
        server = JaxFastGrpcServer(
            {}, on_request_headers=handler.seed_metadata,
            relay_handlers={"/seldon.protos.Seldon/Predict": handler.make_relay("Predict")})
        await server.start(0, host=LO)
        server.gateway_handler = handler
    token = gw.issue_token("k", "s")[1]["access_token"]

    async def close():
        await handler.close()
        await server.stop()
        await gw.close()
    return gw, store, server, token, close


def test_an_unreachable_engine_answers_as_the_jax_relay():
    dead = _free_port()  # nothing listens there

    async def go(port_pkg: bool):
        _, _, server, token, close = await _relay(dead, port_pkg)
        ch = FastGrpcChannel(f"{LO}:{server.bound_port}")
        try:
            return await ch.call("/seldon.protos.Seldon/Predict", _sm([[1.0]]),
                                 metadata=(("oauth_token", token),))
        finally:
            await ch.close()
            await close()

    got, want = run(go(True)), run(go(False))
    assert got == want
    st = tp.SeldonMessage.FromString(got).status
    assert st.code == 503 and st.info.startswith("engine unreachable: ")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind((LO, 0))
        return sock.getsockname()[1]


def test_a_client_reset_or_lost_connection_cancels_the_upstream_call():
    """The relay's cancels: a client's RST on the cold path (the engine's
    connection still being made) and on the warm path, and a client's
    whole connection lost, each cancel the engine's handler."""

    async def go():
        started, cancelled = [], []

        async def stuck(payload: bytes) -> bytes:
            started.append(1)
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                cancelled.append(1)
                raise
            return payload

        engine = FastGrpcServer({"/seldon.protos.Seldon/Predict": stuck})
        await engine.start(0, host=LO)
        _, _, server, token, close = await _relay(engine.bound_port)
        auth = (("oauth_token", token),)

        async def until(pred):
            for _ in range(300):
                if pred():
                    return True
                await asyncio.sleep(0.01)
            return False

        try:
            ch = FastGrpcChannel(f"{LO}:{server.bound_port}")
            for n in (1, 2):  # cold, then warm: each a client timeout (an RST)
                with pytest.raises(asyncio.TimeoutError):
                    await ch.call("/seldon.protos.Seldon/Predict", _sm([[1.0]]),
                                  timeout=0.3, metadata=auth)
                assert await until(lambda: len(cancelled) == n)
            # the client's connection dies with a call in flight
            call = asyncio.ensure_future(ch.call("/seldon.protos.Seldon/Predict",
                                                 _sm([[1.0]]), timeout=10, metadata=auth))
            assert await until(lambda: len(started) == 3)
            relays = [c for c in server._conns if c.relay_cancels]
            ch._conn.transport.abort()
            with pytest.raises((ConnectionError, asyncio.TimeoutError)):
                await call
            assert await until(lambda: len(cancelled) == 3)
            await ch.close()
            return len(started), len(cancelled), [c.relay_cancels for c in relays]
        finally:
            await close()
            await engine.stop()

    assert run(go()) == (3, 3, [{}])


def test_a_departed_replicas_channel_closes_on_the_store_event():
    async def go():
        svcs, engines = [], []
        for _ in range(2):
            svc = PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu")
            svc.start()
            svcs.append(svc)
            engines.append(await start_engine_grpc(svc, 0, host=LO))
        a, b = engines
        gw, store, server, token, close = await _relay(a.bound_port)
        ch = FastGrpcChannel(f"{LO}:{server.bound_port}")
        auth = (("oauth_token", token),)
        try:
            first = await ch.call("/seldon.protos.Seldon/Predict", _sm([[1.0]]), metadata=auth)
            before = (sorted(k[1] for k in server.gateway_handler._channels), len(a._conns))
            store.put(tstore.DeploymentRecord(
                name="dep", oauth_key="k", oauth_secret="s",
                endpoints=({"host": LO, "rest_port": b.bound_port,
                            "grpc_port": b.bound_port},)))
            for _ in range(300):  # the close hops to the loop
                if not a._conns:
                    break
                await asyncio.sleep(0.01)
            second = await ch.call("/seldon.protos.Seldon/Predict", _sm([[1.0]]), metadata=auth)
            after = (sorted(k[1] for k in server.gateway_handler._channels), len(a._conns),
                     len(b._conns))
        finally:
            await ch.close()
            await close()
            for e in engines:
                await e.stop()
            for svc in svcs:
                await svc.close()
        return first, second, before, after, a.bound_port, b.bound_port

    first, second, before, after, pa, pb_ = run(go())
    assert _without_puid(first) == _without_puid(second)
    assert before == ([f"{LO}:{pa}"], 1)
    assert after == ([f"{LO}:{pb_}"], 0, 1)


# -- the import guard ------------------------------------------------------------

_GRPC_IMPORT = re.compile(r"\b(import grpc|from grpc)\b|google\.protobuf")


def test_the_port_and_chip_smoke_import_neither_grpc_nor_protobuf():
    sources = sorted((ROOT / "seldon_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _GRPC_IMPORT.search(line)]
    assert not hits
