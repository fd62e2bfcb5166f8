"""Remote graph nodes on the port's engine: the REST transport
(``seldon_core_tpu_torch/engine/transport.py``) over the pooled client,
against the JAX engine and runtime.

The cases of the JAX ``tests/test_engine_e2e.py`` (``TestCrossServiceGraph``,
``TestHopRetries``, ``TestTraceContextPropagation``) on the port's engine
and runtime; the two packages crossed over the wire (the port's engine
over the JAX microservice, the JAX engine over the port's) against JAX
over JAX; the Iris example and the transform pipeline end to end; the
deadline and priority a hop carries; the response tiers' refusal of a
graph with a remote node; the endpoints refused by name; and the
form-encoded bodies both engines take.  Every server is in-process on a
loopback port."""

import asyncio
import importlib.util
import json
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from seldon_core_tpu.engine.app import EngineApp as JaxEngineApp
from seldon_core_tpu.engine.service import PredictionService as JaxPredictionService
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.runtime.server import MicroserviceApp as JaxMicroserviceApp
from seldon_core_tpu_torch.contract.payload import FeedbackPayload, Payload
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.engine.transport import RemoteUnitError, RestNodeClient
from seldon_core_tpu_torch.graph.spec import (
    Endpoint,
    PredictiveUnitSpec,
    PredictorSpec,
    TransportType,
    UnitType,
)
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.graph.walker import GraphWalker
from seldon_core_tpu_torch.obs.spans import parse_traceparent
from seldon_core_tpu_torch.runtime import MicroserviceApp
from seldon_core_tpu_torch.wire.h1client import H1Pool

ROOT = Path(__file__).resolve().parent.parent
REQ = {"data": {"ndarray": [[1.0, 2.0, 3.0]]}}
run = asyncio.run


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rest(port: int) -> dict:
    return {"service_host": "127.0.0.1", "service_port": port, "type": "REST"}


async def _port_engine(graph: dict):
    app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                      device="cpu"))
    await app.start("127.0.0.1", 0)
    await app.boot()
    return f"http://127.0.0.1:{app.port}", app.close


async def _jax_engine(graph: dict):
    service = JaxPredictionService(JaxPredictorSpec.model_validate({"name": "p", "graph": graph}))
    srv = TestServer(JaxEngineApp(service).build())
    await srv.start_server()
    return f"http://127.0.0.1:{srv.port}", srv.close


async def _port_unit(comp, name="m"):
    app = MicroserviceApp(comp, name=name)
    await app.start()
    return app.port, app.close


async def _jax_unit(comp, name="m"):
    srv = TestServer(JaxMicroserviceApp(comp, name=name).build())
    await srv.start_server()
    return srv.port, srv.close


async def _post(session, url, body, headers=None, form=False):
    kw = {"data": {"json": json.dumps(body)}} if form else {"json": body}
    async with session.post(url, headers=headers, **kw) as resp:
        return resp.status, json.loads(await resp.read()), dict(resp.headers)


def _strip(reply: dict) -> dict:
    """A reply without its per-request puid."""
    out = json.loads(json.dumps(reply))
    out.get("meta", {}).pop("puid", None)
    return out


class TimesTen:
    def predict(self, X, names):
        return np.asarray(X) * 10

    def tags(self):
        return {"remote": True}


class PickOne:
    def __init__(self):
        self.rewards = []

    def route(self, X, names):
        return 1

    def send_feedback(self, X, names, reward, truth=None, routing=None):
        self.rewards.append((reward, routing))


# -- the JAX TestCrossServiceGraph cases on the port -------------------------


def test_remote_model_node():
    async def go():
        uport, uclose = await _port_unit(TimesTen())
        base, close = await _port_engine({"name": "remote-model", "type": "MODEL",
                                          "endpoint": _rest(uport)})
        try:
            async with aiohttp.ClientSession() as s:
                return await _post(s, base + "/api/v0.1/predictions", REQ)
        finally:
            await close()
            await uclose()

    status, body, _ = run(go())
    assert status == 200
    assert body["data"]["ndarray"] == [[10.0, 20.0, 30.0]]
    assert body["meta"]["tags"] == {"remote": True}
    assert body["meta"]["requestPath"]["remote-model"].startswith("http://127.0.0.1:")


def test_remote_router_and_feedback_reaches_the_router_once():
    router = PickOne()

    async def go():
        uport, uclose = await _port_unit(router, name="r")
        graph = {"name": "r", "type": "ROUTER", "endpoint": _rest(uport),
                 "children": [{"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                              {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
        base, close = await _port_engine(graph)
        try:
            async with aiohttp.ClientSession() as s:
                _, body, _ = await _post(s, base + "/api/v0.1/predictions", REQ)
                fb = {"request": REQ, "response": body, "reward": 0.7}
                status, _, _ = await _post(s, base + "/api/v0.1/feedback", fb)
                return body, status
        finally:
            await close()
            await uclose()

    body, status = run(go())
    assert body["meta"]["routing"]["r"] == 1 and status == 200
    assert router.rewards == [(0.7, 1)]


def test_remote_unit_error_propagates_500_unreachable():
    async def go():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()  # nothing listens there now
        base, close = await _port_engine({"name": "gone", "type": "MODEL",
                                          "endpoint": _rest(port)})
        try:
            async with aiohttp.ClientSession() as s:
                return await _post(s, base + "/api/v0.1/predictions", REQ)
        finally:
            await close()

    status, body, _ = run(go())
    assert status == 500
    assert body["status"]["status"] == "FAILURE"
    assert "unreachable" in body["status"]["reason"]


# -- the JAX TestHopRetries cases on the port -------------------------------


async def _flaky_unit(path: str, handler):
    app = web.Application()
    app.router.add_post(path, handler)
    srv = TestServer(app)
    await srv.start_server()
    return srv


def _remote_spec(port: int, unit_type=UnitType.MODEL) -> PredictiveUnitSpec:
    return PredictiveUnitSpec(name="m", type=unit_type, endpoint=Endpoint(
        service_host="127.0.0.1", service_port=port, type=TransportType.REST))


def test_rest_hop_retries_transient_503():
    calls = {"n": 0}

    async def flaky(request):
        calls["n"] += 1
        if calls["n"] < 3:
            return web.json_response({"status": {"info": "warming"}}, status=503)
        return web.json_response({"data": {"ndarray": [[9.0]]}})

    async def go():
        srv = await _flaky_unit("/predict", flaky)
        pool = H1Pool("127.0.0.1", srv.port)
        try:
            client = RestNodeClient(_remote_spec(srv.port), pool)
            return (await client.transform_input(Payload.from_array(np.array([[1.0]])))).array
        finally:
            await pool.close()
            await srv.close()

    arr = run(go())
    assert calls["n"] == 3  # two retries, then the answer
    assert arr.tolist() == [[9.0]]


@pytest.mark.parametrize("path,call", [
    ("/send-feedback", lambda c: c.send_feedback(
        FeedbackPayload(request=Payload.from_array(np.array([[1.0]])), reward=1.0), None)),
    ("/transform-input", lambda c: c.transform_input(Payload.from_array(np.array([[1.0]])))),
    ("/route", lambda c: c.route(Payload.from_array(np.array([[1.0]])))),
])
def test_stateful_methods_are_not_retried_after_send(path, call):
    """A 503 AFTER the request reached the unit is not retried for the
    methods that may change the unit's state: a reward never counts twice."""
    calls = {"n": 0}

    async def always_503(request):
        calls["n"] += 1
        return web.json_response({"status": {"info": "no"}}, status=503)

    async def go():
        srv = await _flaky_unit(path, always_503)
        pool = H1Pool("127.0.0.1", srv.port)
        try:
            unit_type = UnitType.TRANSFORMER if path == "/transform-input" else UnitType.ROUTER
            with pytest.raises(RemoteUnitError, match="HTTP 503"):
                await call(RestNodeClient(_remote_spec(srv.port, unit_type), pool))
        finally:
            await pool.close()
            await srv.close()

    run(go())
    assert calls["n"] == 1  # exactly one attempt


def test_connect_failures_retry_every_method_then_fail_unreachable():
    async def go():
        server = await asyncio.start_server(lambda r, w: None, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        server.close()
        await server.wait_closed()
        pool = H1Pool("127.0.0.1", port)
        fb = FeedbackPayload(request=Payload.from_array(np.array([[1.0]])), reward=1.0)
        with pytest.raises(RemoteUnitError, match="unreachable"):
            await RestNodeClient(_remote_spec(port), pool).send_feedback(fb, None)
        return pool.opened

    assert run(go()) == 0


def test_a_reply_that_is_not_json_and_a_unit_error_status():
    async def html(request):
        return web.Response(text="<html>oops</html>", status=200)

    async def bad(request):
        return web.json_response({"status": {"info": "rows must be 4 wide"}}, status=400)

    async def go():
        out = []
        for handler in (html, bad):
            srv = await _flaky_unit("/predict", handler)
            pool = H1Pool("127.0.0.1", srv.port)
            try:
                with pytest.raises(RemoteUnitError) as e:
                    await RestNodeClient(_remote_spec(srv.port), pool).transform_input(
                        Payload.from_array(np.array([[1.0]])))
                out.append(str(e.value))
            finally:
                await pool.close()
                await srv.close()
        return out

    not_json, unit_error = run(go())
    assert "not JSON" in not_json
    assert unit_error.endswith("HTTP 400: rows must be 4 wide")


# -- the JAX TestTraceContextPropagation case, and the QoS headers ----------


def _header_unit(seen: list):
    async def unit(request):
        seen.append(dict(request.headers))
        return web.json_response({"data": {"ndarray": [[1.0]]}})

    return unit


def test_traceparent_deadline_and_priority_reach_the_remote_unit():
    seen: list = []

    async def go():
        srv = await _flaky_unit("/predict", _header_unit(seen))
        base, close = await _port_engine({"name": "m", "type": "MODEL",
                                          "endpoint": _rest(srv.port)})
        tp = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
        try:
            async with aiohttp.ClientSession() as s:
                url = base + "/api/v0.1/predictions"
                r1 = await _post(s, url, REQ, {"traceparent": tp, "x-sct-deadline-ms": "5000",
                                               "x-sct-priority": "batch"})
                r2 = await _post(s, url, REQ)  # trace-naive, no deadline, interactive
                assert r1[0] == r2[0] == 200
                return tp
        finally:
            await close()
            await srv.close()

    tp = run(go())
    first, second = (parse_traceparent(h.get("traceparent")) for h in seen)
    # hop 1 stays in the client's trace, re-parented by the engine's span
    assert first is not None and first[0] == parse_traceparent(tp)[0]
    assert seen[0]["traceparent"] != tp
    # hop 2 was trace-naive: a freshly minted trace, not the old one leaked
    assert second is not None and second[0] != first[0]
    assert 1.0 <= float(seen[0]["x-sct-deadline-ms"]) <= 5000.0
    assert seen[0]["x-sct-priority"] == "batch"
    assert "x-sct-deadline-ms" not in seen[1] and "x-sct-priority" not in seen[1]


# -- the two packages crossed over the wire ---------------------------------


class Affine:
    """Stateless, so every engine's replies can be compared."""

    def transform_input(self, X, names):
        return np.asarray(X, float) * 0.5 + 1.0


class Sum:
    def aggregate(self, Xs, names_list):
        return np.sum([np.asarray(x, float) for x in Xs], axis=0)


def _cross_graph(ports: dict) -> dict:
    return {"name": "pre", "type": "TRANSFORMER", "endpoint": _rest(ports["pre"]),
            "children": [{"name": "comb", "type": "COMBINER", "endpoint": _rest(ports["comb"]),
                          "children": [
                              {"name": "m1", "type": "MODEL", "endpoint": _rest(ports["m1"])},
                              {"name": "m2", "type": "MODEL",
                               "implementation": "SIMPLE_MODEL"}]}]}


def test_cross_wire_parity_both_engines_over_both_runtimes():
    """JAX engine over JAX units is the reference; the port's engine over the
    JAX units and the JAX engine over the port's units answer the same."""
    rows = np.random.default_rng(0).normal(size=(3, 3)).round(6).tolist()
    body = {"data": {"names": ["f0", "f1", "f2"], "ndarray": rows}}

    async def go():
        units = {}
        for side, starter in (("jax", _jax_unit), ("port", _port_unit)):
            units[side] = {}
            for name, comp in (("pre", Affine()), ("comb", Sum()), ("m1", TimesTen())):
                units[side][name] = await starter(comp, name)
        out = {}
        try:
            for engine, units_side in (("jax/jax", "jax"), ("port/jax", "jax"),
                                       ("jax/port", "port"), ("port/port", "port")):
                starter = _jax_engine if engine.startswith("jax") else _port_engine
                graph = _cross_graph({n: p for n, (p, _) in units[units_side].items()})
                base, close = await starter(graph)
                try:
                    async with aiohttp.ClientSession() as s:
                        status, reply, _ = await _post(s, base + "/api/v0.1/predictions", body)
                        out[engine] = (status, _strip(reply), units_side)
                finally:
                    await close()
        finally:
            for side in units.values():
                for _, close in side.values():
                    await close()
        return out

    out = run(go())
    ref = out["jax/jax"]
    assert ref[0] == 200
    assert out["port/jax"][:2] == ref[:2]
    # over the port's units only the units' base URLs (their ports) differ
    for engine in ("jax/port", "port/port"):
        status, reply, _ = out[engine]
        assert status == 200
        assert reply["data"] == ref[1]["data"] and reply["meta"]["tags"] == ref[1]["meta"]["tags"]
        assert set(reply["meta"]["requestPath"]) == set(ref[1]["meta"]["requestPath"])
    assert out["jax/port"][1] == out["port/port"][1]


def test_iris_and_the_transform_pipeline_equal_the_jax_engine():
    iris = _load("examples/iris/IrisClassifier.py", "iris_example")
    pipe = _load("examples/transform-pipeline/pipeline.py", "pipeline_example")
    graph_file = json.loads((ROOT / "examples/transform-pipeline/graph.json").read_text())
    rng = np.random.default_rng(1)
    bodies = [{"data": {"names": ["sepal_l", "sepal_w", "petal_l", "petal_w"],
                        "ndarray": rng.uniform(0.1, 8.0, size=(n, 4)).round(3).tolist()}}
              for n in (1, 3, 8)]

    def rewrite(node, ports):
        node = dict(node)
        node["endpoint"] = _rest(ports[node["name"]])
        node["children"] = [rewrite(c, ports) for c in node.get("children", [])]
        return node

    async def go():
        ius, iclose = await _port_unit(iris.IrisClassifier(), "iris")
        pipe_units = {n: await _port_unit(c, n) for n, c in (
            ("standardize", pipe.Standardize()), ("scorer", pipe.Scorer()),
            ("label", pipe.ArgmaxLabel()))}
        graphs = {"iris": {"name": "iris", "type": "MODEL", "endpoint": _rest(ius)},
                  "pipeline": rewrite(graph_file["graph"],
                                      {n: p for n, (p, _) in pipe_units.items()})}
        out = {}
        try:
            for name, graph in graphs.items():
                for engine, starter in (("jax", _jax_engine), ("port", _port_engine)):
                    base, close = await starter(graph)
                    try:
                        async with aiohttp.ClientSession() as s:
                            out[(name, engine)] = [
                                (await _post(s, base + "/api/v0.1/predictions", b))[:2]
                                for b in bodies]
                    finally:
                        await close()
        finally:
            await iclose()
            for _, close in pipe_units.values():
                await close()
        return out

    out = run(go())
    for name in ("iris", "pipeline"):
        port = [(st, _strip(r)) for st, r in out[(name, "port")]]
        jax = [(st, _strip(r)) for st, r in out[(name, "jax")]]
        assert port == jax
    for body, (status, reply) in zip(bodies, out[("iris", "port")]):
        x = np.asarray(body["data"]["ndarray"])
        assert status == 200 and reply["data"]["names"] == ["setosa", "versicolor", "virginica"]
        np.testing.assert_array_equal(reply["data"]["ndarray"],
                                      iris.IrisClassifier().predict(x, []))
    for body, (status, reply) in zip(bodies, out[("pipeline", "port")]):
        x = np.asarray(body["data"]["ndarray"])
        want = pipe.ArgmaxLabel().transform_output(
            pipe.Scorer().predict(pipe.Standardize().transform_input(x, []), []), [])
        np.testing.assert_array_equal(reply["data"]["ndarray"], want)


# -- the response tiers and the refusals ------------------------------------


class CountingDeterministic:
    DETERMINISTIC = True  # ignored over the wire: a remote unit never is

    def __init__(self):
        self.calls = 0

    def predict(self, X, names):
        self.calls += 1
        return np.asarray(X) + 1


def test_a_graph_with_a_remote_node_is_never_cached(monkeypatch):
    monkeypatch.setenv("SCT_CACHE", "1")
    unit = CountingDeterministic()

    async def go():
        uport, uclose = await _port_unit(unit)
        # every other node declares determinism: the remote one alone unbinds the tiers
        graph = {"name": "m", "type": "MODEL", "endpoint": _rest(uport),
                 "children": [{"name": "s", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
        app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                          device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        try:
            async with aiohttp.ClientSession() as s:
                replies = [await _post(s, f"http://127.0.0.1:{app.port}/api/v0.1/predictions",
                                       REQ) for _ in range(3)]
            return (replies, app._resp_cache, app.service.node_cache.snapshot(),
                    app.service.graph_deterministic(),
                    [n.deterministic for n in app.service.walker._nodes()])
        finally:
            await app.close()
            await uclose()

    replies, resp_cache, node, deterministic, nodes = run(go())
    assert all(st == 200 and "x-sct-cache" not in {k.lower() for k in h}
               for st, _, h in replies)
    assert nodes == [False, True] and deterministic is False
    assert resp_cache is None  # the exact tier is not bound
    assert unit.calls == 3  # no node-tier hit skipped the remote unit
    assert node["entries"] == 1 and node["hits"] == 2  # the local model's repeats hit


def test_grpc_endpoint_and_remote_cascade_router_raise_by_name(monkeypatch):
    # a GRPC endpoint is served on the h2 plane since the gRPC slice; over
    # the grpcio transport it is refused by name
    monkeypatch.setenv("SCT_GRPC_IMPL", "grpcio")
    grpc = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "g", "type": "MODEL",
        "endpoint": {"service_host": "127.0.0.1", "service_port": 1, "type": "GRPC"}}})
    service = PredictionService(grpc, device="cpu")
    with pytest.raises(GraphUnitError, match="'g'.*GRPC"):
        service.start()
    casc = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "casc", "type": "CASCADE_ROUTER", "endpoint": _rest(1),
        "children": [{"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}})
    service = PredictionService(casc, device="cpu")
    with pytest.raises(GraphUnitError, match="'casc'.*CASCADE_ROUTER"):
        service.start()
    with pytest.raises(GraphUnitError, match="no transport for REST"):
        GraphWalker(PredictiveUnitSpec.from_dict({"name": "m", "type": "MODEL",
                                                  "endpoint": _rest(1)}), device="cpu")


def test_remote_nodes_are_skipped_by_warmup_close_and_iter_components():
    async def go():
        uport, uclose = await _port_unit(TimesTen())
        graph = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
                 "children": [{"name": "m", "type": "MODEL", "endpoint": _rest(uport)},
                              {"name": "s", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}
        service = PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                    device="cpu")
        service.start()
        try:
            names = [n for n, _ in service.walker.iter_components()]
            report = await service.warmup()
            return names, report, service.walker.deterministic()
        finally:
            await service.close()
            await uclose()

    names, report, deterministic = run(go())
    assert names == ["r", "s"] and report == {} and deterministic is False


# -- the form-encoded bodies both engines take ------------------------------


def test_form_encoded_predictions_and_feedback_answer_as_the_jax_engine():
    graph = {"name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
             "parameters": [{"name": "n_branches", "value": "2", "type": "INT"},
                            {"name": "epsilon", "value": "0.0", "type": "FLOAT"}],
             "children": [{"name": "a", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
                          {"name": "b", "type": "MODEL", "implementation": "SIMPLE_MODEL"}]}

    async def one(starter):
        base, close = await starter(graph)
        try:
            async with aiohttp.ClientSession() as s:
                url = base + "/api/v0.1/predictions"
                st, reply, _ = await _post(s, url, REQ, form=True)
                out = [(st, _strip(reply))]
                fb = {"request": REQ, "response": reply, "reward": 1.0}
                st, fb_reply, _ = await _post(s, base + "/api/v0.1/feedback", fb, form=True)
                out.append((st, fb_reply))
                async with s.post(url, data={"other": "x"}) as resp:
                    out.append((resp.status, json.loads(await resp.read())))
                async with s.post(url, data=b"{not json",
                                  headers={"Content-Type": "application/json"}) as resp:
                    out.append((resp.status, json.loads(await resp.read())["status"]["code"]))
                return out
        finally:
            await close()

    jax, port = run(one(_jax_engine)), run(one(_port_engine))
    assert port[0] == jax[0] and port[0][0] == 200
    assert port[0][1]["data"]["ndarray"] == [[0.1, 0.9, 0.5]]
    assert port[1][0] == jax[1][0] == 200
    assert port[1][1]["status"]["status"] == jax[1][1]["status"]["status"] == "SUCCESS"
    assert port[2] == jax[2]  # 400, "form request missing 'json' field"
    assert port[2][1]["status"]["reason"] == "form request missing 'json' field"
    assert port[3] == jax[3] == (400, 400)
