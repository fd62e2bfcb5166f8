"""The port's wrapper runtime (``seldon_core_tpu_torch/runtime/``) against
the JAX package's: the same user classes and the same bodies go to every
route of both servers (the JAX one under aiohttp's test server, the port's
on ``asyncio.start_server``), and both answer the same status and the same
JSON.  Then the outlier adapter, the persistence stores and snapshots
(the cases of ``tests/test_persistence.py``, on the port's module), and
the command line booted once in a subprocess."""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from seldon_core_tpu.runtime.outlier import OutlierDetectorAdapter as JaxOutlierAdapter
from seldon_core_tpu.runtime.server import MicroserviceApp as JaxMicroserviceApp
from seldon_core_tpu_torch.contract.codec import CodecError
from seldon_core_tpu_torch.graph.units import EpsilonGreedy
from seldon_core_tpu_torch.runtime import MicroserviceApp, load_component
from seldon_core_tpu_torch.runtime import persistence as P
from seldon_core_tpu_torch.runtime.microservice import main as microservice_main
from seldon_core_tpu_torch.runtime.outlier import OutlierDetectorAdapter
from seldon_core_tpu_torch.wire.h1server import request_json

ROOT = Path(__file__).resolve().parent.parent
run = asyncio.run


class Doubler:
    class_names = ["a", "b"]

    def __init__(self):
        self.calls = 0

    def predict(self, X, names):
        self.calls += 1
        if np.asarray(X).size and np.asarray(X).ravel()[0] == 13:
            raise ValueError("unlucky row")
        return np.asarray(X, float) * 2

    def tags(self):
        return {"calls": self.calls}

    def metrics(self):
        return [{"key": "doubler_calls", "type": "COUNTER", "value": 1}]


class Shift:
    def transform_input(self, X, names):
        return np.asarray(X, float) + 1

    def transform_output(self, X, names):
        return np.asarray(X, float) - 1


class SignRouter:
    def __init__(self):
        self.rewards = []

    def route(self, X, names):
        return 1 if np.asarray(X).ravel()[0] > 0 else 0

    def send_feedback(self, X, names, reward, truth=None, routing=None):
        self.rewards.append((float(reward), routing))


class Mean:
    def aggregate(self, Xs, names_list):
        return np.mean([np.asarray(x, float) for x in Xs], axis=0)


class RowScorer:
    def score(self, X, feature_names):
        return np.abs(np.asarray(X, float)).sum(axis=1)


ROWS = {"data": {"names": ["x", "y"], "ndarray": [[1.0, -2.0], [0.5, 3.0]]}}
NEG = {"data": {"ndarray": [[-1.0, 2.0]]}}
TENSOR = {"data": {"tensor": {"shape": [2, 2], "values": [1.0, 2.0, 3.0, 4.0]}}}
FEEDBACK = {"request": ROWS, "response": {"meta": {"routing": {"r": 1}}, "data": ROWS["data"]},
            "reward": 0.5}
CASES = [
    # (route, body, how the body is sent)
    ("/predict", ROWS, "json"),
    ("/predict", TENSOR, "json"),
    ("/api/v0.1/predictions", ROWS, "json"),
    ("/predict", ROWS, "form"),
    ("/predict", ROWS, "multipart"),
    ("/predict", {"other": "{}"}, "form-without-json"),
    ("/predict", b"{not json", "raw"),
    ("/predict", {"data": {"ndarray": [[13.0]]}}, "json"),  # the user's exception
    ("/predict", {"data": {"tensor": {"shape": [3], "values": [1.0]}}}, "json"),  # codec refuses
    ("/transform-input", ROWS, "json"),
    ("/transform-output", ROWS, "form"),
    ("/route", ROWS, "json"),
    ("/route", NEG, "json"),
    ("/aggregate", {"seldonMessages": [ROWS, ROWS]}, "json"),
    ("/aggregate", {"seldonMessages": []}, "json"),
    ("/aggregate", [1, 2], "json"),
    ("/send-feedback", FEEDBACK, "json"),
    ("/send-feedback", {**FEEDBACK, "routing": 0}, "form"),
]


def _components():
    return {"/predict": Doubler(), "/api/v0.1/predictions": Doubler(),
            "/transform-input": Shift(), "/transform-output": Shift(),
            "/route": SignRouter(), "/aggregate": Mean(), "/send-feedback": SignRouter()}


async def _send(session, base, path, body, how):
    if how == "json":
        kw = {"data": json.dumps(body).encode(), "headers": {"Content-Type": "application/json"}}
    elif how == "raw":
        kw = {"data": body, "headers": {"Content-Type": "application/json"}}
    elif how == "form":
        kw = {"data": {"json": json.dumps(body)}}
    elif how == "multipart":
        form = aiohttp.FormData()
        form.add_field("json", json.dumps(body), content_type="application/json")
        kw = {"data": form}
    else:  # a form with no json field
        kw = {"data": body}
    async with session.post(base + path, **kw) as resp:
        return resp.status, json.loads(await resp.read())


async def _both(make_comp, name, service_type, requests):
    """Each (path, body, how) to a JAX and a port server over the same kind
    of component -> the two lists of (status, reply)."""
    jax_srv = TestServer(JaxMicroserviceApp(make_comp(), name=name,
                                            service_type=service_type).build())
    await jax_srv.start_server()
    port_app = MicroserviceApp(make_comp(), name=name, service_type=service_type)
    await port_app.start()
    try:
        async with aiohttp.ClientSession() as session:
            jax = [await _send(session, f"http://127.0.0.1:{jax_srv.port}", *r) for r in requests]
            port = [await _send(session, f"http://127.0.0.1:{port_app.port}", *r)
                    for r in requests]
        return jax, port
    finally:
        await port_app.close()
        await jax_srv.close()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{p}-{h}" for p, _, h in CASES])
def test_every_route_answers_as_the_jax_runtime(case):
    path, body, how = CASES[case]
    comps = _components()
    jax, port = run(_both(lambda: type(comps[path])(), "r", "MODEL", [(path, body, how)]))
    assert port == jax, (port, jax)


@pytest.mark.parametrize("body,ctype,want", [
    (b"json=%7B%22a%22%3A1%7D", "application/x-www-form-urlencoded", {"a": 1}),
    (b'--xx\r\nContent-Disposition: form-data; name="json"\r\n\r\n{"b": 2}\r\n--xx--\r\n',
     "multipart/form-data; boundary=xx", {"b": 2}),
    (b'{"c": 3}', "application/x-www-form-urlencoded", {"c": 3}),  # urllib's default label
    (b'--xx\r\nContent-Disposition: form-data; name="json"\r\n\r\n\xff\r\n--xx--\r\n',
     "multipart/form-data; boundary=xx", "malformed form body"),
    (b"x=1", "application/x-www-form-urlencoded", "form request missing 'json' field"),
    (b"", "application/json", "invalid JSON body"),
])
def test_the_body_parser(body, ctype, want):
    if isinstance(want, dict):
        assert request_json(body, {"content-type": ctype}) == want
    else:
        with pytest.raises(CodecError, match=want):
            request_json(body, {"content-type": ctype})


def test_stateful_sequence_and_get_routes_match():
    """A sequence on one server keeps the component's state as the JAX
    runtime does (its tags count every call), and the GET routes answer."""
    reqs = [("/predict", ROWS, "json")] * 3 + [("/predict", ROWS, "form")]
    jax, port = run(_both(Doubler, "m", "MODEL", reqs))
    assert port == jax
    assert [r[1]["meta"]["tags"]["calls"] for r in port] == [1, 2, 3, 4]
    assert port[0][1]["data"]["names"] == ["a", "b"]

    async def gets():
        app = MicroserviceApp(Doubler())
        await app.start()
        try:
            async with aiohttp.ClientSession() as s:
                out = []
                for path in ("/ping", "/ready", "/health/status", "/nowhere"):
                    async with s.get(f"http://127.0.0.1:{app.port}{path}") as r:
                        out.append((r.status, await r.text()))
                return out
        finally:
            await app.close()

    got = run(gets())
    assert got[:3] == [(200, "pong"), (200, "ready"), (200, "pong")]
    assert got[3][0] == 404


def test_outlier_adapter_tags_the_same_scores():
    reqs = [("/transform-input", ROWS, "json"), ("/predict", NEG, "json")]

    async def go(adapter_cls, app_cls, jax_side):
        comp = adapter_cls(RowScorer())
        if jax_side:
            srv = TestServer(app_cls(comp, name="o").build())
            await srv.start_server()
            base, closer = f"http://127.0.0.1:{srv.port}", srv.close
        else:
            app = app_cls(comp, name="o")
            await app.start()
            base, closer = f"http://127.0.0.1:{app.port}", app.close
        try:
            async with aiohttp.ClientSession() as s:
                return [await _send(s, base, *r) for r in reqs]
        finally:
            await closer()

    jax = run(go(JaxOutlierAdapter, JaxMicroserviceApp, True))
    port = run(go(OutlierDetectorAdapter, MicroserviceApp, False))
    assert port == jax
    assert port[0][1]["meta"]["tags"]["outlierScore"] == [3.0, 3.5]
    assert port[0][1]["data"]["ndarray"] == ROWS["data"]["ndarray"]  # passes through
    with pytest.raises(TypeError, match="score"):
        OutlierDetectorAdapter(Shift())


# -- persistence: the cases of tests/test_persistence.py on the port --------


def test_file_store_roundtrip_and_key_sanitization(tmp_path):
    store = P.FileStateStore(str(tmp_path))
    assert store.get("k") is None
    store.set("k", b"abc")
    assert store.get("k") == b"abc"
    store.delete("k")
    assert store.get("k") is None
    store.delete("k")  # idempotent
    store.set("a/b:c", b"x")
    assert store.get("a/b:c") == b"x"
    assert all(os.sep not in f[: -len(".pkl")] for f in os.listdir(tmp_path))


def test_memory_store_namespaced_sharing():
    a, b, c = P.MemoryStateStore("t-ns-1"), P.MemoryStateStore("t-ns-1"), P.MemoryStateStore("t-ns-2")
    a.set("k", b"v")
    assert b.get("k") == b"v" and c.get("k") is None


def test_file_store_dir_modes(tmp_path):
    fresh = tmp_path / "fresh"
    P.FileStateStore(str(fresh))
    assert os.stat(fresh).st_mode & 0o777 == 0o700 & ~_umask()
    root = tmp_path / "state"
    root.mkdir(mode=0o777)
    os.chmod(root, 0o777)
    P.FileStateStore(str(root))
    assert os.stat(root).st_mode & 0o022 == 0


def _umask() -> int:
    mask = os.umask(0)
    os.umask(mask)
    return mask


def test_store_from_env(tmp_path):
    assert isinstance(P.store_from_env({"PERSISTENCE_STORE": "memory"}), P.MemoryStateStore)
    s = P.store_from_env({"PERSISTENCE_STORE": f"file:{tmp_path}"})
    assert isinstance(s, P.FileStateStore) and s.root == str(tmp_path)
    assert isinstance(P.store_from_env({"PERSISTENCE_STORE": str(tmp_path)}), P.FileStateStore)
    s3 = P.store_from_env({"PERSISTENCE_DIR": str(tmp_path)})
    assert isinstance(s3, P.FileStateStore) and s3.root == str(tmp_path)
    with pytest.raises(ValueError, match="username"):
        P.store_from_env({"PERSISTENCE_STORE": "redis://user:pw@localhost:6379"})


def test_whole_object_and_partial_state_roundtrip():
    unit = EpsilonGreedy(n_branches=3)
    unit.send_feedback(None, [], reward=1.0, routing=2)
    back = P.load_component(P.dump_component(unit))
    assert isinstance(back, EpsilonGreedy)
    np.testing.assert_array_equal(back.pulls, unit.pulls)
    np.testing.assert_array_equal(back.value, unit.value)

    class Stateful:
        def __init__(self):
            self.n = 0
            self.resource = object()  # unpicklable

        def get_state(self):
            return {"n": self.n}

        def set_state(self, state):
            self.n = state["n"]

    a = Stateful()
    a.n = 7
    b = Stateful()
    assert P.load_component(P.dump_component(a), fallback=b) is b and b.n == 7
    with pytest.raises(ValueError, match="set_state"):
        P.load_component(P.dump_component(a), fallback=None)


def test_killed_bandit_restores_arms(tmp_path, monkeypatch):
    monkeypatch.setenv("SELDON_DEPLOYMENT_ID", "dep1")
    monkeypatch.setenv("PREDICTOR_ID", "p1")
    assert P.state_key("bandit") == "persistence_dep1_p1_bandit"
    store = P.FileStateStore(str(tmp_path))
    unit = P.restore(lambda: EpsilonGreedy(n_branches=2, epsilon=0.0), "bandit", store)
    for _ in range(5):
        unit.send_feedback(None, [], reward=1.0, routing=1)
    thread = P.PersistenceThread(unit, P.state_key("bandit"), store, push_frequency=3600)
    thread.start()
    thread.stop()  # the final flush of a graceful shutdown
    thread.join(timeout=5)
    assert not thread.is_alive()
    unit2 = P.restore(lambda: EpsilonGreedy(n_branches=2, epsilon=0.0), "bandit", store)
    assert unit2.pulls[1] == 5 and unit2.value[1] == pytest.approx(1.0)
    assert unit2.route(np.array([[1.0]]), []) == 1
    store.set(P.state_key("x"), b"not a pickle")
    fresh = P.restore(lambda: EpsilonGreedy(n_branches=2), "x", store)
    assert fresh.pulls.sum() == 0


def test_periodic_flush_and_start_persistence(tmp_path, monkeypatch):
    store = P.FileStateStore(str(tmp_path))
    unit = EpsilonGreedy(n_branches=2)
    thread = P.PersistenceThread(unit, "k", store, push_frequency=0.05)
    thread.start()
    unit.send_feedback(None, [], reward=1.0, routing=0)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        data = store.get("k")
        if data is not None and P.load_component(data).pulls[0] == 1:
            break
        time.sleep(0.02)
    else:
        pytest.fail("the timer thread never flushed the updated state")
    thread.stop()
    thread.join(timeout=5)

    monkeypatch.setenv("PERSISTENCE_FREQUENCY", "3600")
    out = P.start_persistence(EpsilonGreedy(n_branches=2), "u1", store=store)
    out.send_feedback(None, [], reward=2.0, routing=0)
    P.PersistenceThread(out, P.state_key("u1"), store, 3600).flush()
    restored = P.start_persistence(EpsilonGreedy(n_branches=2), "u1", store=store)
    assert restored.pulls[0] == 1 and restored.value[0] == pytest.approx(2.0)


def test_restarted_router_keeps_its_rewards_over_http(tmp_path):
    """A persisted router served by the runtime: feedback over HTTP, a
    graceful stop (the final flush), a new process's component restored
    from the same store answers with the learned arms."""
    store = P.FileStateStore(str(tmp_path))

    async def serve_feedback(comp, n):
        app = MicroserviceApp(comp, name="r")
        await app.start()
        try:
            async with aiohttp.ClientSession() as s:
                for _ in range(n):
                    status, _ = await _send(s, f"http://127.0.0.1:{app.port}", "/send-feedback",
                                            {**FEEDBACK, "routing": 1, "reward": 1.0}, "json")
                    assert status == 200
        finally:
            await app.close()

    first = P.start_persistence(EpsilonGreedy(n_branches=2, epsilon=0.0), "r", store=store,
                                push_frequency=3600)
    run(serve_feedback(first, 3))
    P.PersistenceThread(first, P.state_key("r"), store, 3600).stop()
    second = P.start_persistence(EpsilonGreedy(n_branches=2, epsilon=0.0), "r", store=store,
                                 push_frequency=3600)
    assert second.pulls[1] == 3 and second is not first


# -- the command line ----------------------------------------------------------


def test_load_component_and_grpc_refused(tmp_path, monkeypatch):
    (tmp_path / "usermod.py").write_text(
        "class usermod:\n    def __init__(self, k=1):\n        self.k = k\n"
        "class Other:\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    assert load_component("usermod", {"k": 3}).k == 3
    assert type(load_component("usermod.Other", {})).__name__ == "Other"
    # GRPC is served on the h2 plane since the gRPC slice; its grpcio
    # transport is refused by name
    monkeypatch.setenv("SCT_GRPC_IMPL", "grpcio")
    with pytest.raises(RuntimeError, match="GRPC"):
        microservice_main(["usermod", "GRPC", "--port", "0"])


_COUNTER = """\
class Counter:
    def __init__(self, step=1):
        self.count = 0
        self.step = step

    def predict(self, X, names):
        self.count += self.step
        return [[float(self.count)]]
"""


# sct: test-hygiene-ok one subprocess for the command line, bounded waits
def test_cli_boots_serves_predict_and_flushes_state_at_sigterm(tmp_path):
    (tmp_path / "counter_model.py").write_text(_COUNTER)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{tmp_path}",
               PERSISTENCE_STORE=f"file:{tmp_path / 'state'}", PERSISTENCE_FREQUENCY="3600",
               PREDICTIVE_UNIT_ID="ctr", PREDICTIVE_UNIT_SERVICE_PORT="0",
               PREDICTIVE_UNIT_PARAMETERS='[{"name": "step", "value": "2", "type": "INT"}]')
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "counter_model.Counter", "REST", "--persistence", "1", "--port", str(port)],
        env=env, cwd=tmp_path, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/ready", timeout=1)
                break
            except (urllib.error.URLError, OSError):
                assert time.time() < deadline, "the microservice never became ready"
                time.sleep(0.2)
        outs = []
        for _ in range(3):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                         b'{"data": {"ndarray": [[1.0]]}}',
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as r:
                outs.append(json.loads(r.read()))
        assert [o["data"]["ndarray"] for o in outs] == [[[2.0]], [[4.0]], [[6.0]]]
        assert outs[0]["meta"]["requestPath"] == {"ctr": "Counter"}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
    # the exit flush wrote the state a restarted process restores
    store = P.FileStateStore(str(tmp_path / "state"))
    data = store.get(P.state_key("ctr"))
    assert data is not None
    sys.path.insert(0, str(tmp_path))
    try:
        assert P.load_component(data).count == 6
    finally:
        sys.path.remove(str(tmp_path))
