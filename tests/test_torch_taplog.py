"""The port's tap broker (``seldon_core_tpu_torch/taplog.py``) and request
tap (``gateway/tap.py``) against the JAX package's.

The frames are byte-equal for the same message; the port's client appends
to the JAX broker and the JAX client to the port's, and fetches from either
broker return equal records (the broker's ``ts`` aside, which is the
append's wall clock); the broker cases of the JAX ``tests/test_taplog.py``
(offsets across a restart, a torn tail truncated at reopen, a torn
trailing line skipped by a fetch, a reconnect after a broker restart,
ping and a refused append) on the port's broker; a publish to a dead broker
never blocks; ``tap_from_env`` selects like the JAX one, and
``GATEWAY_TAP_KAFKA`` is refused by name; the port's gateway taps each
prediction once, keyed by its puid.

Tolerance: frames and records exact (JSON-equal after dropping ``ts``)."""

import asyncio
import json

import pytest

from seldon_core_tpu import taplog as jtaplog
from seldon_core_tpu.gateway.tap import tap_from_env as jax_tap_from_env
from seldon_core_tpu_torch import taplog
from seldon_core_tpu_torch.gateway.tap import BrokerTap, JsonlTap, NullTap, tap_from_env

run = asyncio.run

MESSAGES = [
    {"op": "append", "topic": "client-a", "key": "puid-1", "value": {"x": [1, 2.5, None]}},
    {"op": "fetch", "topic": "client-a", "offset": 3, "max": 10},
    {"op": "ping"},
    {"ok": True, "records": [{"offset": 0, "ts": 1.5, "key": "k", "value": "é"}]},
]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_frames_are_byte_equal(i):
    assert taplog._frame(MESSAGES[i]) == jtaplog._frame(MESSAGES[i])


def _no_ts(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


@pytest.mark.parametrize("broker_pkg,client_pkg", [("jax", "port"), ("port", "jax")])
def test_clients_and_brokers_cross_the_packages(tmp_path, broker_pkg, client_pkg):
    """One package's client appends to the other's broker; a fetch by
    either client returns the records a same-package run returns."""
    pkgs = {"jax": jtaplog, "port": taplog}

    async def session(broker_mod, client_mod, root):
        server = broker_mod.TapBrokerServer(str(root), host="127.0.0.1", port=0)
        await server.start()
        writer = client_mod.TapBrokerClient("127.0.0.1", server.bound_port, timeout_s=2.0)
        readers = [m.TapBrokerClient("127.0.0.1", server.bound_port, timeout_s=2.0)
                   for m in (jtaplog, taplog)]
        try:
            offsets = [await writer.append("topicA", f"p{i}", {"i": i, "v": [i, "x"]})
                       for i in range(3)]
            offsets.append(await writer.append("topicB", "q", {"y": 3}))
            fetched = [[await r.fetch("topicA", offset=0), await r.fetch("topicA", offset=1),
                        await r.fetch("topicB")] for r in readers]
            return offsets, [[_no_ts(f) for f in fs] for fs in fetched]
        finally:
            for c in (writer, *readers):
                await c.close()
            await server.close()

    want = run(session(jtaplog, jtaplog, tmp_path / "ref"))
    got = run(session(pkgs[broker_pkg], pkgs[client_pkg], tmp_path / "cross"))
    assert got == want
    assert want[0] == [0, 1, 2, 0] and got[1][0] == got[1][1]
    # the segments on disk hold the same lines, the timestamps aside
    def lines(root):
        return [_no_ts([json.loads(x)])[0] for x in (root / "topicA.log").read_text().split("\n")
                if x]
    assert lines(tmp_path / "cross") == lines(tmp_path / "ref")


def test_offsets_survive_restart_and_torn_tail_truncates(tmp_path):
    async def go():
        server = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=0)
        await server.start()
        client = taplog.TapBrokerClient("127.0.0.1", server.bound_port, timeout_s=2.0)
        await client.append("t", "k", {"n": 1})
        await client.close()
        await server.close()
        with open(tmp_path / "t.log", "ab") as f:  # a crash mid-append
            f.write(b'{"offset": 1, "key": "k", "va')
        server2 = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=0)
        await server2.start()
        client2 = taplog.TapBrokerClient("127.0.0.1", server2.bound_port, timeout_s=2.0)
        try:
            off = await client2.append("t", "k", {"n": 2})
            return off, await client2.fetch("t")
        finally:
            await client2.close()
            await server2.close()

    off, records = run(go())
    assert off == 1 and [r["value"]["n"] for r in records] == [1, 2]


def test_fetch_skips_a_torn_trailing_line(tmp_path):
    async def go():
        server = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=0)
        await server.start()
        client = taplog.TapBrokerClient("127.0.0.1", server.bound_port, timeout_s=2.0)
        try:
            await client.append("t", "k", {"n": 1})
            with open(tmp_path / "t.log", "ab") as f:
                f.write(b'{"offset": 1, "key": "k", "va')
            records = await client.fetch("t")
            return records, await client.fetch("t", offset=0)
        finally:
            await client.close()
            await server.close()

    records, again = run(go())
    assert [r["value"]["n"] for r in records] == [1] and again == records


def test_client_reconnects_after_broker_restart_and_refuses_a_bad_append(tmp_path):
    async def go():
        server = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=0)
        await server.start()
        port = server.bound_port
        client = taplog.TapBrokerClient("127.0.0.1", port, timeout_s=2.0)
        await client.append("t", "k", {"n": 1})
        await server.close()
        server2 = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=port)
        await server2.start()
        try:
            off = await client.append("t", "k", {"n": 2})
            pong = await client.ping()
            with pytest.raises(RuntimeError, match="append failed"):
                await client.append("", "k", {"x": 1})  # no topic
            return off, pong
        finally:
            await client.close()
            await server2.close()

    assert run(go()) == (1, True)


def test_publish_to_dead_broker_does_not_block():
    async def go():
        tap = BrokerTap("127.0.0.1", 1, timeout_s=0.02)  # nothing listens on port 1
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for _ in range(20):
            await tap.publish("c", "p", {"a": 1}, {"b": 2})
        cost = loop.time() - t0
        await asyncio.sleep(0.3)
        await tap.close()
        return cost, tap.dropped, tap.published

    cost, dropped, published = run(go())
    assert cost < 0.5 and dropped > 0 and published == 0


@pytest.mark.parametrize("env,kind", [
    ({}, NullTap), ({"GATEWAY_TAP_BROKER": "127.0.0.1:7781"}, BrokerTap),
    ({"GATEWAY_TAP_DIR": "DIR"}, JsonlTap),
    ({"GATEWAY_TAP_BROKER": "127.0.0.1:7781", "GATEWAY_TAP_DIR": "DIR"}, BrokerTap),
])
def test_tap_from_env_selects_like_the_jax_package(tmp_path, env, kind):
    env = {k: (str(tmp_path) if v == "DIR" else v) for k, v in env.items()}
    got, want = tap_from_env(env), jax_tap_from_env(env)
    assert type(got) is kind and type(want).__name__ == kind.__name__
    assert got.enabled == want.enabled
    if kind is BrokerTap:
        assert (got.client.host, got.client.port) == (want.client.host, want.client.port)


def test_kafka_tap_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="GATEWAY_TAP_KAFKA.*GATEWAY_TAP_BROKER"):
        tap_from_env({"GATEWAY_TAP_KAFKA": "kafka:9092"})


def test_gateway_taps_each_prediction_once_keyed_by_puid(tmp_path):
    """The port's gateway over the port's engine (``SIMPLE_MODEL``) with a
    ``BrokerTap``: N predictions give N broker records on the client's
    topic, each keyed by its reply's puid, the request and reply JSON-equal
    to what was sent and received."""
    import aiohttp

    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.gateway.app import GatewayApp
    from seldon_core_tpu_torch.gateway.h1gateway import H1SpliceFrontend
    from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    simple = {"name": "p", "graph": {"name": "m", "type": "MODEL",
                                     "implementation": "SIMPLE_MODEL"}}

    async def go():
        broker = taplog.TapBrokerServer(str(tmp_path), host="127.0.0.1", port=0)
        await broker.start()
        engine = EngineApp(PredictionService(PredictorSpec.from_dict(simple), device="cpu"))
        await engine.start("127.0.0.1", 0)
        await engine.boot()
        store = DeploymentStore()
        store.put(DeploymentRecord(name="dep", oauth_key="key1", oauth_secret="sec1",
                                   engine_host="127.0.0.1", engine_rest_port=engine.port))
        gw = GatewayApp(store, tap=BrokerTap("127.0.0.1", broker.bound_port, timeout_s=2.0))
        front = H1SpliceFrontend(gw)
        port = await front.start(0, host="127.0.0.1")
        sent, got = [], []
        try:
            async with aiohttp.ClientSession() as s:
                r = await s.post(f"http://127.0.0.1:{port}/oauth/token",
                                 data={"client_id": "key1", "client_secret": "sec1"})
                tok = (await r.json())["access_token"]
                for i in range(4):
                    body = {"data": {"ndarray": [[float(i), 1.0]]}}
                    r = await s.post(f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                     json=body, headers={"Authorization": f"Bearer {tok}"})
                    sent.append(body)
                    got.append(await r.json())
            await gw.tap.close()  # drains the queue
            reader = taplog.TapBrokerClient("127.0.0.1", broker.bound_port, timeout_s=2.0)
            records = await reader.fetch("key1")
            await reader.close()
            return sent, got, records, front.fallbacks
        finally:
            await front.stop()
            await gw.close()
            await engine.close()
            await broker.close()

    sent, got, records, fallbacks = run(go())
    assert fallbacks == 5  # a tapped prediction takes the fallback core
    assert [r["key"] for r in records] == [g["meta"]["puid"] for g in got]
    assert [r["value"]["request"] for r in records] == sent
    assert [r["value"]["response"] for r in records] == got
