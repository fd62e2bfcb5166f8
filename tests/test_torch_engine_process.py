"""The port's engine and gateway as processes: three repairs of earlier
slices and the engine's process options.

- C16: the engine's ``_serve`` tunes the event loop once its units are
  warm, as the JAX engine's startup hook does (``utils/loops.py``): after
  boot the collector's gen-0 threshold is 50,000, the startup objects are
  frozen and the loop runs eager tasks.  The gateway calls the same
  function.
- C17: under ``SELDON_DEPLOYMENT_ID=mydep`` an engine whose predictor is
  named ``default`` labels its ``/prometheus`` families, its wire edges
  and its cache allow-list check with ``mydep``, as the JAX engine does
  (``SCT_CACHE_DEPLOYMENTS=mydep`` turns the response tiers on in both).
- C18: a replica that no record lists any more keeps no pool in the
  router poller or the fleet collector: the next sweep closes it, and
  its socket.
- ``--grpc-port`` starts the Seldon gRPC service beside the REST front;
  ``--workers 2`` runs two spawned processes that both listen on both
  ports (SO_REUSEPORT) and both answer fresh connections.
- The grpcio transport (``ENGINE_GRPC_IMPL``/``SCT_GRPC_IMPL=grpcio``)
  raises by name in every entry point.

Every socket binds to loopback; each subprocess has its own timeout."""

import asyncio
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

import chip_smoke
from seldon_core_tpu.engine.app import EngineApp as JaxEngineApp
from seldon_core_tpu.engine.service import PredictionService as JaxPredictionService
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu_torch.disagg.router import ReplicaRouter, RouterPoller
from seldon_core_tpu_torch.engine import grpc_transport
from seldon_core_tpu_torch.engine.service import DEFAULT_PREDICTOR
from seldon_core_tpu_torch.gateway import grpc_gateway
from seldon_core_tpu_torch.gateway import store as tstore
from seldon_core_tpu_torch.gateway.app import GatewayApp
from seldon_core_tpu_torch.obs.fleet import FleetCollector
from seldon_core_tpu_torch.runtime.microservice import main as microservice_main
from seldon_core_tpu_torch.testing import loadtest as lt
from seldon_core_tpu_torch.utils.loops import tune_server_loop

ROOT = Path(__file__).resolve().parents[1]
LO = "127.0.0.1"
run = asyncio.run

# the engine in a fresh interpreter: _serve with a stop event, driven over
# both fronts once ready, then the loop's and the collector's state
_SERVE = r"""
import asyncio, gc, json, sys
from seldon_core_tpu_torch.engine import app as A
from seldon_core_tpu_torch.wire import FastGrpcChannel
from seldon_core_tpu_torch.wire.h1client import H1Pool
from seldon_core_tpu_torch.contract import Payload, payload_to_proto
import numpy as np

async def main(port, gport):
    stop = asyncio.Event()
    task = asyncio.ensure_future(A._serve("127.0.0.1", port, "cpu", None, None, gport,
                                          stop=stop))
    pool = H1Pool("127.0.0.1", port)
    for _ in range(600):
        try:
            if (await pool.get("/ready", timeout=2)).status == 200:
                break
        except OSError:
            pass
        await asyncio.sleep(0.05)
    body = b'{"data": {"ndarray": [[1.0, 2.0, 3.0]]}}'
    replies = [(await pool.post("/api/v0.1/predictions", body, {}, timeout=30)).status
               for _ in range(2)]
    ch = FastGrpcChannel(f"127.0.0.1:{gport}")
    raw = payload_to_proto(Payload.from_array(np.ones((1, 3)))).SerializeToString()
    await ch.call("/seldon.protos.Seldon/Predict", raw, timeout=30)
    await ch.close()
    loop = asyncio.get_running_loop()
    out = {"threshold": gc.get_threshold(), "frozen": gc.get_freeze_count(),
           "eager": loop.get_task_factory() is asyncio.eager_task_factory,
           "replies": replies,
           "prometheus": (await pool.get("/prometheus", timeout=10)).body.decode(),
           "cache": json.loads((await pool.get("/stats/cache", timeout=10)).body),
           "wire": json.loads((await pool.get("/stats/wire", timeout=10)).body)}
    await pool.close()
    stop.set()
    await asyncio.wait_for(task, 30)
    print("RESULT " + json.dumps(out))

asyncio.run(main(int(sys.argv[1]), int(sys.argv[2])))
"""

_CACHE_ENV = {"SELDON_DEPLOYMENT_ID": "mydep", "SCT_CACHE": "1",
              "SCT_CACHE_DEPLOYMENTS": "mydep"}


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("ENGINE_PREDICTOR", "ENGINE_CO_PREDICTORS", "SCT_GRPC_IMPL",
                        "ENGINE_GRPC_IMPL")}
    return {**env, "PYTHONPATH": str(ROOT), **extra}


def _labels(exposition: str, family: str) -> set:
    """The (deployment_name, predictor_name) label pairs of a family's
    samples."""
    import re

    out = set()
    for line in exposition.splitlines():
        if line.startswith(family) and "deployment_name=" in line:
            d = re.search(r'deployment_name="([^"]*)"', line).group(1)
            p = re.search(r'predictor_name="([^"]*)"', line).group(1)
            out.add((d, p))
    return out


# sct: test-hygiene-ok one engine in a fresh interpreter (gc and loop state are process-wide), bounded waits
def test_c16_and_c17_the_served_engine_tunes_its_loop_and_takes_the_deployment_name():
    port, gport = chip_smoke._free_port(), chip_smoke._free_port()
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(port), str(gport)], cwd=ROOT,
                          env=_env(**_CACHE_ENV), capture_output=True, text=True, timeout=240)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
    assert line is not None, proc.stderr[-3000:]
    got = json.loads(line[len("RESULT "):])
    # C16: tuned once after boot, as the JAX engine's startup hook
    assert got["threshold"] == [50000, 25, 25] and got["frozen"] > 0 and got["eager"]
    assert got["replies"] == [200, 200]
    # C17: the name on every label, edge and check
    assert _labels(got["prometheus"], "seldon_api_engine_server_requests_duration_seconds_count") == \
        {("mydep", "default")}
    assert sorted(got["wire"]["wire"]["stages"]["engine-rest"]) == ["mydep"]
    assert sorted(got["wire"]["wire"]["stages"]["engine-grpc"]) == ["mydep"]
    assert got["wire"]["wire"]["stages"]["engine-grpc"]["mydep"]["requests"] == 1
    assert "response" in got["cache"]["cache"]  # the tiers are on for mydep
    assert got["cache"]["cache"]["response"]["hits"] == 1  # the repeat was a hit

    # the JAX engine, built as its _serve builds it, under the same names
    async def jax_engine():
        spec = JaxPredictorSpec.model_validate(DEFAULT_PREDICTOR)
        service = JaxPredictionService(spec, deployment_name=os.environ["SELDON_DEPLOYMENT_ID"])
        srv = TestServer(JaxEngineApp(service).build(), host=LO)
        await srv.start_server()
        try:
            async with aiohttp.ClientSession() as s:
                for _ in range(2):
                    async with s.post(f"http://{LO}:{srv.port}/api/v0.1/predictions",
                                      json={"data": {"ndarray": [[1.0, 2.0, 3.0]]}}) as r:
                        assert r.status == 200
                async with s.get(f"http://{LO}:{srv.port}/prometheus") as r:
                    prom = await r.text()
                async with s.get(f"http://{LO}:{srv.port}/stats/cache") as r:
                    cache = await r.json()
        finally:
            await srv.close()
        return prom, cache

    saved = {k: os.environ.get(k) for k in _CACHE_ENV}
    os.environ.update(_CACHE_ENV)
    try:
        prom, cache = run(jax_engine())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert ("mydep", "default") in _labels(prom, "seldon_api_engine_server_requests_duration_seconds_count")
    assert "response" in cache["cache"]


def test_c16_the_gateway_and_the_engine_share_one_tuning():
    """The gateway's entry point calls the same function (its inline copy
    is gone); the function sets what the JAX ``tune_server_loop`` sets."""
    from seldon_core_tpu.utils.loops import tune_server_loop as jax_tune
    from seldon_core_tpu_torch.gateway import app as gwapp

    assert not hasattr(gwapp, "_tune_loop") and gwapp.tune_server_loop is tune_server_loop

    async def after(fn):
        before = gc.get_threshold()
        try:
            fn()
            return (gc.get_threshold(),
                    asyncio.get_running_loop().get_task_factory() is asyncio.eager_task_factory)
        finally:
            gc.unfreeze()
            gc.set_threshold(*before)

    assert run(after(tune_server_loop)) == run(after(jax_tune)) == ((50000, 25, 25), True)


class _Stub:
    """A loopback HTTP/1.1 server answering ``{}`` to every request on
    keep-alive connections; it counts its open connections and closes
    every one when it stops (so ``wait_closed`` returns)."""

    def __init__(self):
        self.writers: set = set()
        self.server = None

    async def start(self) -> int:
        self.server = await asyncio.start_server(self._handle, LO, 0)
        return self.server.sockets[0].getsockname()[1]

    async def _handle(self, reader, writer):
        self.writers.add(writer)
        try:
            while True:
                head = await reader.readuntil(b"\r\n\r\n")
                n = next((int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                          if ln.lower().startswith(b"content-length")), 0)
                if n:
                    await reader.readexactly(n)
                writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: application/json\r\n"
                             b"content-length: 2\r\n\r\n{}")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.writers.discard(writer)
            writer.close()

    async def open_after(self, want_closed: bool) -> int:
        """The open connections, once a close the client made has reached
        the server (a few loop ticks later; 2 s at most)."""
        for _ in range(200):
            if bool(self.writers) != want_closed:
                break
            await asyncio.sleep(0.01)
        return len(self.writers)

    async def stop(self):
        self.server.close()
        for w in list(self.writers):
            w.close()
        await asyncio.wait_for(self.server.wait_closed(), 5)


@pytest.mark.parametrize("who", ["router_poller", "fleet_collector"])
def test_c18_a_departed_replicas_pool_is_closed_at_the_next_sweep(who):
    async def go():
        stubs = [_Stub() for _ in range(3)]
        ports = [await s.start() for s in stubs]
        store = tstore.DeploymentStore()

        def put(ps):
            store.put(tstore.DeploymentRecord(name="chat", oauth_key="k", oauth_secret="s",
                                              endpoints=tuple(f"{LO}:{p}" for p in ps)))

        put(ports)
        poller = (RouterPoller(store, ReplicaRouter(), interval_s=3600) if who == "router_poller"
                  else FleetCollector(store, service="gateway", interval_s=3600, jitter=0.0))
        try:
            await poller.poll_once()
            first = (sorted(p for _, p in poller._pools),
                     [await s.open_after(False) for s in stubs])
            put(ports[:2])  # the third replica leaves the record
            await poller.poll_once()
            second = (sorted(p for _, p in poller._pools),
                      [await s.open_after(i == 2) for i, s in enumerate(stubs)])
        finally:
            await poller.stop()
            for s in stubs:
                await s.stop()
        return ports, first, second

    ports, (pools1, open1), (pools2, open2) = run(go())
    assert pools1 == sorted(ports) and all(n >= 1 for n in open1)
    assert pools2 == sorted(ports[:2])
    assert open2[2] == 0 and all(n >= 1 for n in open2[:2])


# sct: test-hygiene-ok the engine CLI with two spawned workers, bounded waits and a terminate
def test_workers_share_both_ports_and_both_answer_fresh_connections():
    port, gport = chip_smoke._free_port(), chip_smoke._free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.engine.app", "--device", "cpu",
         "--host", LO, "--port", str(port), "--grpc-port", str(gport), "--workers", "2"],
        cwd=ROOT, env=_env(SELDON_DEPLOYMENT_ID="w"), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        pids: set = set()
        deadline = time.time() + 120
        while time.time() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            tree = chip_smoke.descendants(proc.pid)
            rest, grpc = (chip_smoke.socket_owners(tree, port),
                          chip_smoke.socket_owners(tree, gport))
            if len(rest) == 2 and rest == grpc:
                pids = rest
                break
            time.sleep(0.2)
        assert len(pids) == 2, "two processes never listened on both ports"
        body = json.dumps({"data": {"ndarray": [[1.0, 2.0, 3.0]]}}).encode()
        raw = chip_smoke._sm_ndarray([[1.0, 2.0, 3.0]])

        async def fronts():
            rest_owners, grpc_owners = [], []
            for _ in range(16):
                for _ in range(100):  # a worker may still be warming
                    try:
                        st, owner = await asyncio.to_thread(
                            chip_smoke._rest_exchange_owner, port, body, pids)
                        break
                    except OSError:
                        await asyncio.sleep(0.1)
                rest_owners.append((st, tuple(owner)))
                status, gowner = await chip_smoke._grpc_exchange_owner(gport, raw, pids)
                grpc_owners.append((status[0], tuple(gowner)))
            return rest_owners, grpc_owners

        rest_owners, grpc_owners = run(fronts())
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert {st for st, _ in rest_owners} == {200} and {st for st, _ in grpc_owners} == {200}
    assert all(len(o) == 1 for _, o in rest_owners + grpc_owners)
    assert {o[0] for _, o in rest_owners} == pids == {o[0] for _, o in grpc_owners}
    # the spawned worker left with its parent
    assert not [p for p in pids if os.path.exists(f"/proc/{p}") and _alive(p)]


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.parametrize("var", ["ENGINE_GRPC_IMPL", "SCT_GRPC_IMPL"])
def test_the_grpcio_transport_raises_by_name_in_every_entry_point(monkeypatch, tmp_path, var):
    from seldon_core_tpu_torch.engine.grpc_app import start_engine_grpc
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec
    from seldon_core_tpu_torch.runtime.grpc_service import start_grpc

    monkeypatch.setenv(var, "grpcio")
    svc = PredictionService(PredictorSpec.from_dict(DEFAULT_PREDICTOR), device="cpu")
    with pytest.raises(NotImplementedError, match="grpcio"):
        run(start_engine_grpc(svc, 0, host=LO))
    with pytest.raises(NotImplementedError, match="grpcio"):
        run(start_grpc(object(), 0, host=LO))
    with pytest.raises(NotImplementedError, match="grpcio"):
        grpc_transport.ChannelCache().get(f"{LO}:1")
    store = tstore.DeploymentStore()
    with pytest.raises(NotImplementedError, match="grpcio"):
        run(grpc_gateway.start_gateway_grpc(GatewayApp(store), 0, host=LO))
    (tmp_path / "usermod.py").write_text("class usermod:\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(NotImplementedError, match="grpcio"):
        microservice_main(["usermod", "GRPC", "--port", "0"])
    with pytest.raises(NotImplementedError, match="GatewayGrpc"):
        grpc_gateway.GatewayGrpc(None)
    with pytest.raises(NotImplementedError, match="grpcio"):
        lt.run_load(f"{LO}:1", [b""], grpc=True, grpc_lib="grpcio")


def test_the_load_harness_drives_the_engine_over_grpc():
    """``--grpc`` (the h2 client): each payload once, every reply a 200
    SeldonMessage, the message bytes counted both ways."""
    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    payloads = [lt.default_grpc_payload(rows) for rows in (1, 2, 3, 4)]

    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(DEFAULT_PREDICTOR),
                                          device="cpu"))
        await app.start(LO, 0, grpc_port=0)
        await app.boot()
        try:
            return await asyncio.to_thread(lt.run_load, f"{LO}:{app.grpc_port}", payloads,
                                           grpc=True, once=True, concurrency=2)
        finally:
            await app.close()

    res = run(go())
    assert res.requests == 4 and res.failures == 0
    assert res.bytes_sent == sum(map(len, payloads))
    assert res.bytes_received == sum(len(r) for r in res.replies) > 0
    with pytest.raises(ValueError, match="REST-only"):
        lt.run_load(f"{LO}:1", [b""], grpc=True, arrival_rps=5.0)
