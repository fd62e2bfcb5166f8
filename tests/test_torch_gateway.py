"""The port's gateway (``seldon_core_tpu_torch/gateway/``) against the JAX
package's, and the slice as a whole.

- Stores and auth: a ``DeploymentStore`` loaded from one JSON file (and
  from ``GATEWAY_DEPLOYMENTS`` / ``TEST_CLIENT_KEY``) gives equal records,
  spec hashes, events and endpoint diffs in both packages; token expiry,
  revocation and the shared store behave alike under one fake clock.
- The settings the port reads carry the JAX registry's names, types and
  defaults.
- Refusals by name: the gRPC relay's grpcio transport
  (``SCT_GRPC_IMPL=grpcio`` beside ``--grpc-port``/``GATEWAY_GRPC_PORT``),
  ``--watch``, ``SCT_REST_IMPL=aiohttp``, ``SCT_SCALE`` and the fleet
  sidecar each raise with a message naming what they wait for (the Kafka
  tap is refused in ``tests/test_torch_taplog.py``).
- A repair: the port's engine closes with a pooled client's idle
  keep-alive connection open (before, ``close()`` waited on it forever).
- The slice as a whole: the port's gateway in front of two port engines
  on ``tiny`` (float32, the CPU), and the JAX gateway in front of two JAX
  engines, all four on the same seeded weights (a JAX checkpoint, which
  the port reads through ``models/weights.py``).  The same OAuth'd wave
  gives equal greedy token streams; after one poll the same shared-prefix
  requests land on the replica that holds the prefix in both, which
  reuses it for each; ``/api/v0.1/disagg/generate`` answers through the
  port's front; the port's ``/stats/fleet`` request count equals its
  engines' own ``/stats/summary`` counts.

Tolerance: tokens exact; JSON bodies equal after dropping ``puid`` and
timing fields."""

import asyncio
import dataclasses
import json
import time

import aiohttp
import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from seldon_core_tpu.engine.app import EngineApp as JaxEngineApp
from seldon_core_tpu.engine.service import PredictionService as JaxPredictionService
from seldon_core_tpu.executor import checkpoint as jck
from seldon_core_tpu.gateway import auth as jauth
from seldon_core_tpu.gateway import store as jstore
from seldon_core_tpu.gateway.app import GatewayApp as JaxGatewayApp
from seldon_core_tpu.gateway.h1gateway import H1SpliceFrontend as JaxFrontend
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.runtime import settings as jsettings
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.gateway import app as gwapp
from seldon_core_tpu_torch.gateway import auth as tauth
from seldon_core_tpu_torch.gateway import store as tstore
from seldon_core_tpu_torch.gateway.app import GatewayApp
from seldon_core_tpu_torch.gateway.h1gateway import H1SpliceFrontend
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.obs import fleet as tfleet
from seldon_core_tpu_torch.runtime import settings as tsettings
from seldon_core_tpu_torch.runtime.persistence import MemoryStateStore
from seldon_core_tpu_torch.wire.h1client import H1Pool

run = asyncio.run

DEPLOYMENTS = [
    {"name": "multi", "oauth_key": "mk", "oauth_secret": "ms",
     "endpoints": ["10.0.0.1:9000", {"host": "10.0.0.2", "rest_port": 9001, "grpc_port": 5002},
                   "h3"],
     "annotations": {"seldon.io/slo": "ttft_p99_ms=250"}},
    {"name": "single", "engine_host": "svc", "engine_rest_port": 8001},
    {"name": "pinned", "oauth_key": "pk", "oauth_secret": "p", "spec_hash": "abc123"},
]


def _records(store) -> list[dict]:
    return [dataclasses.asdict(r) for r in sorted(store.list(), key=lambda r: r.oauth_key)]


def test_store_loaded_from_one_file_matches(tmp_path):
    """Equal records (endpoints, primary, spec hash), replica sets, events
    and endpoint diffs for the same file, then an edited one."""
    path = tmp_path / "deps.json"
    path.write_text(json.dumps(DEPLOYMENTS))
    out = []
    for mod in (jstore, tstore):
        store, events, diff = mod.DeploymentStore(), [], mod.EndpointDiff()
        store.add_listener(lambda e, r, ev=events, d=diff: ev.append(
            (e, r.name, sorted(d.removed(e, r)), d.spec_changed(e, r))))
        assert store.load_file(str(path)) == 3
        first = _records(store)
        eps = {r.name: [e.key for e in r.replica_endpoints] for r in store.list()}
        edited = [dict(DEPLOYMENTS[0], endpoints=["10.0.0.1:9000"]), DEPLOYMENTS[1]]
        path.write_text(json.dumps(edited))
        store.load_file(str(path))
        path.write_text(json.dumps(DEPLOYMENTS))
        out.append((first, eps, _records(store), events,
                    store.get("mk").rest_base, store.get("mk").grpc_target))
    assert out[1] == out[0]
    first, eps = out[0][0], out[0][1]
    assert eps["multi"] == ["10.0.0.1:9000", "10.0.0.2:9001", "h3:8000"]
    assert [r["spec_hash"] for r in first][1] == "abc123"


def test_store_from_env_matches(tmp_path):
    env = {"GATEWAY_DEPLOYMENTS": json.dumps(DEPLOYMENTS[:2]), "TEST_CLIENT_KEY": "tk",
           "TEST_CLIENT_SECRET": "ts"}
    stores = [mod.DeploymentStore() for mod in (jstore, tstore)]
    for mod, store in zip((jstore, tstore), stores):
        mod.load_store_from_env(store, env)
    assert _records(stores[1]) == _records(stores[0])
    path = tmp_path / "d.json"
    path.write_text(json.dumps(DEPLOYMENTS[2:]))
    stores = [mod.DeploymentStore() for mod in (jstore, tstore)]
    for mod, store in zip((jstore, tstore), stores):
        mod.load_store_from_env(store, {"GATEWAY_DEPLOYMENTS": str(path)})
    assert _records(stores[1]) == _records(stores[0]) != []


def test_tokens_expire_and_revoke_alike():
    def session(mod, shared):
        now = [0.0]
        space = MemoryStateStore(namespace=f"gw-tokens-{mod.__name__}-{time.monotonic_ns()}")
        ts = (mod.SharedTokenStore(space, ttl_s=10.0, clock=lambda: now[0])
              if shared else mod.TokenStore(ttl_s=10.0, clock=lambda: now[0]))
        out = []
        a, ttl = ts.issue("ka")
        b, _ = ts.issue("kb")
        out += [ttl, ts.principal(a), ts.principal(b)]
        now[0] = 5.0
        c, _ = ts.issue("ka")
        ts.revoke_for_key("kb")
        for tok in (b, "junk"):
            with pytest.raises(mod.AuthError) as e:
                ts.principal(tok)
            out.append((str(e.value), e.value.status))
        now[0] = 10.0
        with pytest.raises(mod.AuthError) as e:
            ts.principal(a)
        out += [str(e.value), ts.principal(c)]
        now[0] = 16.0
        out.append(ts.purge_expired())
        return out

    for shared in (False, True):
        assert session(tauth, shared) == session(jauth, shared)
    assert tauth.verify_secret("s3", "s3") and not tauth.verify_secret("s3", "s4")
    assert type(tauth.token_store_from_env({})).__name__ == "TokenStore"
    assert type(tauth.token_store_from_env({"GATEWAY_TOKEN_STORE": "memory"})).__name__ == \
        "SharedTokenStore"


def test_settings_carry_the_jax_names_types_and_defaults():
    for name, s in tsettings.REGISTRY.items():
        j = jsettings.REGISTRY[name]
        assert (s.default, s.type) == (j.default, j.type), name
        for env in ({}, {name: "3"}, {name: "off"}, {name: "bogus"}):
            for getter in ("get_int", "get_float", "get_bool", "get_str"):
                try:
                    want = getattr(jsettings, getter)(name, env)
                except ValueError:
                    continue
                assert getattr(tsettings, getter)(name, env) == want, (name, env, getter)


@pytest.mark.parametrize("argv,env,match", [
    # the gRPC relay is served since the gRPC slice; its grpcio transport is not
    pytest.param(["--grpc-port", "5000"], {"SCT_GRPC_IMPL": "grpcio"}, "grpcio",
                 id="argv0-env0-gRPC slice"),
    pytest.param([], {"GATEWAY_GRPC_PORT": "5000", "SCT_GRPC_IMPL": "grpcio"}, "grpcio",
                 id="argv1-env1-gRPC slice"),
    (["--watch"], {}, "operator slice"),
    ([], {"GATEWAY_WATCH": "1"}, "operator slice"),
    ([], {"SCT_REST_IMPL": "aiohttp"}, "aiohttp REST front is not in the port"),
    (["--rest-impl", "aiohttp"], {}, "aiohttp REST front is not in the port"),
    ([], {"SCT_SCALE": "1"}, "embedded autoscaler .* operator slice"),
])
def test_unported_gateway_options_raise_by_name(monkeypatch, argv, env, match):
    for k in ("GATEWAY_GRPC_PORT", "GATEWAY_WATCH", "SCT_REST_IMPL", "SCT_SCALE",
              "SCT_GRPC_IMPL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        gwapp.main(["--port", "0", *argv])


@pytest.mark.parametrize("call", ["build_stats_app", "run_standalone", "main"])
def test_fleet_sidecar_raises_by_name(call):
    fn = getattr(tfleet, call)
    with pytest.raises(NotImplementedError, match="operator slice"):
        if call == "build_stats_app":
            fn(None)
        elif call == "run_standalone":
            run(fn())
        else:
            fn()


def test_autoscale_stats_answer_as_the_jax_gateway_without_one():
    store = tstore.DeploymentStore()
    assert GatewayApp(store).autoscale_snapshot() == \
        JaxGatewayApp(jstore.DeploymentStore()).autoscale_snapshot() == {"enabled": False}


def test_engine_closes_with_an_idle_keepalive_client():
    """Repair: the engine's ``close()`` ends connections idle between
    requests (a pooled client keeps one open), so it returns at once."""
    simple = {"name": "p", "graph": {"name": "m", "type": "MODEL",
                                     "implementation": "SIMPLE_MODEL"}}

    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(simple), device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        pool = H1Pool("127.0.0.1", app.port)
        resp = await pool.post("/api/v0.1/predictions", b'{"data": {"ndarray": [[1.0]]}}')
        assert resp.status == 200 and len(pool._idle) == 1  # held open, idle
        t0 = time.perf_counter()
        await asyncio.wait_for(app.close(), 5.0)
        dt = time.perf_counter() - t0
        await pool.close()
        return dt

    assert run(go()) < 2.0


# -- the slice as a whole ------------------------------------------------------

MAX_SEQ = 128
PREFIX = list(range(200, 232))  # 32 tokens: two full 16-token blocks
WAVE = [[5, 9, 2, 17, 3], [30, 7, 1], [1, 2, 3, 4, 8, 11]]
SUFFIXES = [[40, 41, 42], [50, 51, 52, 53, 54], [60, 61]]
NEW = 6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = jl.Config.tiny(max_seq=MAX_SEQ)
    params = jax.device_get(jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(3), cfg))
    path = str(tmp_path_factory.mktemp("gw") / "tiny.npz")
    jck.save_params(path, jax.tree.map(np.asarray, params))
    return path


def _graph(path: str) -> dict:
    params = {"family": "llama", "preset": "tiny", "max_seq": MAX_SEQ, "checkpoint": path,
              "dtype": "float32", "n_slots": 2, "decode_block": 4, "kv_prefix_reuse": True,
              "max_new_tokens": NEW}
    types = {bool: "BOOL", int: "INT", str: "STRING"}
    return {"name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [{"name": k, "value": str(v).lower() if isinstance(v, bool) else str(v),
                            "type": types[type(v)]} for k, v in params.items()]}


async def _port_engines(path):
    apps = []
    for _ in range(2):
        app = EngineApp(PredictionService(PredictorSpec.from_dict(
            {"name": "chat", "graph": _graph(path)}), device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        apps.append(app)

    async def close():
        for app in apps:
            await app.close()
    return [a.port for a in apps], close


async def _jax_engines(path):
    servers = []
    for _ in range(2):
        service = JaxPredictionService(JaxPredictorSpec.model_validate(
            {"name": "chat", "graph": _graph(path)}))
        srv = TestServer(JaxEngineApp(service).build())
        await srv.start_server()
        servers.append(srv)

    async def close():
        for srv in servers:
            await srv.close()
    return [s.port for s in servers], close


def _body(prompt) -> dict:
    return {"strData": json.dumps({"tokens": list(prompt), "max_new_tokens": NEW})}


def _tokens(reply: dict) -> list[int]:
    return json.loads(reply["strData"])["tokens"]


async def _slice(port_pkg: bool, path: str) -> dict:
    ports, close_engines = await (_port_engines(path) if port_pkg else _jax_engines(path))
    mod_store = tstore if port_pkg else jstore
    store = mod_store.DeploymentStore()
    store.put(mod_store.DeploymentRecord(
        name="chat", oauth_key="chat-key", oauth_secret="chat-secret",
        endpoints=tuple(f"127.0.0.1:{p}" for p in ports)))
    # the JAX engines compile a program at its first use on the CPU, which
    # can outlast the default 10 s forward budget on a loaded machine
    gw = (GatewayApp if port_pkg else JaxGatewayApp)(store, timeout_s=120.0)
    front = (H1SpliceFrontend if port_pkg else JaxFrontend)(gw)
    gport = await front.start(0, host="127.0.0.1")
    base = f"http://127.0.0.1:{gport}"
    out: dict = {}
    try:
        async with aiohttp.ClientSession() as s:
            r = await s.post(base + "/oauth/token", data={"grant_type": "client_credentials",
                                                          "client_id": "chat-key",
                                                          "client_secret": "chat-secret"})
            tok = (await r.json())["access_token"]
            hdrs = {"Authorization": f"Bearer {tok}"}

            async def predict(prompt):
                async with s.post(base + "/api/v0.1/predictions", json=_body(prompt),
                                  headers=hdrs) as r:
                    assert r.status == 200, await r.text()
                    return await r.json()

            replies = await asyncio.gather(*(predict(p) for p in WAVE))
            out["wave"] = [_tokens(r) for r in replies]
            out["wave_bodies"] = [{k: v for k, v in r.items() if k != "meta"} for r in replies]
            # warm the prefix on one replica, then one poll
            await predict(PREFIX + [33])
            await gw.poller.poll_once()
            before = gw.router.snapshot()
            shared = [await predict(PREFIX + sfx) for sfx in SUFFIXES]
            after = gw.router.snapshot()
            out["shared"] = [_tokens(r) for r in shared]
            keys = [f"127.0.0.1:{p}" for p in ports]
            reps_b, reps_a = before["deployments"]["chat-key"], after["deployments"]["chat-key"]
            warm = [i for i, k in enumerate(keys) if reps_b[k]["digest_entries"]]
            out["warm"] = warm
            out["shared_picks"] = [reps_a[k]["picked"] - reps_b[k]["picked"] for k in keys]
            out["prefix_picks"] = after["prefix_picks"] - before["prefix_picks"]
            out["warm_hits"] = []
            for p in ports:
                async with s.get(f"http://127.0.0.1:{p}/stats/cache") as r:
                    pref = (await r.json())["cache"]["prefix"]
                out["warm_hits"].append(sum(v.get("hits", 0) for v in pref.values()))
            if port_pkg:
                async with s.post(base + "/api/v0.1/disagg/generate",
                                  json={"tokens": WAVE[0], "max_new_tokens": NEW},
                                  headers=hdrs) as r:
                    out["disagg"] = (r.status, (await r.json()).get("tokens"))
                await gw.fleet.poll_once()
                fleet = gw.fleet_snapshot()["deployments"]["chat"]
                own = 0
                for p in ports:
                    async with s.get(f"http://127.0.0.1:{p}/stats/summary") as r:
                        own += (await r.json())["qos"]["admitted_total"]
                out["fleet"] = (fleet["qos"]["admitted_total"], own, fleet["replicas_live"])
    finally:
        await front.stop()
        await gw.close()
        await close_engines()
    return out


def test_the_slice_matches_the_jax_gateway_over_two_engines(ckpt):
    """Tokens exact, JSON bodies equal after dropping ``meta`` (puid,
    timing); the shared-prefix requests all land on the warm replica in
    both packages and reuse its prefix there."""
    want = run(_slice(False, ckpt))
    got = run(_slice(True, ckpt))
    assert got["wave"] == want["wave"] and got["wave_bodies"] == want["wave_bodies"]
    assert got["shared"] == want["shared"]
    for out in (want, got):
        assert len(out["warm"]) == 1
        warm = out["warm"][0]
        assert out["shared_picks"][warm] == len(SUFFIXES)
        assert out["shared_picks"][1 - warm] == 0
        assert out["prefix_picks"] == len(SUFFIXES)
        assert out["warm_hits"][warm] >= len(SUFFIXES)
    assert got["disagg"] == (200, want["wave"][0])
    total, own, live = got["fleet"]
    assert total == own and live == 2 and total >= len(WAVE) + 1 + len(SUFFIXES)


def test_prefix_snapshot_never_waits_on_a_warmup():
    """Repair: ``/stats/cache`` and ``/stats/summary`` run the model's
    ``prefix_snapshot`` on the engine's event loop; with the model lock
    held (a warmup holds it for seconds) it answers at once instead of
    stalling the loop until the lock is free."""
    import threading

    from seldon_core_tpu_torch.models import registry

    comp = registry.build_generative_component(preset="tiny", kv_prefix_reuse=True,
                                               n_slots=2, device="cpu")
    model = comp.model
    held, release = threading.Event(), threading.Event()

    def warmup_like():
        with model._lock:
            held.set()
            release.wait(10)

    t = threading.Thread(target=warmup_like)
    t.start()
    held.wait(5)
    try:
        t0 = time.perf_counter()
        snap = model.prefix_snapshot()
        dt = time.perf_counter() - t0
    finally:
        release.set()
        t.join()
    assert dt < 1.0 and snap["digest"]["block_size"] == model.kv_block_size
    assert model.prefix_snapshot() == snap  # and the same state once the lock is free
