"""The port's replica router (``seldon_core_tpu_torch/disagg/router.py``)
against the JAX package's ``disagg/router.py``.

``extract_prompt_request`` and ``prompt_chain_hashes`` give equal results
over a corpus of bodies; two ``ReplicaRouter``s seeded with the same
``random.Random(seed)`` under one fake clock, fed the same
``update_replica``/``note_*`` calls, return the same pick and peer-hint
sequence and the same snapshots, through prefix matches, p2c, the breaker's
ejection, its half-open probe and re-admission, and the peer-pull yield;
``RouterPoller`` against stub engines (their ``/stats/cache`` digests and
``/stats/qos`` waits) fills the same router state in both packages,
including a dead replica's digest cleared after ``SCT_GW_POLL_FAILS``
misses; and the port's ``RetryBudget`` and budgeted ``retry_loop`` spend
and deny as the JAX ones do.

Tolerance: exact (hashes, picks, hints, snapshots)."""

import asyncio
import json
import random
import types

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from seldon_core_tpu.disagg import router as jrouter
from seldon_core_tpu.engine import transport as jtransport
from seldon_core_tpu.gateway.store import DeploymentRecord as JaxRecord
from seldon_core_tpu.gateway.store import DeploymentStore as JaxStore
from seldon_core_tpu.gateway.store import Endpoint as JaxEndpoint
from seldon_core_tpu_torch.disagg import router as trouter
from seldon_core_tpu_torch.engine import transport as ttransport
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore, Endpoint

run = asyncio.run
SYS = list(range(1000, 1048))  # a 48-token shared prompt: 3 blocks of 16

BODIES = [
    b"not json", b"[1, 2]", b'{"data": {"ndarray": [[1]]}}', b'{"tokens": [1, true]}',
    b'{"tokens": []}', b'{"tokens": [1, 2, 3]}', b'{"tokens": [1, 2.0]}',
    json.dumps({"strData": json.dumps({"tokens": [4, 5], "max_new_tokens": 2})}).encode(),
    json.dumps({"strData": json.dumps({"tokens": SYS + [7], "adapter": "alpha"})}).encode(),
    json.dumps({"tokens": SYS, "adapter": ""}).encode(),
    json.dumps({"adapter": "beta"}).encode(), b'{"strData": "[1]"}', b'{"strData": 5}',
]


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_extract_prompt_request_matches(i):
    got, want = trouter.extract_prompt_request(BODIES[i]), jrouter.extract_prompt_request(BODIES[i])
    assert got[1] == want[1]
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        assert got[0].dtype == want[0].dtype and got[0].tolist() == want[0].tolist()


@pytest.mark.parametrize("n,bs,adapter,max_blocks", [
    (48, 16, None, 64), (49, 16, "alpha", 64), (15, 16, None, 64), (160, 16, None, 4),
    (64, 8, "beta", 64), (10, 0, None, 64)])
def test_prompt_chain_hashes_match(n, bs, adapter, max_blocks):
    toks = np.random.default_rng(n).integers(0, 32000, n).astype(np.int32)
    assert trouter.prompt_chain_hashes(toks, bs, max_blocks, adapter) == \
        jrouter.prompt_chain_hashes(toks, bs, max_blocks, adapter)


def _script(mod, ep_cls, clock):
    """One scripted routing session -> [(pick key, hint)] and snapshots."""
    r = mod.ReplicaRouter(rng=random.Random(7))
    eps = tuple(ep_cls(h, 8000) for h in ("a", "b", "c"))
    sys = np.asarray(SYS, np.int32)
    out = []

    def pick(prompt=None, adapter=None, eps=eps):
        ep, hint = r.pick_with_peer("dep", eps, prompt, adapter)
        out.append((ep.key, hint))
        return ep

    r.update_replica("dep", "a:8000", hashes=mod.prompt_chain_hashes(sys, 16), block_size=16,
                     queue_wait_ms=3.0)
    r.update_replica("dep", "b:8000", hashes=mod.prompt_chain_hashes(sys[:16], 16),
                     block_size=16, queue_wait_ms=1.0)
    r.update_replica("dep", "c:8000", hashes=(), block_size=16, queue_wait_ms=9.0)
    for i in range(6):  # prefix matches, then other prompts by p2c
        pick(np.concatenate([sys, np.asarray([i, i + 1], np.int32)]))
        pick(np.asarray([5, 6, 7, i], np.int32))
        pick()
    pick(sys, adapter="alpha")  # salted chains match nothing: p2c
    for _ in range(3):  # a's breaker opens
        r.note_start("dep", "a:8000")
        r.note_failure("dep", "a:8000")
        r.note_done("dep", "a:8000")
    for _ in range(4):  # ejected: the prefix pick goes elsewhere
        pick(sys)
    clock[0] += r.cb_eject_s + 0.1
    probe = pick(sys)  # the half-open probe
    r.note_failure("dep", probe.key)  # a failed probe re-opens
    clock[0] += r.cb_eject_s + 0.1
    probe = pick(sys)
    r.note_success("dep", probe.key)  # re-admitted
    pick(sys)
    for key in ("b:8000", "c:8000"):  # every replica ejected: fail static
        for _ in range(3):
            r.note_failure("dep", key)
    pick(sys)
    pick(eps=eps[:1])  # a single upstream bypasses
    r.forget_replica("dep", "c:8000")
    pick()
    snap = r.snapshot()
    return out, snap, r.has_digests("dep")


def _peer_script(mod, ep_cls):
    r = mod.ReplicaRouter(rng=random.Random(3))
    eps = (ep_cls("warm", 8000), ep_cls("cold", 8000))
    sys = np.asarray(SYS, np.int32)
    r.update_replica("dep", "warm:8000", hashes=mod.prompt_chain_hashes(sys, 16), block_size=16)
    out = []
    for i in range(8):
        ep, hint = r.pick_with_peer("dep", eps, sys)
        r.note_start("dep", ep.key)  # never done: warm grows hot
        out.append((ep.key, hint))
    return out, r.snapshot()


def test_seeded_routers_pick_alike(monkeypatch):
    """The same seeded script under one fake clock: equal picks, peer
    hints (none with peer pull off), breaker transitions and snapshots."""
    clocks = {"jax": [100.0], "port": [100.0]}
    for mod, name in ((jrouter, "jax"), (trouter, "port")):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda c=clocks[name]: c[0]))
    want = _script(jrouter, JaxEndpoint, clocks["jax"])
    got = _script(trouter, Endpoint, clocks["port"])
    assert got == want
    keys = [k for k, _ in want[0]]
    assert want[1]["prefix_picks"] >= 6 and want[1]["p2c_picks"] > 0
    assert want[1]["cb_opens"] >= 2 and want[1]["cb_closes"] >= 1 and want[1]["cb_probes"] == 2
    assert "a:8000" in keys[:6] and all(h is None for _, h in want[0])


def test_peer_pull_yields_alike(monkeypatch):
    """With ``SCT_PREFIX_PEER_PULL=1`` and ``SCT_GW_PEER_YIELD=2`` a hot
    prefix holder yields to the cold replica with a pull hint, alike."""
    monkeypatch.setenv("SCT_PREFIX_PEER_PULL", "1")
    monkeypatch.setenv("SCT_GW_PEER_YIELD", "2")
    want, got = _peer_script(jrouter, JaxEndpoint), _peer_script(trouter, Endpoint)
    assert got == want
    assert want[1]["peer_yield_picks"] > 0
    assert ("cold:8000", ("warm:8000", 3)) in want[0]


def _replica_app(hashes, queue_wait_ms, dram=()):
    async def stats_cache(request):
        return web.json_response({"cache": {"prefix": {"gen": {
            "digest": {"block_size": 16, "hashes": list(hashes),
                       "depths": list(range(1, len(hashes) + 1)),
                       "entries": len(hashes), "truncated": False},
            "tiers": {"dram": {"digest": {"block_size": 16, "hashes": list(dram)}}},
        }}}})

    async def stats_qos(request):
        return web.json_response({"qos": {"queue_wait_ewma_ms": queue_wait_ms}})

    app = web.Application()
    app.router.add_get("/stats/cache", stats_cache)
    app.router.add_get("/stats/qos", stats_qos)
    return app


def test_poller_fills_the_same_state():
    """Both pollers over the same stub replicas (a warm one with HBM and
    DRAM digests, a cold one, a dead one): equal router snapshots after
    one sweep and after the second miss clears the dead replica's digest."""
    sys = np.asarray(SYS, np.int32)
    hbm = jrouter.prompt_chain_hashes(sys[:32], 16)
    dram = jrouter.prompt_chain_hashes(sys, 16)[2:]

    async def go():
        warm = TestServer(_replica_app(hbm, 5.0, dram))
        cold = TestServer(_replica_app([], 42.0))
        await warm.start_server()
        await cold.start_server()
        eps = (f"127.0.0.1:{warm.port}", f"127.0.0.1:{cold.port}", "127.0.0.1:1")
        out = []
        try:
            for mod, store_cls, rec_cls in ((jrouter, JaxStore, JaxRecord),
                                            (trouter, DeploymentStore, DeploymentRecord)):
                store = store_cls()
                store.put(rec_cls(name="dep", oauth_key="dep", oauth_secret="s", endpoints=eps))
                store.put(rec_cls(name="solo", oauth_key="solo", oauth_secret="s",
                                  engine_host="127.0.0.1"))
                router = mod.ReplicaRouter(rng=random.Random(1))
                router.update_replica("dep", "127.0.0.1:1", hashes=hbm, block_size=16)
                poller = mod.RouterPoller(store, router, timeout_s=0.5, interval_s=999)
                try:
                    steps = []
                    for _ in range(2):
                        polled = await poller.poll_once()
                        snap = router.snapshot()["deployments"]["dep"]
                        pick = router.pick("dep", store.get("dep").replica_endpoints, sys).key
                        steps.append((polled, snap, pick, poller.digest_clears,
                                      poller.errors, poller.polls))
                    out.append(steps)
                finally:
                    await poller.stop()
        finally:
            await warm.close()
            await cold.close()
        return out

    want, got = run(go())
    for w, g in zip(want, got):  # the picked counts depend on picks made in step order
        assert g == w
    first, second = want
    assert first[0] == 3 and first[1]["127.0.0.1:1"]["digest_entries"] == len(hbm)
    assert second[1]["127.0.0.1:1"]["digest_entries"] == 0 and second[3] == 1
    assert first[1][f"127.0.0.1:{first[2].split(':')[1]}"]["digest_entries"] == 3


def test_retry_budget_and_budgeted_loop_match():
    """The same attempt script through both ``retry_loop``s with a budget:
    equal outcomes, attempts and budget snapshots."""
    async def session(mod):
        budget = mod.RetryBudget(2.0, 0.5)
        log = []

        async def no_sleep(i):
            log.append(("backoff", i))

        def attempt_factory(fail_until):
            async def attempt(i):
                log.append(("attempt", i))
                if i < fail_until:
                    raise mod._RetryableConnect(ConnectionError(f"down {i}"))
                return i
            return attempt

        results = []
        for fail_until in (0, 1, 2, 5, 5, 1):
            budget.earn()
            try:
                results.append(await mod.retry_loop(attempt_factory(fail_until), idempotent=True,
                                                    budget=budget, backoff=no_sleep))
            except ConnectionError as e:
                results.append(str(e))
        return results, log, budget.snapshot()

    want, got = run(session(jtransport)), run(session(ttransport))
    assert got == want
    assert want[2]["denied"] > 0 and want[2]["spent"] > 0
