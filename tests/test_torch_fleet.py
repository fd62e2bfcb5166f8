"""The port's fleet plane (``seldon_core_tpu_torch/obs/{history,slo,fleet}.py``)
against the JAX package's.

The shared histogram grid and its merge, percentile and over-bound count;
the step-down rings fed the same samples (series, slope, delta, the
snapshot); the SLO grammar (the same objectives, the same refusals) and
the burn-rate engine walked through the same counters (every ``evaluate``
payload equal, transitions included); and the fleet collector over the
same stub replicas (``/stats/summary`` and ``/stats/timeline`` on real
sockets, one then dead): every poll's aggregate, the served snapshot, the
SLO state fed from an annotation and the timeline fan-out equal, the JAX
collector scraping over aiohttp and the port's over its pooled stdlib
client.

Tolerance: exact (every payload JSON-equal)."""

import asyncio
import json
import random

import pytest
from aiohttp import web

from seldon_core_tpu.gateway.store import DeploymentRecord as JaxRecord
from seldon_core_tpu.gateway.store import DeploymentStore as JaxStore
from seldon_core_tpu.gateway.store import Endpoint as JaxEndpoint
from seldon_core_tpu.obs import fleet as jfleet
from seldon_core_tpu.obs import history as jhistory
from seldon_core_tpu.obs import slo as jslo
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore, Endpoint
from seldon_core_tpu_torch.obs import fleet as tfleet
from seldon_core_tpu_torch.obs import history as thistory
from seldon_core_tpu_torch.obs import slo as tslo

run = asyncio.run


def _samples(seed: int, n: int = 500) -> list[float]:
    rng = random.Random(seed)
    return [rng.lognormvariate(-5, 1.5) for _ in range(n)]


def test_histogram_grid_and_math_match():
    assert thistory.BUCKET_EDGES == jhistory.BUCKET_EDGES
    a, b = _samples(1), _samples(2, 80)
    for mod in (thistory, jhistory):
        assert mod.bin_samples(a) == jhistory.bin_samples(a)
    merged_t = thistory.merge_hist(thistory.bin_samples(a), thistory.bin_samples(b))
    merged_j = jhistory.merge_hist(jhistory.bin_samples(a), jhistory.bin_samples(b))
    assert merged_t == merged_j
    for q in (50.0, 90.0, 99.0, 99.9):
        assert thistory.hist_percentile_ms(merged_t, q) == jhistory.hist_percentile_ms(merged_j, q)
    assert thistory.hist_percentile_ms(thistory.new_hist(), 50.0) is None
    for bound in (0.5, 7.0, 250.0):
        assert tslo.count_over_bound(merged_t, bound) == jslo.count_over_bound(merged_j, bound)
    assert thistory.merge_hist([0] * 5, [1] * 9) == jhistory.merge_hist([0] * 5, [1] * 9)


def test_history_rings_match():
    feeds = [(f"m{i % 3}", v, 1000.0 + 7.3 * i) for i, v in enumerate(_samples(3, 200))]
    out = []
    for mod in (jhistory, thistory):
        h = mod.History(slots=12, max_metrics=2)  # the third metric is dropped
        for name, v, t in feeds:
            h.record(name, v, now=t)
        now = feeds[-1][2]
        out.append((h.snapshot(points=8, now=now), h.series("m0", "slow", now=now),
                    h.slope("m1", window_s=120.0, now=now),
                    h.delta("m0", window_s=120.0, now=now), h.metrics(), h.last("m1")))
    assert out[1] == out[0]
    assert out[0][0]["dropped_metrics"] > 0


SPECS = ["ttft_p99_ms=250,deadline_hit=0.99,shed_rate=0.01", "queue_wait_p50_ms=5",
         " ttft_p99.9_ms = 100 ,, ", ""]
BAD_SPECS = ["ttft_p99_ms", "ttft_p99_ms=abc", "ttft_p100_ms=5", "ttft_p99_ms=0",
             "deadline_hit=1.5", "shed_rate=0", "bogus=1", "shed_rate=0.1,shed_rate=0.2"]


@pytest.mark.parametrize("spec", SPECS)
def test_slo_grammar_matches(spec):
    assert [o.__dict__ for o in tslo.parse_slo(spec)] == \
        [o.__dict__ for o in jslo.parse_slo(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_slo_grammar_refuses_alike(spec):
    with pytest.raises(jslo.SloError) as want:
        jslo.parse_slo(spec)
    with pytest.raises(tslo.SloError) as got:
        tslo.parse_slo(spec)
    assert str(got.value) == str(want.value)


def test_slo_engine_walks_alike():
    """Clean traffic, a hard overload (page), recovery on the fast window,
    a counter dip, a spec change and a bad spec: every evaluate equal."""
    def session(mod):
        eng = mod.SloEngine(fast_window_s=60.0, slow_window_s=600.0, page_burn=14.0,
                            warn_burn=6.0)
        eng.declare("dep", "deadline_hit=0.99,shed_rate=0.01", now=0.0)
        eng.declare("bad", "nope=1", now=0.0)
        total = bad = 0
        out = []
        for t in range(0, 1200, 30):
            total += 100
            bad += 40 if 300 <= t < 600 else (0 if t != 900 else -5)
            eng.observe("dep", {"deadline_hit": (total, max(bad, 0)),
                                "shed_rate": (total, max(bad, 0) // 2)}, now=float(t))
            out.append(eng.evaluate(now=float(t)))
        eng.declare("dep", "shed_rate=0.05", now=1200.0)
        eng.retain(["dep"])
        out.append(eng.snapshot(now=1201.0))
        return out

    want, got = session(jslo), session(tslo)
    assert got == want
    states = {o["deployments"]["dep"]["state"] for o in want[:-1]}
    assert "page" in states and "ok" in states


class StubReplica:
    """An engine's stats surface: mutable qos counters, a stage histogram,
    a timeline, on a real socket."""

    def __init__(self, admitted=0, shed=0, miss=0):
        self.qos = {
            "admitted_total": admitted, "shed_total": shed, "deadline_miss_total": miss,
            "queue_wait_ewma_ms": 1.0 + admitted / 100, "inflight": 2,
            "predicted_completion_ms": 5.0, "max_inflight": 64, "max_queue": 128,
            "shed_by_reason": {"queue_full": shed}, "brownout": {"active": shed > 20},
        }
        self.stage_hist = {}
        self.timeline = []
        self.runner = None
        self.port = None

    async def start(self):
        app = web.Application()
        app.router.add_get("/stats/summary", self._summary)
        app.router.add_get("/stats/timeline", self._timeline)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", self.port or 0)
        await site.start()
        self.port = self.runner.addresses[0][1]
        return self

    async def stop(self):
        if self.runner is not None:
            await self.runner.cleanup()
            self.runner = None

    async def _summary(self, request):
        return web.json_response({
            "qos": self.qos, "breakdown": {}, "cache": {"hits": 1, "misses": 2},
            "wire": {"wire": {"engine-rest": {"rx_bytes": 10}}},
            "usage": {"total": {"device_s": 0.5, "tokens_decode": 7}},
            "stage_hist": self.stage_hist,
        })

    async def _timeline(self, request):
        trace = request.query.get("trace", "")
        return web.json_response({"timeline": [e for e in self.timeline
                                               if e.get("trace") == trace]})


def _stores(replicas, annotations):
    out = []
    for store_cls, rec_cls, ep_cls in ((JaxStore, JaxRecord, JaxEndpoint),
                                       (DeploymentStore, DeploymentRecord, Endpoint)):
        store = store_cls()
        store.put(rec_cls(name="dep", oauth_key="dep-k", oauth_secret="s",
                          endpoints=tuple(ep_cls("127.0.0.1", r.port, r.port) for r in replicas),
                          annotations=dict(annotations)))
        out.append(store)
    return out


def test_collectors_aggregate_alike():
    """Both collectors over the same two stubs, polled at the same
    instants: equal aggregates, snapshots, SLO payloads and fan-outs, then
    with replica b dead: stale after ``stale_polls`` intervals and damped."""
    async def go():
        a = await StubReplica(admitted=100, shed=10).start()
        b = await StubReplica(admitted=200, shed=30).start()
        a.stage_hist = {"ttft": jhistory.bin_samples([0.001] * 900)}
        b.stage_hist = {"ttft": jhistory.bin_samples([0.1] * 100),
                        "queue-wait": jhistory.bin_samples(_samples(4, 50))}
        a.timeline = [{"trace": "t1", "stage": "prefill", "ms": 5}]
        b.timeline = [{"trace": "t1", "stage": "decode", "ms": 9}]
        jstore, tstore = _stores((a, b), {"seldon.io/slo": "ttft_p99_ms=50,shed_rate=0.1"})
        cols = [jfleet.FleetCollector(jstore, interval_s=1.0, jitter=0.0, stale_polls=2,
                                      fail_damp=1, timeout_s=1.0),
                tfleet.FleetCollector(tstore, interval_s=1.0, jitter=0.0, stale_polls=2,
                                      fail_damp=1, timeout_s=1.0)]
        steps = [[], []]
        try:
            for t in range(5):
                if t == 2:
                    await b.stop()
                for col, out in zip(cols, steps):
                    agg = await col.poll_once(now=1000.0 + t)
                    out.append(json.loads(json.dumps(agg)))
                a.qos["admitted_total"] += 50
            for col, out in zip(cols, steps):
                out.append(json.loads(json.dumps(col.fleet_snapshot())))
                out.append(col.slo_snapshot()["deployments"])
                out.append(await col.fan_timeline("t1"))
        finally:
            for col in cols:
                await col.stop()
            await a.stop()
            await b.stop()
        return steps

    want, got = run(go())
    assert got == want
    first = want[0]["deployments"]["dep"]
    assert first["replicas_live"] == 2 and first["qos"]["admitted_total"] == 300
    assert first["latency"]["ttft"]["count"] == 1000
    last = want[4]
    assert last["deployments"]["dep"]["replicas_live"] == 1
    assert last["deployments"]["dep"]["replicas_stale"] == 1
    assert last["collector"]["scrapes_damped"] >= 1
    assert want[6]["dep"]["objectives"].keys() == {"ttft_p99_ms", "shed_rate"}
    assert want[7]["legs"] == 1 and want[7]["failed"] == 1
