"""Fleet collector: cluster-wide aggregation of per-replica stats, the
port's copy of the JAX package's ``obs/fleet.py`` over the port's pooled
stdlib client (``wire/h1client.py``) in place of aiohttp.

Every surface below this layer is per-process — an engine answers
``/stats/*`` only about itself.  The FleetCollector (one instance in the
gateway; the operator's sidecar and the standalone mode come with the
operator slice and raise by name here) turns those into the
per-deployment decision plane:

* **discovery** — the same :class:`DeploymentStore` the gateway watcher
  maintains; every ``DeploymentRecord.replica_endpoints`` entry is a
  scrape target.  No second service-discovery path.
* **collection** — a jittered poll loop (``SCT_FLEET_POLL_S`` ±
  ``SCT_FLEET_JITTER``) GETs the engine's ``/stats/summary`` (one round
  trip bundling qos/breakdown/cache/wire + mergeable stage histograms),
  falling back to the four individual endpoints for replicas that
  predate it.  Scrapes ride one keep-alive pool per replica with a
  hard timeout; a replica's consecutive failures damp its scrape rate
  (``SCT_FLEET_FAIL_DAMP``: skip a growing number of polls, capped) so
  a dead replica set cannot turn the collector into a retry storm.
* **aggregation** — counters are SUMMED, pool capacities summed with
  per-replica min/max, EWMAs reported min/mean/max, and latency
  percentiles computed from MERGED histogram bucket counts
  (``obs/history.BUCKET_EDGES``) — never by averaging per-replica
  percentiles.  Replicas whose last successful scrape is older than
  ``SCT_FLEET_STALE_POLLS`` intervals are EXCLUDED from aggregates
  (listed as stale, not zeroed in).
* **downstream** — every poll feeds the bounded step-down history rings
  (:class:`obs.history.History`) and the SLO burn-rate engine
  (:class:`obs.slo.SloEngine`), and exports ``seldon_fleet_*`` gauges.
  Served by ``GET /stats/fleet`` and ``GET /stats/slo``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time

from seldon_core_tpu_torch.obs import history as _history
from seldon_core_tpu_torch.obs import slo as _slo
from seldon_core_tpu_torch.runtime import settings

log = logging.getLogger(__name__)

# qos snapshot fields summed across replicas
_QOS_COUNTERS = ("admitted_total", "shed_total", "deadline_miss_total")
# qos gauges reported as {min, mean, max} across live replicas
_QOS_GAUGES = ("queue_wait_ewma_ms", "inflight", "predicted_completion_ms")
# pool capacities: summed, with per-replica min/max retained
_QOS_POOLS = ("max_inflight", "max_queue")


def _merge_numeric(into: dict, src: dict) -> None:
    """Recursively sum numeric leaves of ``src`` into ``into`` (used for
    the cache/wire payloads, whose fields are all counters or rates —
    summing rates across replicas is the fleet rate)."""
    for k, v in src.items():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            into[k] = into.get(k, 0) + v
        elif isinstance(v, dict):
            into[k] = into.get(k) if isinstance(into.get(k), dict) else {}
            _merge_numeric(into[k], v)


class FleetCollector:
    """Pull-based per-deployment aggregator over a DeploymentStore."""

    def __init__(
        self,
        store,
        *,
        interval_s: float | None = None,
        timeout_s: float | None = None,
        jitter: float | None = None,
        stale_polls: int | None = None,
        fail_damp: int | None = None,
        history: _history.History | None = None,
        slo_engine: _slo.SloEngine | None = None,
        metrics=None,
        service: str = "fleet",
    ):
        self.store = store
        self.interval_s = (
            settings.get_float("SCT_FLEET_POLL_S")
            if interval_s is None else float(interval_s)
        )
        self.timeout_s = (
            settings.get_float("SCT_FLEET_TIMEOUT_S")
            if timeout_s is None else float(timeout_s)
        )
        self.jitter = (
            settings.get_float("SCT_FLEET_JITTER")
            if jitter is None else float(jitter)
        )
        self.stale_polls = (
            settings.get_int("SCT_FLEET_STALE_POLLS")
            if stale_polls is None else int(stale_polls)
        )
        self.fail_damp = (
            settings.get_int("SCT_FLEET_FAIL_DAMP")
            if fail_damp is None else int(fail_damp)
        )
        self.history = history if history is not None else _history.History()
        self.slo = slo_engine if slo_engine is not None else _slo.SloEngine()
        self._metrics = metrics
        self.service = service
        # (deployment, replica_key) -> scrape state
        self._replicas: dict[tuple[str, str], dict] = {}
        # (deployment, stage) -> previous poll's merged buckets, for the
        # interval-windowed percentiles (win_p99_ms) the autoscaler needs:
        # lifetime percentiles only ratchet, so an ebb would be invisible
        self._prev_stage_hist: dict[tuple[str, str], list[int]] = {}
        self._agg: dict = {}
        self.polls = 0
        self.scrapes_ok = 0
        self.scrapes_failed = 0
        self.scrapes_damped = 0
        self.errors = 0  # unexpected exceptions in the loop (must stay 0)
        self._pools: dict[tuple[str, int], object] = {}
        self._task: asyncio.Task | None = None

    # -- plumbing ------------------------------------------------------------

    def _pool(self, host: str, port: int):
        from seldon_core_tpu_torch.wire.h1client import H1Pool

        key = (host, int(port))
        pool = self._pools.get(key)
        if pool is None:
            pool = self._pools[key] = H1Pool(host, int(port), limit=4)
        return pool

    async def _get(self, host: str, port: int, path: str):
        """(status, JSON body or None) of one GET within the scrape timeout."""
        resp = await self._pool(host, port).get(path, timeout=self.timeout_s)
        if resp.status != 200:
            return resp.status, None
        return 200, json.loads(resp.body)

    def _met(self):
        if self._metrics is None:
            from seldon_core_tpu_torch.utils.metrics import DEFAULT
            self._metrics = DEFAULT
        return self._metrics

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            await pool.close()

    async def _run(self) -> None:
        while True:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # the collector must NEVER take its host process down —
                # count it (the resilience e2e asserts this stays 0 for
                # mere replica death) and keep polling
                self.errors += 1
                log.exception("fleet poll failed")
            await asyncio.sleep(self._sleep_s())

    def _sleep_s(self) -> float:
        if self.jitter <= 0:
            return self.interval_s
        return self.interval_s * (
            1.0 + self.jitter * (2.0 * random.random() - 1.0)
        )

    # -- scraping ------------------------------------------------------------

    async def _scrape(self, host: str, port: int) -> dict:
        """One replica: ``/stats/summary`` in one round trip, or the
        four-endpoint fallback for engines that predate it."""
        status, body = await self._get(host, port, "/stats/summary")
        if status == 200:
            return body
        if status != 404:
            raise RuntimeError(f"/stats/summary -> {status}")
        out: dict = {}
        for route, key in (("/stats/qos", "qos"),
                           ("/stats/breakdown", "breakdown"),
                           ("/stats/cache", "cache"),
                           ("/stats/wire", "wire")):
            status, body = await self._get(host, port, route)
            if status == 200:
                out[key] = body.get(key, body) if key != "wire" else body
        return out

    async def poll_once(self, now: float | None = None) -> dict:
        if now is None:
            now = time.time()
        self.polls += 1
        records = self.store.list()
        live_keys: set[tuple[str, str]] = set()
        tasks: dict[tuple[str, str], asyncio.Task] = {}
        loop = asyncio.get_running_loop()
        for rec in records:
            for ep in rec.replica_endpoints:
                k = (rec.name, ep.key)
                live_keys.add(k)
                st = self._replicas.setdefault(k, {
                    "payload": None, "last_ok": 0.0,
                    "fail_streak": 0, "skip": 0,
                })
                if st["skip"] > 0:
                    # damped: a dead replica is probed at a decaying
                    # rate, not hammered every poll (scrape-storm guard)
                    st["skip"] -= 1
                    self.scrapes_damped += 1
                    continue
                tasks[k] = loop.create_task(self._scrape(ep.host, ep.rest_port))
        if tasks:
            done = await asyncio.gather(
                *tasks.values(), return_exceptions=True
            )
            for k, result in zip(tasks.keys(), done):
                st = self._replicas[k]
                if isinstance(result, BaseException):
                    self.scrapes_failed += 1
                    st["fail_streak"] += 1
                    over = st["fail_streak"] - self.fail_damp
                    if over >= 0:
                        st["skip"] = min(over + 1, 8)
                else:
                    self.scrapes_ok += 1
                    st.update(payload=result, last_ok=now,
                              fail_streak=0, skip=0)
        # forget replicas that left the store entirely, and close their pools
        for k in [k for k in self._replicas if k not in live_keys]:
            del self._replicas[k]
        live_pools = {(ep.host, int(ep.rest_port)) for rec in records
                      for ep in rec.replica_endpoints}
        for key in [k for k in self._pools if k not in live_pools]:
            await self._pools.pop(key).close()
        live_names = {rec.name for rec in records}
        for k in [k for k in self._prev_stage_hist if k[0] not in live_names]:
            del self._prev_stage_hist[k]
        self._aggregate(records, now)
        self._feed_slo(records, now)
        return self._agg

    # -- aggregation ---------------------------------------------------------

    def _stale_after_s(self) -> float:
        return self.stale_polls * self.interval_s

    def _live_payloads(self, rec, now: float):
        """(replica_meta, live_payloads): stale replicas appear in the
        meta list but contribute nothing to the aggregates."""
        metas, live = [], []
        stale_after = self._stale_after_s()
        for ep in rec.replica_endpoints:
            st = self._replicas.get((rec.name, ep.key))
            if st is None:
                continue
            age = None if not st["last_ok"] else now - st["last_ok"]
            stale = age is None or age > stale_after
            metas.append({
                "replica": ep.key,
                "age_s": None if age is None else round(age, 3),
                "stale": stale,
                "fail_streak": st["fail_streak"],
            })
            if not stale and st["payload"] is not None:
                live.append(st["payload"])
        return metas, live

    @staticmethod
    def _agg_qos(snaps: list[dict]) -> dict:
        out: dict = {}
        for c in _QOS_COUNTERS:
            out[c] = sum(int(s.get(c, 0)) for s in snaps)
        shed: dict = {}
        for s in snaps:
            for reason, n in (s.get("shed_by_reason") or {}).items():
                shed[reason] = shed.get(reason, 0) + int(n)
        out["shed_by_reason"] = shed
        for g in _QOS_GAUGES:
            vals = [float(s[g]) for s in snaps
                    if isinstance(s.get(g), (int, float))]
            if vals:
                out[g] = {
                    "min": min(vals),
                    "mean": round(sum(vals) / len(vals), 4),
                    "max": max(vals),
                }
        for p in _QOS_POOLS:
            vals = [int(s[p]) for s in snaps
                    if isinstance(s.get(p), (int, float))]
            if vals:
                out[p] = {"sum": sum(vals), "min": min(vals),
                          "max": max(vals)}
        out["brownout_active"] = sum(
            1 for s in snaps if (s.get("brownout") or {}).get("active")
        )
        return out

    @staticmethod
    def _agg_stage_hist(payloads: list[dict]) -> dict:
        merged: dict[str, list[int]] = {}
        for p in payloads:
            for stage, counts in (p.get("stage_hist") or {}).items():
                if stage not in merged:
                    merged[stage] = _history.new_hist()
                _history.merge_hist(merged[stage], counts)
        return merged

    def _aggregate(self, records, now: float) -> None:
        deployments: dict = {}
        for rec in records:
            metas, live = self._live_payloads(rec, now)
            qos_snaps = [p["qos"] for p in live
                         if isinstance(p.get("qos"), dict)]
            merged_hist = self._agg_stage_hist(live)
            latency = {}
            for stage, counts in merged_hist.items():
                if not sum(counts):
                    continue
                entry = {
                    "count": sum(counts),
                    "p50_ms": _history.hist_percentile_ms(counts, 50.0),
                    "p99_ms": _history.hist_percentile_ms(counts, 99.0),
                }
                # interval window: bucket deltas since the previous poll
                # (clamped at 0 — replica churn can rewind the sum)
                prev = self._prev_stage_hist.get((rec.name, stage))
                if prev is not None:
                    delta = [max(0, a - b) for a, b in zip(counts, prev)]
                    win = sum(delta)
                    entry["win_count"] = win
                    entry["win_p99_ms"] = (
                        _history.hist_percentile_ms(delta, 99.0)
                        if win else None
                    )
                self._prev_stage_hist[(rec.name, stage)] = list(counts)
                latency[stage] = entry
            cache: dict = {}
            wire: dict = {}
            # usage-meter rows are cumulative counters keyed by
            # (deployment|adapter|qos), so the recursive numeric sum IS
            # the counter-exact fleet merge: per-key sums over live
            # replicas equal the union, and dead replicas drop out of
            # ``live`` entirely (excluded, not zeroed)
            usage: dict = {}
            for p in live:
                if isinstance(p.get("cache"), dict):
                    _merge_numeric(cache, p["cache"])
                if isinstance(p.get("wire"), dict):
                    _merge_numeric(wire, p["wire"])
                if isinstance(p.get("usage"), dict):
                    _merge_numeric(usage, p["usage"])
            dep = {
                "replicas": metas,
                "replicas_live": len(live),
                "replicas_stale": sum(1 for m in metas if m["stale"]),
                "qos": self._agg_qos(qos_snaps),
                "latency": latency,
                "cache": cache,
                "wire": wire,
                "usage": usage,
                "stage_hist": merged_hist,
            }
            deployments[rec.name] = dep
            self._record_history(rec.name, dep, now)
            self._export_metrics(rec.name, dep)
        self._agg = {
            "ts": round(now, 3),
            "poll_interval_s": self.interval_s,
            "stale_after_s": self._stale_after_s(),
            "collector": {
                "polls": self.polls,
                "scrapes_ok": self.scrapes_ok,
                "scrapes_failed": self.scrapes_failed,
                "scrapes_damped": self.scrapes_damped,
                "errors": self.errors,
            },
            "deployments": deployments,
        }

    def _record_history(self, name: str, dep: dict, now: float) -> None:
        h = self.history
        qos = dep["qos"]
        for c in _QOS_COUNTERS:
            h.record(f"{name}.{c}", qos.get(c, 0), now=now)
        qw = qos.get("queue_wait_ewma_ms")
        if isinstance(qw, dict):
            h.record(f"{name}.queue_wait_ms", qw["mean"], now=now)
        total = qos.get("admitted_total", 0) + qos.get("shed_total", 0)
        if total:
            h.record(f"{name}.shed_rate",
                     qos.get("shed_total", 0) / total, now=now)
        for stage, q in dep["latency"].items():
            if q["p99_ms"] is not None:
                h.record(f"{name}.{stage}.p99_ms", q["p99_ms"], now=now)
            if q.get("win_p99_ms") is not None:
                h.record(f"{name}.{stage}.win_p99_ms",
                         q["win_p99_ms"], now=now)
        u_total = (dep.get("usage") or {}).get("total")
        if isinstance(u_total, dict):
            h.record(f"{name}.usage_device_s",
                     u_total.get("device_s", 0), now=now)
            h.record(f"{name}.usage_tokens_decode",
                     u_total.get("tokens_decode", 0), now=now)
        h.record(f"{name}.replicas_live", dep["replicas_live"], now=now)

    def _export_metrics(self, name: str, dep: dict) -> None:
        try:
            m = self._met()
            m.fleet_replicas.labels(name, "live").set(dep["replicas_live"])
            m.fleet_replicas.labels(name, "stale").set(
                dep["replicas_stale"])
            qos = dep["qos"]
            for c in _QOS_COUNTERS:
                m.fleet_counter.labels(name, c).set(qos.get(c, 0))
            ttft = (dep["latency"].get("ttft") or {}).get("p99_ms")
            if ttft is not None:
                m.fleet_p99_ms.labels(name, "ttft").set(ttft)
        except Exception:  # metrics are best-effort, never break the poll
            pass

    # -- SLO feed ------------------------------------------------------------

    def _feed_slo(self, records, now: float) -> None:
        if not settings.get_bool("SCT_SLO"):
            return
        default_spec = settings.get_str("SCT_SLO_DEFAULT")
        self.slo.retain([r.name for r in records])
        for rec in records:
            spec = (rec.annotations or {}).get(
                _slo.SLO_ANNOTATION) or default_spec
            self.slo.declare(rec.name, spec, now=now)
            dep = self._agg.get("deployments", {}).get(rec.name)
            if dep is None or not dep["replicas_live"]:
                continue
            qos = dep["qos"]
            counters: dict = {}
            admitted = qos.get("admitted_total", 0)
            shed = qos.get("shed_total", 0)
            counters["deadline_hit"] = (
                admitted, qos.get("deadline_miss_total", 0))
            counters["shed_rate"] = (admitted + shed, shed)
            for obj in self.slo.objectives(rec.name):
                if obj.kind != "latency":
                    continue
                hist = dep["stage_hist"].get(obj.stage)
                if hist is None:
                    continue
                counters[obj.name] = (
                    sum(hist), _slo.count_over_bound(hist, obj.bound_ms))
            self.slo.observe(rec.name, counters, now=now)
        self.slo.evaluate(now=now)

    # -- timeline fan-out ----------------------------------------------------

    async def _get_json(self, host: str, port: int, path: str) -> dict:
        status, body = await self._get(host, port, path)
        if status != 200:
            raise RuntimeError(f"{host}:{port}{path} -> {status}")
        return body

    async def fan_timeline(self, trace: str) -> dict:
        """``GET /stats/timeline?trace=<id>`` fan-out: query every
        replica endpoint of every deployment (the collector's own scrape
        enumeration) and return the stitched legs, so a split
        prefill/decode trace is one query instead of N."""
        loop = asyncio.get_running_loop()
        meta: list[tuple[str, str]] = []
        tasks: list[asyncio.Task] = []
        for rec in self.store.list():
            for ep in rec.replica_endpoints:
                meta.append((rec.name, ep.key))
                tasks.append(loop.create_task(self._get_json(
                    ep.host, ep.rest_port, f"/stats/timeline?trace={trace}"
                )))
        legs: list[dict] = []
        failed = 0
        results = await asyncio.gather(*tasks, return_exceptions=True)
        for (dep, key), res in zip(meta, results):
            if isinstance(res, BaseException) or not isinstance(res, dict):
                failed += 1
                continue
            for entry in res.get("timeline") or []:
                leg = {"deployment": dep, "replica": key}
                if isinstance(entry, dict):
                    leg.update(entry)
                else:
                    leg["entry"] = entry
                legs.append(leg)
        return {
            "trace": trace,
            "queried": len(meta),
            "failed": failed,
            "legs": len(legs),
            "timeline": legs,
        }

    # -- serving -------------------------------------------------------------

    def fleet_snapshot(self, history_points: int = 30) -> dict:
        out = dict(self._agg) if self._agg else {
            "ts": None, "deployments": {},
            "collector": {"polls": 0, "scrapes_ok": 0, "scrapes_failed": 0,
                          "scrapes_damped": 0, "errors": 0},
        }
        # raw merged bucket vectors are for the collector's own math, not
        # the API payload (242 ints per stage per deployment)
        deps = {}
        for name, dep in out.get("deployments", {}).items():
            deps[name] = {k: v for k, v in dep.items() if k != "stage_hist"}
        out["deployments"] = deps
        out["history"] = self.history.snapshot(points=history_points)
        return out

    def slo_snapshot(self) -> dict:
        return self.slo.snapshot()


# ---------------------------------------------------------------------------
# the operator's sidecar and the standalone mode: the operator slice
# ---------------------------------------------------------------------------

_SIDECAR_LATER = ("the fleet collector's stats app (the operator's sidecar and "
                  "`python -m ...obs.fleet`) is not in the port yet: it comes with the "
                  "operator slice (ROADMAP A16); the gateway serves /stats/fleet and "
                  "/stats/slo")


def build_stats_app(collector: FleetCollector, autoscaler=None):
    """The operator's sidecar surface: refused by name (the operator slice)."""
    raise NotImplementedError(_SIDECAR_LATER)


async def run_standalone(port: int | None = None) -> None:
    """The standalone collector: refused by name (the operator slice)."""
    raise NotImplementedError(_SIDECAR_LATER)


def main() -> None:
    raise NotImplementedError(_SIDECAR_LATER)


if __name__ == "__main__":
    main()
