"""Declarative SLOs evaluated as multi-window burn rates: the port's copy
of the JAX package's ``obs/slo.py``.

Objectives are declared on the CR (``seldon.io/slo`` annotation, parsed
and validated by ``operator/defaulting.py``, folded into the spec-hash
so an SLO edit rolls the deployment like any other spec change) in a
tiny ``key=value`` grammar:

``ttft_p99_ms=250,deadline_hit=0.99,shed_rate=0.01``

* ``<stage>_p<QQ>_ms=<bound>`` — latency objective: QQ% of requests
  must finish the named flight-recorder stage (``ttft``,
  ``queue_wait``, ``device_step``, ...; underscores map to the stage
  vocabulary's hyphens) under ``bound`` ms.  Evaluated from the
  MERGED per-replica histogram counts, never from averaged
  percentiles.  Error budget = 1 - QQ/100.
* ``deadline_hit=<ratio>`` — fraction of admitted requests that must
  complete inside their deadline.  Budget = 1 - ratio.
* ``shed_rate=<ratio>`` — admission sheds / offered requests must stay
  under ``ratio``.  Budget = ratio.

Evaluation follows the SRE-workbook multi-window multi-burn-rate
model: burn = (bad fraction over window) / budget, computed over a
fast window (``SCT_SLO_FAST_WINDOW_S``) and a slow window
(``SCT_SLO_SLOW_WINDOW_S``).  ``ok -> warn`` when BOTH windows burn
>= ``SCT_SLO_WARN_BURN``; ``-> page`` when both >= ``SCT_SLO_PAGE_BURN``
(the fast window reacts within seconds of a hard outage; the slow
window keeps a brief blip from paging).  Recovery is fast-window
driven: once recent traffic stops burning, the state steps down even
while the slow window is still digesting the incident.

State transitions are recorded as spans (``slo-transition``) and
exported counters (``seldon_slo_transitions_total``); live burns as
``seldon_slo_burn_rate`` gauges.  Served by ``GET /stats/slo``.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import deque

from seldon_core_tpu_torch.obs import history as _history
from seldon_core_tpu_torch.runtime import settings

SLO_ANNOTATION = "seldon.io/slo"

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
_STATE_RANK = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

# bounded per-objective sample ring: at the 10 s default poll this holds
# ~2.8 h of samples, comfortably past any sane slow window
_MAX_SAMPLES = 1024

_LATENCY_KEY_RE = re.compile(r"^([a-z][a-z0-9_]*)_p(\d{1,2}(?:\.\d+)?)_ms$")


class SloError(ValueError):
    """Invalid ``seldon.io/slo`` spec (bad key, bound, or ratio)."""


@dataclasses.dataclass(frozen=True)
class SloObjective:
    name: str                  # raw grammar key, e.g. "ttft_p99_ms"
    kind: str                  # "latency" | "good_ratio" | "bad_ratio"
    budget: float              # allowed bad-event fraction (error budget)
    target: float              # the declared value, verbatim
    stage: str | None = None   # flight-recorder stage (latency kind)
    quantile: float | None = None
    bound_ms: float | None = None

    def describe(self) -> dict:
        out = {
            "kind": self.kind,
            "target": self.target,
            "budget": round(self.budget, 6),
        }
        if self.kind == "latency":
            out.update(stage=self.stage, quantile=self.quantile,
                       bound_ms=self.bound_ms)
        return out


def parse_slo(spec: str) -> tuple[SloObjective, ...]:
    """Parse the annotation grammar; raises :class:`SloError` on any
    malformed entry (the operator rejects the CR, the collector records
    the error and serves no objectives)."""
    out: list[SloObjective] = []
    seen: set[str] = set()
    for raw in spec.split(","):
        item = raw.strip()
        if not item:
            continue
        if "=" not in item:
            raise SloError(f"SLO entry {item!r} is not key=value")
        key, _, val = item.partition("=")
        key = key.strip()
        val = val.strip()
        if key in seen:
            raise SloError(f"duplicate SLO key {key!r}")
        seen.add(key)
        try:
            value = float(val)
        except ValueError:
            raise SloError(f"SLO value {val!r} for {key!r} is not a number")
        m = _LATENCY_KEY_RE.match(key)
        if m:
            stage = m.group(1).replace("_", "-")
            q = float(m.group(2))
            if not 0.0 < q < 100.0:
                raise SloError(f"SLO quantile p{m.group(2)} out of (0, 100)")
            if value <= 0.0:
                raise SloError(f"SLO bound {value} ms must be > 0")
            out.append(SloObjective(
                name=key, kind="latency", budget=1.0 - q / 100.0,
                target=value, stage=stage, quantile=q, bound_ms=value,
            ))
        elif key == "deadline_hit":
            if not 0.0 < value < 1.0:
                raise SloError("deadline_hit must be in (0, 1)")
            out.append(SloObjective(
                name=key, kind="good_ratio", budget=1.0 - value,
                target=value,
            ))
        elif key == "shed_rate":
            if not 0.0 < value < 1.0:
                raise SloError("shed_rate must be in (0, 1)")
            out.append(SloObjective(
                name=key, kind="bad_ratio", budget=value, target=value,
            ))
        else:
            raise SloError(
                f"unknown SLO key {key!r} (want <stage>_p<QQ>_ms, "
                "deadline_hit, or shed_rate)"
            )
    return tuple(out)


def count_over_bound(hist, bound_ms: float) -> int:
    """Samples in a shared-grid bucket vector strictly above the bound:
    every bucket whose span lies past the bound's bucket."""
    idx = bisect.bisect_left(_history.BUCKET_EDGES, bound_ms / 1e3)
    return int(sum(hist[idx + 1:]))


class _ObjectiveState:
    __slots__ = ("objective", "samples", "state", "since", "transitions",
                 "fast_burn", "slow_burn")

    def __init__(self, objective: SloObjective, now: float):
        self.objective = objective
        # (t, total_events, bad_events) — CUMULATIVE fleet counters
        self.samples: deque[tuple[float, float, float]] = deque(
            maxlen=_MAX_SAMPLES
        )
        self.state = STATE_OK
        self.since = now
        self.transitions = 0
        self.fast_burn: float | None = None
        self.slow_burn: float | None = None


class SloEngine:
    """Per-deployment objective tracking fed by the fleet collector.

    ``declare()`` binds a deployment to its parsed spec; ``observe()``
    ingests one poll's cumulative (total, bad) event counters per
    objective; ``evaluate()`` recomputes both window burns and walks the
    ok/warn/page state machine, recording transitions as spans and
    counters.  All storage is bounded (sample rings with maxlen,
    deployments pruned via :meth:`retain`).
    """

    def __init__(
        self,
        *,
        fast_window_s: float | None = None,
        slow_window_s: float | None = None,
        page_burn: float | None = None,
        warn_burn: float | None = None,
        recorder=None,
        metrics=None,
    ):
        if fast_window_s is None:
            fast_window_s = settings.get_float("SCT_SLO_FAST_WINDOW_S")
        if slow_window_s is None:
            slow_window_s = settings.get_float("SCT_SLO_SLOW_WINDOW_S")
        if page_burn is None:
            page_burn = settings.get_float("SCT_SLO_PAGE_BURN")
        if warn_burn is None:
            warn_burn = settings.get_float("SCT_SLO_WARN_BURN")
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.page_burn = page_burn
        self.warn_burn = warn_burn
        self._recorder = recorder
        self._metrics = metrics
        # deployment -> {"spec", "error", "objectives": {name: _ObjectiveState}}
        self._deps: dict[str, dict] = {}

    # -- wiring --------------------------------------------------------------

    def _rec(self):
        if self._recorder is None:
            from seldon_core_tpu_torch.obs.spans import RECORDER
            self._recorder = RECORDER
        return self._recorder

    def _met(self):
        if self._metrics is None:
            from seldon_core_tpu_torch.utils.metrics import DEFAULT
            self._metrics = DEFAULT
        return self._metrics

    # -- declaration ---------------------------------------------------------

    def declare(self, deployment: str, spec: str | None,
                now: float | None = None) -> None:
        """(Re)bind a deployment's objective set.  A changed spec resets
        objective state (the spec-hash rolled the deployment anyway); an
        unchanged one is a no-op so burn windows survive re-declares."""
        if now is None:
            now = time.time()
        cur = self._deps.get(deployment)
        if cur is not None and cur["spec"] == spec:
            return
        entry = {"spec": spec, "error": None, "objectives": {}}
        if spec:
            try:
                for obj in parse_slo(spec):
                    entry["objectives"][obj.name] = _ObjectiveState(obj, now)
            except SloError as e:
                entry["error"] = str(e)
                entry["objectives"] = {}
        self._deps[deployment] = entry

    def retain(self, deployments) -> None:
        """Drop state for departed deployments (store-driven prune)."""
        keep = set(deployments)
        for name in [d for d in self._deps if d not in keep]:
            del self._deps[name]

    def objectives(self, deployment: str) -> tuple[SloObjective, ...]:
        entry = self._deps.get(deployment)
        if not entry:
            return ()
        return tuple(s.objective for s in entry["objectives"].values())

    # -- ingestion -----------------------------------------------------------

    def observe(self, deployment: str, counters: dict,
                now: float | None = None) -> None:
        """Ingest one poll: ``{objective_name: (total, bad)}`` cumulative
        fleet counters (a dip from a replica leaving the aggregate is
        tolerated at evaluation time, not here)."""
        if now is None:
            now = time.time()
        entry = self._deps.get(deployment)
        if not entry:
            return
        for name, st in entry["objectives"].items():
            pair = counters.get(name)
            if pair is None:
                continue
            total, bad = float(pair[0]), float(pair[1])
            # deque(maxlen=_MAX_SAMPLES) drops the oldest
            st.samples.append((now, total, bad))

    # -- evaluation ----------------------------------------------------------

    def _burn(self, st: _ObjectiveState, window_s: float,
              now: float) -> float | None:
        """bad-fraction over the window divided by the error budget.
        Uses the newest sample at least ``window_s`` old (or the oldest
        available while the window fills).  None when the window has no
        new events or a counter dipped (replica left the aggregate)."""
        if len(st.samples) < 2:
            return None
        latest = st.samples[-1]
        base = st.samples[0]
        cutoff = now - window_s
        for s in st.samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        if base is latest:
            base = st.samples[-2]
        d_total = latest[1] - base[1]
        d_bad = latest[2] - base[2]
        if d_total <= 0 or d_bad < 0:
            return None
        budget = st.objective.budget
        if budget <= 0:
            return None
        return (d_bad / d_total) / budget

    def _next_state(self, fast: float | None, slow: float | None) -> str:
        f = fast if fast is not None else 0.0
        s = slow if slow is not None else f
        if f >= self.page_burn and s >= self.page_burn:
            return STATE_PAGE
        if f >= self.warn_burn and s >= self.warn_burn:
            return STATE_WARN
        return STATE_OK

    def _transition(self, deployment: str, st: _ObjectiveState,
                    new_state: str, now: float) -> None:
        old = st.state
        st.state = new_state
        st.since = now
        st.transitions += 1
        attrs = {
            "deployment": deployment,
            "objective": st.objective.name,
            "from": old,
            "to": new_state,
            "fast_burn": None if st.fast_burn is None
            else round(st.fast_burn, 3),
            "slow_burn": None if st.slow_burn is None
            else round(st.slow_burn, 3),
        }
        from seldon_core_tpu_torch.obs.spans import (
            new_traceparent, parse_traceparent,
        )
        trace_id = parse_traceparent(new_traceparent())[0]
        self._rec().record_span(
            "slo-transition", trace_id=trace_id, parent_id=None,
            start=now, duration_s=0.0, service="fleet",
            status="ERROR" if new_state == STATE_PAGE else "OK",
            attrs=attrs,
        )
        try:
            m = self._met()
            m.slo_transitions.labels(
                deployment, st.objective.name, new_state
            ).inc()
        except Exception:  # metrics are best-effort, never break eval
            pass

    def evaluate(self, now: float | None = None) -> dict:
        """Recompute burns + states for every declared objective;
        returns the ``GET /stats/slo`` payload."""
        if now is None:
            now = time.time()
        worst_counts = {STATE_OK: 0, STATE_WARN: 0, STATE_PAGE: 0}
        deployments: dict = {}
        for dep, entry in sorted(self._deps.items()):
            objs: dict = {}
            dep_worst = STATE_OK
            for name, st in entry["objectives"].items():
                st.fast_burn = self._burn(st, self.fast_window_s, now)
                st.slow_burn = self._burn(st, self.slow_window_s, now)
                new_state = self._next_state(st.fast_burn, st.slow_burn)
                if new_state != st.state:
                    self._transition(dep, st, new_state, now)
                try:
                    m = self._met()
                    m.slo_burn_rate.labels(dep, name, "fast").set(
                        st.fast_burn or 0.0)
                    m.slo_burn_rate.labels(dep, name, "slow").set(
                        st.slow_burn or 0.0)
                    m.slo_state.labels(dep, name).set(
                        _STATE_RANK[st.state])
                except Exception:
                    pass
                if _STATE_RANK[st.state] > _STATE_RANK[dep_worst]:
                    dep_worst = st.state
                last = st.samples[-1] if st.samples else None
                objs[name] = {
                    **st.objective.describe(),
                    "state": st.state,
                    "since": round(st.since, 3),
                    "transitions": st.transitions,
                    "fast_burn": None if st.fast_burn is None
                    else round(st.fast_burn, 4),
                    "slow_burn": None if st.slow_burn is None
                    else round(st.slow_burn, 4),
                    "total_events": None if last is None else last[1],
                    "bad_events": None if last is None else last[2],
                }
            worst_counts[dep_worst] += 1
            deployments[dep] = {
                "spec": entry["spec"],
                "error": entry["error"],
                "state": dep_worst,
                "objectives": objs,
            }
        return {
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "thresholds": {"warn": self.warn_burn, "page": self.page_burn},
            "states": worst_counts,
            "deployments": deployments,
        }

    def snapshot(self, now: float | None = None) -> dict:
        return self.evaluate(now=now)
