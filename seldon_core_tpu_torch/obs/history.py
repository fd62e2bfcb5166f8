"""Bounded time-series history for the fleet telemetry plane: the port's
copy of the JAX package's ``obs/history.py``.

Two pieces (docs/OBSERVABILITY.md "Fleet telemetry"):

* **Step-down rings** — every metric gets a fast ring (10 s buckets)
  and a slow ring (2 min buckets), each a fixed number of slots
  (``SCT_FLEET_HISTORY_SLOTS``, default 360: one hour of 10 s points
  plus twelve hours of 2 min points).  Slots are preallocated lists
  indexed by ``bucket_id % slots`` — recording is two list stores and
  an add, zero allocation at steady state, and a wrapped slot simply
  overwrites the hour-old bucket: the same drop-on-full discipline as
  the span rings.  No ``append`` ever touches a ring.

* **Mergeable latency histograms** — fleet percentiles must be
  computed from merged per-replica histogram bucket COUNTS, never by
  averaging per-replica percentiles (a p99 of p99s is meaningless the
  moment replicas see different traffic).  ``BUCKET_EDGES`` pins one
  shared log-spaced grid (50 µs .. 50 s, 40 buckets/decade — the same
  resolution the load harness uses, so merged quantiles land within
  ~3% of the true value, i.e. inside one bucket) that every replica
  bins into and every aggregator sums over.
"""

from __future__ import annotations

import bisect
import threading
import time

from seldon_core_tpu_torch.runtime import settings

# ---------------------------------------------------------------------------
# shared histogram grid
# ---------------------------------------------------------------------------

# 50 µs .. 50 s, 40 buckets per decade (6 decades -> 241 edges, 242
# counting slots incl. the overflow bucket).  Pure python.
BUCKET_EDGES: tuple[float, ...] = tuple(
    5e-5 * 10.0 ** (i / 40.0) for i in range(241)
)


def new_hist() -> list[int]:
    """A zeroed bucket-count vector over ``BUCKET_EDGES``."""
    return [0] * (len(BUCKET_EDGES) + 1)


def record_hist(hist: list[int], seconds: float) -> None:
    hist[bisect.bisect_left(BUCKET_EDGES, seconds)] += 1


def bin_samples(samples) -> list[int]:
    """Bin an iterable of second-valued samples onto the shared grid."""
    hist = new_hist()
    for s in samples:
        hist[bisect.bisect_left(BUCKET_EDGES, s)] += 1
    return hist


def merge_hist(into: list[int], other) -> list[int]:
    """Sum ``other``'s bucket counts into ``into`` (length-tolerant so a
    replica on an older grid degrades instead of raising)."""
    for i in range(min(len(into), len(other))):
        into[i] += int(other[i])
    return into


def hist_percentile_ms(hist, q: float) -> float | None:
    """The q-th percentile (ms) of a bucket-count vector: walk the
    cumulative counts to the target rank and report that bucket's upper
    edge — exact to one bucket width, and stable under merging."""
    total = sum(hist)
    if total == 0:
        return None
    rank = q / 100.0 * total
    seen = 0
    for i, c in enumerate(hist):
        seen += c
        if seen >= rank and c:
            edge = BUCKET_EDGES[min(i, len(BUCKET_EDGES) - 1)]
            return round(edge * 1e3, 4)
    return round(BUCKET_EDGES[-1] * 1e3, 4)


# ---------------------------------------------------------------------------
# step-down rings
# ---------------------------------------------------------------------------

FAST_STEP_S = 10.0
SLOW_STEP_S = 120.0


class _Ring:
    """Fixed-slot bucketed ring: slot = absolute_bucket % slots.  A
    record into a slot still holding an old bucket evicts it in place —
    bounded by construction, zero steady-state allocation."""

    __slots__ = ("step", "slots", "_sum", "_min", "_max", "_count", "_bucket")

    def __init__(self, step: float, slots: int):
        self.step = step
        self.slots = slots
        self._sum = [0.0] * slots
        self._min = [0.0] * slots
        self._max = [0.0] * slots
        self._count = [0] * slots
        self._bucket = [-1] * slots

    def record(self, now: float, value: float) -> None:
        b = int(now // self.step)
        i = b % self.slots
        if self._bucket[i] != b:
            self._bucket[i] = b
            self._sum[i] = 0.0
            self._min[i] = value
            self._max[i] = value
            self._count[i] = 0
        self._sum[i] += value
        self._count[i] += 1
        if value < self._min[i]:
            self._min[i] = value
        if value > self._max[i]:
            self._max[i] = value

    def points(self, now: float, limit: int | None = None) -> list[dict]:
        """Oldest-first [{t, mean, min, max, count}] for live buckets."""
        b_now = int(now // self.step)
        span = self.slots if limit is None else min(limit, self.slots)
        out = []
        for b in range(b_now - span + 1, b_now + 1):
            i = b % self.slots
            if self._bucket[i] == b and self._count[i]:
                out.append({
                    "t": round(b * self.step, 3),
                    "mean": self._sum[i] / self._count[i],
                    "min": self._min[i],
                    "max": self._max[i],
                    "count": self._count[i],
                })
        return out


class History:
    """Per-metric step-down rings (fast 10 s + slow 2 min), bounded in
    both directions: slots per ring AND distinct metric names
    (drop-on-full with a counter, never unbounded growth)."""

    def __init__(self, slots: int | None = None, max_metrics: int = 512):
        if slots is None:
            slots = settings.get_int("SCT_FLEET_HISTORY_SLOTS")
        self.slots = max(int(slots), 2)
        self.max_metrics = max_metrics
        self._series: dict[str, tuple[_Ring, _Ring]] = {}
        self._last: dict[str, float] = {}
        self.dropped_metrics = 0
        self._lock = threading.Lock()

    def _rings(self, metric: str) -> tuple[_Ring, _Ring] | None:
        pair = self._series.get(metric)
        if pair is None:
            if len(self._series) >= self.max_metrics:
                self.dropped_metrics += 1
                return None
            pair = (_Ring(FAST_STEP_S, self.slots),
                    _Ring(SLOW_STEP_S, self.slots))
            self._series[metric] = pair
        return pair

    def record(self, metric: str, value: float,
               now: float | None = None) -> None:
        if now is None:
            now = time.time()
        value = float(value)
        with self._lock:
            pair = self._rings(metric)
            if pair is None:
                return
            pair[0].record(now, value)
            pair[1].record(now, value)
            self._last[metric] = value

    def last(self, metric: str) -> float | None:
        with self._lock:
            return self._last.get(metric)

    def series(self, metric: str, resolution: str = "fast",
               now: float | None = None,
               limit: int | None = None) -> list[dict]:
        if now is None:
            now = time.time()
        with self._lock:
            pair = self._series.get(metric)
            if pair is None:
                return []
            ring = pair[0] if resolution == "fast" else pair[1]
            return ring.points(now, limit)

    def slope(self, metric: str, window_s: float = 300.0,
              now: float | None = None) -> float | None:
        """Least-squares trend (value units per second) over the recent
        fast-ring window — the "is it getting worse" primitive behind
        queue-wait slope / shed-rate delta / KV high-water growth."""
        if now is None:
            now = time.time()
        pts = self.series(
            metric, "fast", now=now,
            limit=max(2, int(window_s / FAST_STEP_S)),
        )
        if len(pts) < 2:
            return None
        xs = [p["t"] for p in pts]
        ys = [p["mean"] for p in pts]
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den == 0:
            return None
        return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den

    def delta(self, metric: str, window_s: float = 300.0,
              now: float | None = None) -> float | None:
        """newest bucket mean - oldest bucket mean over the window."""
        if now is None:
            now = time.time()
        pts = self.series(
            metric, "fast", now=now,
            limit=max(2, int(window_s / FAST_STEP_S)),
        )
        if len(pts) < 2:
            return None
        return pts[-1]["mean"] - pts[0]["mean"]

    def metrics(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self, points: int = 30,
                 now: float | None = None) -> dict:
        """Recent tail per metric (bounded: ``points`` fast buckets) —
        the shape /stats/fleet embeds under "history"."""
        if now is None:
            now = time.time()
        out: dict = {}
        with self._lock:
            names = sorted(self._series)
        for name in names:
            out[name] = {
                "last": self.last(name),
                "fast": self.series(name, "fast", now=now, limit=points),
            }
        return {
            "metrics": out,
            "slots": self.slots,
            "steps_s": [FAST_STEP_S, SLOW_STEP_S],
            "dropped_metrics": self.dropped_metrics,
        }
