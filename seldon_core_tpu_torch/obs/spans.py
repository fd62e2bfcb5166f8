"""The span recorder and the per-stage flight recorder: the port's copy of
the JAX package's ``obs/spans.py``.

* **spans**: a hop opens a span against the request's W3C trace context
  (a ``traceparent`` contextvar, minted as a root when the request
  carries none); finished spans land in a bounded ring.  ``SCT_TRACE_SAMPLE``
  (default 1.0) thins the recording, never the propagation.
* **stages**: fixed-vocabulary duration rings (queue wait, device step,
  time to first token, ...) that say where a request's time went without
  rebuilding traces.  Recording one is a deque append, safe from any
  thread.  The QoS plane reads two of them at admission
  (:meth:`SpanRecorder.stage_ewma`).

The engine serves both at ``GET /stats/spans`` and ``GET /stats/breakdown``
and echoes each request's trace id in ``x-sct-trace-id``.  Finished spans
also go to the recorder's exporters (``obs/export.py``, OTLP/HTTP JSON),
each behind its own bounded queue.  Every span names the pool role that
recorded it (``engine.role``): the request's role, else the process's.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import dataclasses
import os
import random
import time
from collections import defaultdict, deque
from typing import Any, Iterator

# the flight recorder's stage vocabulary (the JAX package's names)
STAGE_GATEWAY_RELAY = "gateway-relay"
STAGE_ENGINE_ROUTE = "engine-route"
STAGE_NODE = "node"
STAGE_QUEUE_WAIT = "queue-wait"
STAGE_BATCH_ASSEMBLY = "batch-assembly"
STAGE_DEVICE_STEP = "device-step"
STAGE_DEVICE_DISPATCH = "device-dispatch"
STAGE_STREAM_FLUSH = "stream-flush"
STAGE_TTFT = "ttft"

STAGES = (
    STAGE_GATEWAY_RELAY,
    STAGE_ENGINE_ROUTE,
    STAGE_NODE,
    STAGE_QUEUE_WAIT,
    STAGE_BATCH_ASSEMBLY,
    STAGE_DEVICE_STEP,
    STAGE_DEVICE_DISPATCH,
    STAGE_STREAM_FLUSH,
    STAGE_TTFT,
)

# the stage histograms' shared log grid: 50 us .. 50 s, 40 buckets a decade
# (the JAX package's ``obs/history.BUCKET_EDGES``)
BUCKET_EDGES: tuple[float, ...] = tuple(5e-5 * 10.0 ** (i / 40.0) for i in range(241))

# -- W3C trace context -------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"
TRACE_RESPONSE_HEADER = "x-sct-trace-id"  # echoed like x-seldon-puid

_traceparent: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "sct_traceparent", default=None
)
_HEX = set("0123456789abcdef")


def _hexok(s: str) -> bool:
    return bool(s) and all(c in _HEX for c in s)


def _random_id(nbytes: int) -> str:
    while True:  # an all-zero id is the spec's invalid value
        rid = os.urandom(nbytes).hex()
        if rid.strip("0"):
            return rid


def make_trace_id() -> str:
    return _random_id(16)


def make_span_id() -> str:
    return _random_id(8)


def new_traceparent(sampled: bool = True) -> str:
    """A version-00 traceparent with fresh ids."""
    return f"00-{_random_id(16)}-{_random_id(8)}-{'01' if sampled else '00'}"


def parse_traceparent(tp: str | None) -> tuple[str, str, int] | None:
    """-> ``(trace_id, span_id, flags)``, or None for anything malformed."""
    if not tp:
        return None
    parts = tp.strip().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id, flags = parts[:4]
    if len(version) != 2 or not _hexok(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _hexok(trace_id) or not trace_id.strip("0"):
        return None
    if len(span_id) != 16 or not _hexok(span_id) or not span_id.strip("0"):
        return None
    if len(flags) != 2 or not _hexok(flags):
        return None
    return trace_id, span_id, int(flags, 16)


def set_traceparent(value: str | None) -> None:
    """Seed this request's trace context (an ingress sets it per request)."""
    _traceparent.set(value or None)


def get_traceparent() -> str | None:
    return _traceparent.get()


def ensure_traceparent() -> tuple[str, bool]:
    """The current traceparent when valid, else a fresh root one, set for
    this context -> ``(traceparent, minted)``."""
    tp = _traceparent.get()
    if tp is not None and parse_traceparent(tp) is not None:
        return tp, False
    tp = new_traceparent()
    _traceparent.set(tp)
    return tp, True


def current_trace_id() -> str | None:
    parsed = parse_traceparent(_traceparent.get())
    return parsed[0] if parsed else None


def is_sampled() -> bool:
    parsed = parse_traceparent(_traceparent.get())
    return bool(parsed and parsed[2] & 0x01)


def outgoing_headers() -> dict[str, str]:
    """The headers a downstream hop carries ({} with no trace)."""
    tp = _traceparent.get()
    return {TRACEPARENT_HEADER: tp} if tp else {}


# the pool role every recorded span names (``engine.role``): the request's
# (seeded at each ingress) over the process's (seeded at boot), as several
# engines of different roles may share one process
_engine_role: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "sct_engine_role", default=None
)
_process_role: str | None = None


def set_engine_role(role: str | None) -> None:
    _engine_role.set(role or None)


def set_process_role(role: str | None) -> None:
    global _process_role
    _process_role = role or None


def current_engine_role() -> str | None:
    return _engine_role.get() or _process_role


# -- spans -------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One finished span; times are epoch seconds."""

    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    service: str
    start: float
    duration_s: float
    status: str = "OK"
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)  # (name, epoch_s, attrs)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start": self.start,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "status": self.status,
            "attrs": self.attrs,
            "events": [{"name": n, "ts": ts, "attrs": a} for n, ts, a in self.events],
        }


class _LiveSpan:
    """The in-flight handle :meth:`SpanRecorder.span` yields."""

    __slots__ = ("span",)

    def __init__(self, span: Span):
        self.span = span

    def set_attr(self, key: str, value: Any) -> None:
        self.span.attrs[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        self.span.events.append((name, time.time(), attrs))

    def set_status(self, status: str) -> None:
        self.span.status = status


# the innermost live span of this async context (None when unsampled or
# none is open): deeper layers attach events without a handle
_live_span: contextvars.ContextVar["_LiveSpan | None"] = contextvars.ContextVar(
    "sct_live_span", default=None
)


def current_span() -> "_LiveSpan | None":
    return _live_span.get()


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))]


class SpanRecorder:
    """Bounded always-on recorder; one a process (:data:`RECORDER`).

    The span ring (``SCT_SPANS_RING``, default 2048 spans) and the
    per-stage rings (``SCT_STAGE_RING``, default 8192 samples a stage) are
    deques with a maxlen: a burst evicts the oldest, never grows them."""

    def __init__(self, max_spans: int | None = None, max_stage_samples: int | None = None,
                 sample: float | None = None):
        if max_spans is None:
            max_spans = int(os.environ.get("SCT_SPANS_RING", "2048"))
        if max_stage_samples is None:
            max_stage_samples = int(os.environ.get("SCT_STAGE_RING", "8192"))
        if sample is None:
            sample = float(os.environ.get("SCT_TRACE_SAMPLE", "1.0"))
        self.sample = min(1.0, max(0.0, sample))
        self._spans: deque[Span] = deque(maxlen=max_spans)
        self._stages: dict[str, deque[float]] = defaultdict(
            lambda: deque(maxlen=max_stage_samples))
        for s in STAGES:  # made up front: a thread's append needs no __missing__
            self._stages[s]
        # cumulative, past the rings' eviction
        self._stage_counts: dict[str, int] = defaultdict(int)
        self._stage_hist: dict[str, list[int]] = defaultdict(
            lambda: [0] * (len(BUCKET_EDGES) + 1))
        self.recorded = 0
        self.sampled_out = 0
        self.exporters: list = []

    # -- recording ---------------------------------------------------------

    def should_sample(self) -> bool:
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return random.random() < self.sample

    @contextlib.contextmanager
    def span(self, name: str, service: str = "", stage: str | None = None,
             attrs: dict | None = None) -> Iterator["_LiveSpan | None"]:
        """Open a span in this async context: a child of the current
        traceparent (a new root when there is none), which it re-points at
        itself for the spans opened inside.  Yields the live span, or None
        when sampled out (the stage's time is recorded all the same).  An
        exception inside marks the span ERROR and propagates."""
        tp = get_traceparent()
        parsed = parse_traceparent(tp)
        t0 = time.perf_counter()
        start = time.time()
        minted_root = parsed is None
        if minted_root:
            tp = new_traceparent(sampled=self.should_sample())
            parsed = parse_traceparent(tp)
            parent_id = None
        else:
            parent_id = parsed[1]
        trace_id, _, flags = parsed
        live: _LiveSpan | None = None
        live_token = None
        if flags & 0x01 and self.sample > 0.0:
            span_id = _random_id(8)
            token = _traceparent.set(f"00-{trace_id}-{span_id}-{flags:02x}")
            span_attrs = dict(attrs) if attrs else {}
            role = current_engine_role()
            if role is not None:
                span_attrs.setdefault("engine.role", role)
            live = _LiveSpan(Span(trace_id=trace_id, span_id=span_id, parent_id=parent_id,
                                  name=name, service=service, start=start, duration_s=0.0,
                                  attrs=span_attrs))
            live_token = _live_span.set(live)
        else:  # not recorded, but propagated unchanged
            token = _traceparent.set(tp)
        try:
            yield live
        except BaseException:
            if live is not None:
                live.span.status = "ERROR"
            raise
        finally:
            dt = time.perf_counter() - t0
            if not minted_root:
                # the parent's context again for sibling spans; a minted root
                # stays set for the ingress to read after the span closes
                _traceparent.reset(token)
            if live_token is not None:
                _live_span.reset(live_token)
            if stage is not None:
                self.record_stage(stage, dt)
            if live is not None:
                live.span.duration_s = dt
                self.record(live.span)

    def record(self, span: Span) -> None:
        self._spans.append(span)
        self.recorded += 1
        for exp in self.exporters:
            exp.offer(span)

    def record_span(self, name: str, *, trace_id: str, parent_id: str | None, start: float,
                    duration_s: float, service: str = "", status: str = "OK",
                    attrs: dict | None = None, sampled: bool = True,
                    span_id: str | None = None) -> None:
        """Record a span timed outside a context manager (a capture after
        warmup is timed by the model, not inside a request)."""
        if not sampled or self.sample <= 0.0:
            self.sampled_out += 1
            return
        span_attrs = dict(attrs) if attrs else {}
        role = current_engine_role()
        if role is not None:
            span_attrs.setdefault("engine.role", role)
        self.record(Span(trace_id=trace_id, span_id=span_id or make_span_id(),
                         parent_id=parent_id, name=name, service=service, start=start,
                         duration_s=duration_s, status=status, attrs=span_attrs))

    def record_stage(self, stage: str, duration_s: float) -> None:
        """One stage sample: unconditional, O(1), safe from any thread."""
        self._stages[stage].append(duration_s)
        self._stage_counts[stage] += 1
        self._stage_hist[stage][bisect.bisect_left(BUCKET_EDGES, duration_s)] += 1

    # -- reading -----------------------------------------------------------

    def stage_ewma(self, stage: str, n: int = 64, alpha: float = 0.2) -> float | None:
        """EWMA over the stage ring's last ``n`` samples (None while the
        stage has none): the QoS plane's time-to-completion estimate."""
        ring = self._stages.get(stage)
        if not ring:
            return None
        vals = list(ring)[-max(1, n):]
        est = vals[0]
        for v in vals[1:]:
            est = alpha * v + (1.0 - alpha) * est
        return est

    def breakdown(self) -> dict:
        """``{stage: {count, window, total_ms, p50_ms, p90_ms, p99_ms,
        max_ms}}``: ``count`` is cumulative, the rest over the ring."""
        out: dict[str, dict] = {}
        for stage, ring in list(self._stages.items()):
            vals = sorted(ring)
            if not vals:
                continue
            out[stage] = {
                "count": self._stage_counts[stage],
                "window": len(vals),
                "total_ms": round(sum(vals) * 1e3, 3),
                "p50_ms": round(_percentile(vals, 0.50) * 1e3, 3),
                "p90_ms": round(_percentile(vals, 0.90) * 1e3, 3),
                "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3),
                "max_ms": round(vals[-1] * 1e3, 3),
            }
        return out

    def stage_histograms(self) -> dict:
        """Cumulative per-stage bucket counts over :data:`BUCKET_EDGES`:
        the form of :meth:`breakdown` that sums across replicas."""
        return {stage: list(h) for stage, h in list(self._stage_hist.items())
                if self._stage_counts.get(stage)}

    def recent_traces(self, n: int = 20) -> list[dict]:
        """The last ``n`` traces, newest first, each with its spans in
        recording order."""
        by_trace: dict[str, list[Span]] = {}
        for span in self._spans:
            by_trace.setdefault(span.trace_id, []).append(span)
        out = []
        for tid in reversed(list(by_trace)[-n:]):
            spans = by_trace[tid]
            out.append({
                "trace_id": tid,
                "span_count": len(spans),
                "duration_ms": round(max(s.duration_s for s in spans) * 1e3, 3),
                "spans": [s.to_dict() for s in spans],
            })
        return out

    def slowest(self, n: int = 10) -> list[dict]:
        """The slowest ``n`` root spans in the ring."""
        roots = sorted((s for s in self._spans if s.parent_id is None),
                       key=lambda s: s.duration_s, reverse=True)
        return [s.to_dict() for s in roots[:n]]

    def stats(self, n: int = 20) -> dict:
        """The ``GET /stats/spans`` payload."""
        return {
            "recorded": self.recorded,
            "ring": len(self._spans),
            "sample": self.sample,
            "exporters": {type(e).__name__: {"exported": e.exported, "dropped": e.dropped}
                          for e in self.exporters},
            "slowest": self.slowest(min(n, 10)),
            "traces": self.recent_traces(n),
        }


# the process-wide recorder
RECORDER = SpanRecorder()
