"""Cheap always-on probes: the port's copy of the JAX package's
``obs/probes.py`` — the event loop's lag, host syncs, and the span ring's
and exporters' drop gauges.

Each explains a swing in throughput that the latency flight recorder
cannot: a saturated event loop, a chatty host/device sync pattern, or an
exporter that silently drops.  Everything is O(1) an event and bounded.
"""

from __future__ import annotations

import asyncio
import os
import threading
from collections import defaultdict

from seldon_core_tpu_torch.utils.metrics import DEFAULT

_EWMA_ALPHA = 0.2


class EventLoopLagProbe:
    """A self-rescheduling ``call_later``: how late each tick runs after
    it was due is the event loop's lag.  One a process (:data:`LOOP_LAG`),
    shared by the servers of one loop: each ``start`` counts a user and
    each ``stop`` one less, and the last ``stop`` cancels the next tick (a
    closed server leaves no timer behind).  A ``start`` on another loop
    moves the probe there.  The interval is ``SCT_LOOP_LAG_INTERVAL_S``
    (default 0.25 s)."""

    def __init__(self, interval_s: float | None = None):
        if interval_s is None:
            interval_s = float(os.environ.get("SCT_LOOP_LAG_INTERVAL_S", "0.25"))
        self.interval_s = max(0.01, interval_s)
        self.samples = 0
        self.last_lag_s = 0.0
        self.ewma_lag_s = 0.0
        self.max_lag_s = 0.0
        self._handle = None
        self._loop = None
        self._service = ""
        self._gauge = None
        self._users = 0

    @property
    def running(self) -> bool:
        return self._handle is not None

    def start(self, service: str = "") -> None:
        loop = asyncio.get_running_loop()
        if self._handle is not None and self._loop is loop:
            self._users += 1
            return
        self._cancel()
        self._users = 1
        self._loop = loop
        self._service = service or self._service
        self._gauge = DEFAULT.eventloop_lag.labels(self._service or "default")
        self._gauge.set(0.0)  # in /prometheus before the first tick
        self._schedule()

    def _schedule(self) -> None:
        due = self._loop.time() + self.interval_s
        self._handle = self._loop.call_later(self.interval_s, self._tick, due)

    def _tick(self, due: float) -> None:
        lag = max(0.0, self._loop.time() - due)
        self.samples += 1
        self.last_lag_s = lag
        self.ewma_lag_s = _EWMA_ALPHA * lag + (1.0 - _EWMA_ALPHA) * self.ewma_lag_s
        self.max_lag_s = max(self.max_lag_s, lag)
        self._gauge.set(self.ewma_lag_s)
        self._schedule()

    def stop(self) -> None:
        self._users = max(0, self._users - 1)
        if not self._users:
            self._cancel()

    def _cancel(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def snapshot(self) -> dict:
        from seldon_core_tpu_torch.obs.wire import sig4

        return {
            "interval_s": self.interval_s,
            "samples": self.samples,
            "last_lag_ms": sig4(self.last_lag_s * 1e3),
            "ewma_lag_ms": sig4(self.ewma_lag_s * 1e3),
            "max_lag_ms": sig4(self.max_lag_s * 1e3),
        }


LOOP_LAG = EventLoopLagProbe()


# -- host syncs --------------------------------------------------------------
#
# Every fetch of a dispatched device result to the host is one round trip;
# syncs a step is the ratio that says a step waits on the host.  Counted
# by model, at the fetch the step already makes.

_host_syncs: dict[str, int] = defaultdict(int)
_host_sync_lock = threading.Lock()


def record_host_sync(model: str, n: int = 1) -> None:
    with _host_sync_lock:
        _host_syncs[model] += n
    DEFAULT.host_syncs.labels(model).inc(n)


def host_sync_snapshot() -> dict:
    with _host_sync_lock:
        return dict(_host_syncs)


# -- span ring and exporter gauges -------------------------------------------

_gauges_installed = False


def install_obs_gauges() -> None:
    """Bind the span recorder's counters and the exporters' totals to
    gauges read at scrape time (idempotent)."""
    global _gauges_installed
    if _gauges_installed:
        return
    from seldon_core_tpu_torch.obs.spans import RECORDER

    DEFAULT.obs_spans.labels("recorded").set_function(lambda: RECORDER.recorded)
    DEFAULT.obs_spans.labels("ring").set_function(lambda: len(RECORDER._spans))
    DEFAULT.obs_spans.labels("sampled_out").set_function(lambda: RECORDER.sampled_out)

    def _export_total(field: str) -> float:
        return float(sum(getattr(e, field, 0) for e in RECORDER.exporters))

    DEFAULT.obs_export.labels("exported").set_function(lambda: _export_total("exported"))
    DEFAULT.obs_export.labels("dropped").set_function(lambda: _export_total("dropped"))
    _gauges_installed = True
