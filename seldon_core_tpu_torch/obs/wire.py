"""Wire-throughput accounting: the port's copy of the JAX package's
``obs/wire.py``.

Every transport edge records the bytes of each transfer and, where it
times the transfer, an achieved-MB/s EWMA, so a stage that is bound by
its bandwidth shows as such.  One :class:`WireCounter` per ``(stage,
deployment)``; the stage vocabulary is the JAX package's:

    gateway-h1      the gateway's splice front (``gateway/h1gateway.py``): request and reply bytes
    gateway-rest    the gateway's fallback cores (``gateway/app.py`` ``_forward``): bodies
    gateway-grpc    the gateway's gRPC relay (``gateway/grpc_gateway.py``): framed request and reply
    engine-rest     the engine's HTTP front (``engine/app.py``): request and reply bodies
    engine-grpc     the engine's gRPC service (``engine/grpc_app.py``): request and reply messages
    engine-node     the engine's hops to remote graph units (``engine/transport.py``)

A record is a few integer adds and one deque append, bounded.  Served by
``GET /stats/wire`` and exported as the ``seldon_wire_*`` families.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from seldon_core_tpu_torch.utils.metrics import DEFAULT

WIRE_GATEWAY_H1 = "gateway-h1"
WIRE_GATEWAY_REST = "gateway-rest"
WIRE_GATEWAY_GRPC = "gateway-grpc"
WIRE_ENGINE_REST = "engine-rest"
WIRE_ENGINE_GRPC = "engine-grpc"
WIRE_ENGINE_NODE = "engine-node"

WIRE_STAGES = (
    WIRE_GATEWAY_H1,
    WIRE_GATEWAY_REST,
    WIRE_GATEWAY_GRPC,
    WIRE_ENGINE_REST,
    WIRE_ENGINE_GRPC,
    WIRE_ENGINE_NODE,
)

_EWMA_ALPHA = 0.2
_WINDOW_S = 10.0  # the live rate's window


def sig4(x: float | None) -> float | None:
    """Four significant digits: a small nonzero figure never reads 0.0."""
    if x is None:
        return None
    return float(f"{x:.4g}")


class WireCounter:
    """Byte accounting for one (stage, deployment) edge.  ``bytes_in`` is
    what the edge received, ``bytes_out`` what it sent (a server edge: in =
    request, out = reply; a client edge: out = request, in = reply)."""

    __slots__ = ("stage", "name", "requests", "bytes_in", "bytes_out", "_events",
                 "_ewma_mb_s", "_m_in", "_m_out", "_m_reqs", "_m_mb_s")

    def __init__(self, stage: str, name: str):
        self.stage = stage
        self.name = name
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self._events: deque[tuple[float, int]] = deque(maxlen=8192)
        self._ewma_mb_s: float | None = None
        self._m_in = DEFAULT.wire_bytes.labels(stage, name, "in")
        self._m_out = DEFAULT.wire_bytes.labels(stage, name, "out")
        self._m_reqs = DEFAULT.wire_requests.labels(stage, name)
        self._m_mb_s = DEFAULT.wire_mb_s.labels(stage, name)

    def record(self, bytes_in: int = 0, bytes_out: int = 0,
               duration_s: float | None = None) -> None:
        """One transfer; ``duration_s`` feeds the per-transfer MB/s EWMA.
        Never raises, never blocks."""
        self.requests += 1
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        total = bytes_in + bytes_out
        self._events.append((time.monotonic(), total))
        if bytes_in:
            self._m_in.inc(bytes_in)
        if bytes_out:
            self._m_out.inc(bytes_out)
        self._m_reqs.inc()
        if duration_s and duration_s > 0 and total:
            inst = total / duration_s / 1e6
            self._ewma_mb_s = (inst if self._ewma_mb_s is None
                               else _EWMA_ALPHA * inst + (1.0 - _EWMA_ALPHA) * self._ewma_mb_s)
            self._m_mb_s.set(self._ewma_mb_s)

    def window_mb_s(self, window_s: float = _WINDOW_S) -> float:
        """MB/s moved over the trailing window (wall clock)."""
        cutoff = time.monotonic() - window_s
        total = 0
        for ts, n in reversed(self._events):
            if ts < cutoff:
                break
            total += n
        return total / window_s / 1e6

    def snapshot(self) -> dict:
        return {
            "requests": self.requests,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "ewma_mb_s": sig4(self._ewma_mb_s),
            "window_mb_s": sig4(self.window_mb_s()),
        }


class WireRecorder:
    """The process's :class:`WireCounter` registry (:data:`WIRE`)."""

    def __init__(self):
        self._counters: dict[tuple[str, str], WireCounter] = {}
        self._lock = threading.Lock()

    def counter(self, stage: str, name: str = "") -> WireCounter:
        key = (stage, name)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.get(key)
                if c is None:
                    c = self._counters[key] = WireCounter(stage, name)
        return c

    def snapshot(self) -> dict:
        """``{"stages": {stage: {deployment: counters}}, "totals": {stage:
        {requests, bytes_in, bytes_out}}}``."""
        stages: dict[str, dict] = {}
        for (stage, name), c in list(self._counters.items()):
            stages.setdefault(stage, {})[name or "_"] = c.snapshot()
        totals = {stage: {f: sum(v[f] for v in by_name.values())
                          for f in ("requests", "bytes_in", "bytes_out")}
                  for stage, by_name in stages.items()}
        return {"stages": stages, "totals": totals}


# the process-wide wire recorder
WIRE = WireRecorder()
