"""Span exporters: the port's copy of the JAX package's ``obs/export.py``
(the OTLP/HTTP JSON exporter; the taplog exporter comes with the control
plane).

Every exporter fronts a bounded in-memory queue drained by a background
task on the event loop: ``offer`` never blocks and never raises, and a
full queue (a dead or slow collector) drops the span and counts it.  The
serving path's worst case is one queue append.  An offer from a thread
with no running loop (the scheduler's worker) is dropped and counted too.

Selected by the environment (:func:`exporters_from_env`):

    SCT_OTLP_ENDPOINT=http://collector:4318/v1/traces   OTLP/HTTP JSON
    SCT_SPANS_BROKER=host:port                          refused by name
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import urllib.parse
from typing import TYPE_CHECKING, Any

from seldon_core_tpu_torch.wire.h1client import H1Pool

if TYPE_CHECKING:  # pragma: no cover
    from seldon_core_tpu_torch.obs.spans import Span

log = logging.getLogger(__name__)

_BATCH = 64  # spans a POST
SCOPE = "seldon_core_tpu_torch.obs"  # the instrumentation scope spans are exported under


def _ns(seconds: float) -> str:
    # OTLP's uint64 nanoseconds are JSON strings (the proto3 JSON mapping)
    return str(int(seconds * 1e9))


def _otlp_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: dict) -> list[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


def otlp_payload(spans: "list[Span]", service_name: str = "seldon-core-tpu") -> dict:
    """The OTLP/HTTP JSON body (``ExportTraceServiceRequest``) for a batch
    of spans, as a collector's ``otlp`` receiver takes it on /v1/traces."""
    otlp_spans = []
    for s in spans:
        otlp_spans.append({
            "traceId": s.trace_id,
            "spanId": s.span_id,
            **({"parentSpanId": s.parent_id} if s.parent_id else {}),
            "name": s.name,
            "kind": 2,  # SPAN_KIND_SERVER
            "startTimeUnixNano": _ns(s.start),
            "endTimeUnixNano": _ns(s.start + s.duration_s),
            "attributes": _otlp_attrs(
                {**s.attrs, **({"service.stage": s.service} if s.service else {})}),
            "events": [{"name": name, "timeUnixNano": _ns(ts), "attributes": _otlp_attrs(attrs)}
                       for name, ts, attrs in s.events],
            "status": {"code": 2 if s.status == "ERROR" else 1},
        })
    return {"resourceSpans": [{
        "resource": {"attributes": _otlp_attrs({"service.name": service_name})},
        "scopeSpans": [{"scope": {"name": SCOPE}, "spans": otlp_spans}],
    }]}


class QueuedSpanExporter:
    """A bounded queue (``SCT_SPANS_EXPORT_QUEUE``, default 2048) and a
    drain task made on the loop that first offers a span."""

    def __init__(self, max_queue: int | None = None):
        if max_queue is None:
            max_queue = int(os.environ.get("SCT_SPANS_EXPORT_QUEUE", "2048"))
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self._task: asyncio.Task | None = None
        self.exported = 0
        self.dropped = 0

    def offer(self, span: "Span") -> None:
        try:
            if self._task is None or self._task.done():
                self._task = asyncio.get_running_loop().create_task(self._drain())
            self._queue.put_nowait(span)
        except (asyncio.QueueFull, RuntimeError):
            # a full queue, or no running loop on this thread
            self.dropped += 1

    async def _drain(self) -> None:
        while True:
            batch = [await self._queue.get()]
            while len(batch) < _BATCH:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                await self._emit(batch)
                self.exported += len(batch)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 - a dead collector costs spans only
                self.dropped += len(batch)
                log.debug("span export failed (%d dropped): %s", len(batch), e)

    async def _emit(self, batch: "list[Span]") -> None:
        raise NotImplementedError

    async def close(self) -> None:
        if self._task is not None:
            for _ in range(20):  # a short best-effort flush
                if self._queue.empty():
                    break
                await asyncio.sleep(0.01)
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # a fresh queue: the old one is bound to the loop that drained it
        self._queue = asyncio.Queue(maxsize=self._queue.maxsize)


class OtlpJsonExporter(QueuedSpanExporter):
    """POST batches of spans as OTLP/HTTP JSON to ``endpoint`` over a
    pooled HTTP/1.1 connection, each within ``SCT_OTLP_TIMEOUT_S``
    (default 1 s), so a hung collector costs the drain task that much a
    batch and never the serving path."""

    def __init__(self, endpoint: str, timeout_s: float | None = None,
                 max_queue: int | None = None):
        super().__init__(max_queue)
        self.endpoint = endpoint
        self.timeout_s = (timeout_s if timeout_s is not None
                          else float(os.environ.get("SCT_OTLP_TIMEOUT_S", "1.0")))
        url = urllib.parse.urlsplit(endpoint)
        if url.scheme != "http" or not url.hostname:
            raise ValueError(f"SCT_OTLP_ENDPOINT must be an http:// URL, got {endpoint!r}")
        self._path = url.path or "/v1/traces"
        self._pool = H1Pool(url.hostname, url.port or 80)

    async def _emit(self, batch: "list[Span]") -> None:
        resp = await self._pool.post(self._path, json.dumps(otlp_payload(batch)).encode(),
                                     timeout=self.timeout_s)
        if resp.status >= 400:
            raise RuntimeError(f"collector returned {resp.status}")

    async def close(self) -> None:
        await super().close()
        await self._pool.close()


def exporters_from_env(environ: dict | None = None) -> list:
    env = environ if environ is not None else os.environ
    out: list = []
    endpoint = env.get("SCT_OTLP_ENDPOINT", "")
    if endpoint:
        out.append(OtlpJsonExporter(endpoint))
    if env.get("SCT_SPANS_BROKER", ""):
        raise ValueError("SCT_SPANS_BROKER (the taplog span exporter) is not in the port yet; "
                         "unset it, or export spans with SCT_OTLP_ENDPOINT")
    return out
