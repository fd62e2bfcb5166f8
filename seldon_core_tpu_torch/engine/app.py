"""The engine: a REST front for one predictor, on the stdlib alone.

    python -m seldon_core_tpu_torch.engine.app --port 8000 [--device cuda|cpu]
        [--grpc-port 5001] [--workers N]
        [--role prefill|decode|unified] [--disagg-decode host:port,...]

Serves ``POST /api/v0.1/predictions`` (a SeldonMessage JSON body),
``GET /ping``, ``GET /ready`` (true once the graph's units are built and
warmed, false while paused) and ``/pause`` and ``/unpause`` (GET or POST:
the drain toggle a preStop hook sends) with a minimal HTTP/1.1 handler on
``asyncio.start_server``: Content-Length bodies, keep-alive unless the
client says ``close``.  A JSON body may also come form-encoded, the
message in a ``json`` field, as the reference engine posts it
(``wire/h1server.py``).  The predictor comes from ``ENGINE_PREDICTOR`` as
for the JAX engine; its graph may hold routers, combiners, transformers,
cascade routers and guardrails, units behind REST endpoints (wrapped
microservices, ``engine/transport.py``), ``JAX_MODEL`` zoo units (their
batching queues answer 429 when full and 504 for a request whose deadline
passed before its device step) and ``JAX_GENERATIVE`` units.  A ``rawTensor``
request is answered with a ``rawTensor``.  Every request seeds the
request-scoped QoS context from ``x-sct-deadline-ms`` and
``x-sct-priority`` (an absent header resets it, so a keep-alive connection
never inherits the previous request's deadline).

``POST /api/v0.1/feedback`` (alias ``/api/v1.0/feedback``) takes a
Feedback message (``{"request": ..., "response": ..., "reward": r,
"truth": ...}``) and replays the routed path recorded in
``response.meta.routing``: 400 for a bad body, 500 when a unit fails.
``POST /api/v0.1/embeddings`` (``{"tokens": [...]}``, a flat list or a
batch of lists, bare or in ``strData``) answers the mean-pooled final
hidden states of the graph's first generative unit with ``embed`` on, as
a float32 ``rawTensor`` ``(B, E)``; 400 when no unit has ``embed``.

``POST /api/v0.1/predictions/stream`` streams a generative graph's tokens
as server-sent events: the body is the generative strData contract
(``{"tokens": [...], "max_new_tokens": N, "temperature": t, "eos_id":
e}``, bare or wrapped in ``strData``) for ONE prompt; the reply is
``text/event-stream`` of ``data: {"token": id}`` events, written one
decode block at a time, closed by ``data: {"done": true, "tokens":
[...]}`` (or ``data: {"error": ...}``) and the end of the connection.  A
bad option is a 400 before any header goes out; so is a graph with no
generative unit.  A client that leaves mid-stream cancels its request,
whose slot the scheduler frees.

The Seldon gRPC service (``engine/grpc_app.py``: Predict, SendFeedback
and the server-streaming StreamPredict) listens beside the REST front on
``--grpc-port`` (``ENGINE_SERVER_GRPC_PORT``, default 5001; a port that
does not bind fails the boot unless ``ENGINE_GRPC_OPTIONAL=1``).
``--workers N`` (``ENGINE_WORKERS``) runs N spawned processes that share
both ports through SO_REUSEPORT, for CPU-bound graphs only.  The served
process names its deployment ``SELDON_DEPLOYMENT_ID`` (else the
predictor's name) and tunes its event loop once the units are warm
(``utils/loops.py``).

A generative body's ``"adapter"`` (on the predictions, stream and
``/disagg/generate`` routes and the prefix pull) names the LoRA adapter
the prompt decodes through, in place of the unit's default; ``null`` is
the base model.  An adapter that is not resident, or any adapter on a
unit built without LoRA, is a 400 before any header.

The disaggregated routes of the JAX engine, for a graph with one
generative unit:

* ``POST /disagg/generate`` (``{"tokens": [...], "max_new_tokens": N,
  ...}``, or the same JSON in ``strData``): a ``prefill`` engine with
  decode peers prefills into a pinned slot, exports the KV handoff frame,
  POSTs it to a peer's ``/disagg/import`` and relays its tokens (``mode:
  "disagg"``); any failure of the handoff decodes locally (``mode:
  "unified-fallback"``, the same tokens, no block leaked).  Other engines
  generate locally (``mode: "unified"``).  With ``SCT_PREFIX_PEER_PULL=1``
  and an ``x-sct-prefix-peer: host:port`` header, the prompt's prefix
  chain is first pulled from that peer and installed.
* ``POST /disagg/import`` (a handoff frame): import and decode; a prefill
  engine answers 409, a malformed frame 400, a pool of another block size
  or KV layout, or a frame naming an adapter not resident here, 409.
* ``POST /disagg/prefix/pull`` (``{"tokens": [...], "max_blocks": N,
  "adapter": name}``): the longest prefix chain this engine holds under
  that adapter, as a prefix-chain frame, or 404.
* ``GET /stats/disagg``: the role, the peers and the handoff and pull
  ledgers.

Both routes that take a request (``/disagg/generate`` and
``/disagg/import``) pass QoS admission.  A handoff POST carries the
request's deadline and priority headers.

Chip packing and live drain.  ``ENGINE_CO_PREDICTORS`` (a base64 JSON list
of predictor specs) boots further deployments beside the primary on the
same card; each generative unit of every deployment registers with the
process's device arbiter (``executor/arbiter.py``) before readiness, under
its ``pack_class`` and ``pack_slo_ms``, and they warm in turn.  A
co-resident deployment has no route of its own: it is reached through its
units.  ``SCT_PACK=1`` registers a sole deployment too.
``GET /stats/breakdown`` then carries the arbiter's ledger (``packing``),
the card's and the host's byte ledgers (``memory``) and each unit's
packing snapshot.

* ``POST /admin/drain`` (``{"peer": "host:port", "timeout_s": 30}``, both
  optional): pause admission and suspend every live stream of the
  primary's generative unit at its next sync point, then ship each suspend
  record, a handoff frame, to the peer's ``/disagg/import`` with the
  scheduler's seed counter (``x-sct-drain-seed``, which the peer adopts)
  and relay the peer's tokens through the original request, so its
  client sees one stream.  A stream the peer refuses re-parks and resumes
  here.  With no peer the records stay parked until ``POST
  /admin/undrain``.  A second drain answers 409 with the current drain's
  state; an undrain while a drain quiesces or migrates answers 409.
* ``GET /stats/chaos``: the chaos plane's arrivals and firings
  (``SCT_CHAOS_PLAN``; its sites here are ``disagg.handoff.send`` and
  ``disagg.prefix.pull``).

Outbound calls to peers use asyncio streams (``SCT_DISAGG_TIMEOUT_S``,
default 30 s).

The request planes, in the JAX engine's order.  A predictions request is
parsed, looked up in the exact response tier (``SCT_CACHE=1``: an
unchanged body, keys and whitespace aside, is answered with the cached
bytes and ``x-sct-cache: hit``), then in the semantic tier
(``SCT_SEMCACHE=1``: a single-prompt generative body whose pooled
embedding is within ``SCT_SEMCACHE_SIM`` of a cached one made with the
same options, ``x-sct-cache: semantic``), both only when every unit of
the graph is deterministic and both before admission: a hit takes no
admission slot and no device step.  A miss is admitted by the
:class:`~seldon_core_tpu_torch.qos.AdmissionController` (``SCT_QOS_*``:
a 429 with ``Retry-After`` when the caps, the rate limit, a brownout or
a predicted deadline miss shed it; a 504 when its deadline has already
passed), then identical requests in flight together are collapsed into
one graph walk, and the reply fills both tiers.  The stream and
embeddings routes are admitted too; a request's ticket is released once,
on its reply, its error or its client leaving.  ``GET /stats/qos``,
``/stats/cache``, ``/stats/usage`` (the usage meter), ``/stats/spans``
and ``/stats/breakdown`` (per-stage latency and each generative unit's
snapshot) serve the planes' state.

The telemetry plane, with the JAX engine's routes and payloads: every
reply of a traced request echoes its trace id in ``x-sct-trace-id`` (a
request without a ``traceparent`` gets a fresh root trace), and its spans
go to the exporters (``SCT_OTLP_ENDPOINT``: OTLP/HTTP JSON, bounded and
drop-on-full).  ``GET /prometheus`` is the metric families of
``utils/metrics.py`` (text 0.0.4, or OpenMetrics with trace-id exemplars
under ``SCT_METRICS_EXEMPLARS=1``), the KV pool and usage families
refreshed at the scrape; ``GET /stats/wire`` each transport edge's bytes
(this front is ``engine-rest``, hops to remote units ``engine-node``),
the event loop's lag and the host syncs by model; ``GET /stats/warmup``
each unit's warm-up runs, seconds and programs, ``warmed``, ``error`` and
``total_seconds``; ``GET /stats/summary`` the qos, breakdown, cache, wire
and usage payloads and the mergeable stage histograms in one scrape;
``GET /stats/timeline?trace=<id>`` every lifecycle timeline of a trace
(``?n=`` the newest, ``SCT_TIMELINE=0`` turns them off).  ``POST
/profile/start`` (``{"dir": path}``) and ``POST /profile/stop`` run
``torch.profiler`` (CUDA activity too on the card) and write a Chrome
trace into the directory at the stop: 409 for a second start or a stop
with none running, 500 when the directory cannot be made.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os
import random
import tempfile
import time
import urllib.parse

import numpy as np

from seldon_core_tpu_torch import chaos, disagg, qos, resolve_device
from seldon_core_tpu_torch.cache import canonical_body, request_key, semantic_tag
from seldon_core_tpu_torch.cache.prefix import adapter_salt
from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    feedback_from_dict,
    payload_from_dict,
    payload_to_dict,
)
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.disagg.handoff import (
    HandoffError,
    apply_handoff,
    build_handoff_frame,
    check_pool,
    decode_handoff,
    decode_prefix_chain,
    encode_prefix_chain,
)
from seldon_core_tpu_torch.engine.service import (
    PredictionService,
    load_co_predictor_specs,
    load_predictor_spec,
)
from seldon_core_tpu_torch.executor.arbiter import get_arbiter
from seldon_core_tpu_torch.executor.generation import AdapterUnavailable
from seldon_core_tpu_torch.executor.memory import device_memory, host_memory
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.obs import (
    LOOP_LAG,
    METER,
    RECORDER,
    STAGE_ENGINE_ROUTE,
    TIMELINE,
    WIRE,
    WIRE_ENGINE_REST,
    close_exporters,
    configure_exporters_from_env,
    set_engine_role,
    set_process_role,
    wire_stats_payload,
)
from seldon_core_tpu_torch.obs.spans import (
    TRACE_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    current_trace_id,
    outgoing_headers,
    set_traceparent,
)
from seldon_core_tpu_torch.utils.loops import tune_server_loop
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS
from seldon_core_tpu_torch.qos.admission import QosRejection, QueueFull
from seldon_core_tpu_torch.wire.h1server import (
    MAX_BODY,
    BadRequest,
    keep_alive,
    read_request,
    request_json,
    response,
)

log = logging.getLogger(__name__)

MAX_FRAME_BODY = 1 << 30  # a handoff frame: 64 MiB for a 2048-token llama3-1b prompt
DISCONNECT_POLL_S = 0.05  # how often a request in flight checks its client is there


def _body_limit(path: str) -> int:
    return MAX_FRAME_BODY if path == "/disagg/import" else MAX_BODY


async def http_post(target: str, path: str, body: bytes, ctype: str, timeout: float,
                    headers: dict[str, str] | None = None) -> tuple[int, dict[str, str], bytes]:
    """POST ``body`` (with ``headers`` besides the framing ones) to
    ``http://target/path`` over one asyncio connection (closed after the
    reply) -> ``(status, headers, body)``."""
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())

    async def go():
        host, _, port = target.rpartition(":")
        reader, writer = await asyncio.open_connection(host or "127.0.0.1", int(port))
        try:
            writer.write((f"POST {path} HTTP/1.1\r\nHost: {target}\r\n"
                          f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
                          f"{extra}Connection: close\r\n\r\n").encode("latin-1"))
            writer.write(body)
            await writer.drain()
            status_line = await reader.readline()
            try:
                status = int(status_line.split(b" ", 2)[1])
            except (IndexError, ValueError):
                raise ConnectionError(f"bad status line from {target}: {status_line!r}") from None
            headers: dict[str, str] = {}
            while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            if "content-length" in headers:
                data = await reader.readexactly(int(headers["content-length"]))
            else:
                data = await reader.read()
            return status, headers, data
        finally:
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()

    return await asyncio.wait_for(go(), timeout)


def _json(status: int, obj: dict) -> tuple[int, bytes, str]:
    return status, json.dumps(obj).encode(), "application/json"


def _event(obj: dict) -> bytes:
    """One server-sent event carrying ``obj`` as JSON."""
    return f"data: {json.dumps(obj)}\n\n".encode()


class _EventStream:
    """A route's ``text/event-stream`` reply: ``groups`` yields lists of
    token ids as they are delivered; ``ticket`` is the request's admission,
    released when the stream ends.  It is written from the task that ran
    the route: the first iteration submits the request, and the scheduler
    reads its deadline and priority from that task's context."""

    def __init__(self, groups, ticket):
        self.groups = groups
        self.ticket = ticket


class EngineApp:
    """The engine's HTTP front over one :class:`PredictionService`, with
    ``co_services`` booted beside it on the same card (chip packing).
    ``role`` and ``decode_upstreams`` default to ``SCT_ENGINE_ROLE`` and
    ``SCT_DISAGG_DECODE``; an unknown role raises ``ValueError``."""

    def __init__(self, service: PredictionService, *, role: str | None = None,
                 decode_upstreams: list[str] | None = None,
                 qos_controller: qos.AdmissionController | None = None,
                 co_services: list[PredictionService] | None = None):
        self.service = service
        # the deployments packed beside the primary: their generative units
        # register with the device arbiter at boot and time-share the card
        self.co_services = list(co_services or [])
        # the drain this app is running (phase, peer, progress), None when
        # none is: /admin/drain's 409 carries it
        self._drain_state: dict | None = None
        # admission control (SCT_QOS_*, on by default), registered
        # process-wide so the schedulers' brownout clamp and deadline drops
        # reach the same policy
        self.qos = (qos_controller if qos_controller is not None
                    else qos.AdmissionController.from_env(service.deployment_name))
        qos.set_active_controller(self.qos)
        # the response tiers, bound at boot when the whole graph is
        # deterministic (one random router makes a reply uncacheable)
        self._resp_cache = None
        self._sem_cache = None
        self.ready = False
        self.paused = False
        # the SSE route's ledger: streams served, token events and the
        # writes that carried them (one per delivered group), streams whose
        # client left before the end
        self.stream_stats = {"streams": 0, "events": 0, "writes": 0, "disconnects": 0}
        self.boot_error: str | None = None
        # unit name -> warm-up runs: a JAX_MODEL unit's captured buckets, a
        # generative unit's warm-up runs
        self.warmup_report: dict[str, int] = {}
        self._server: asyncio.base_events.Server | None = None
        # the Seldon gRPC service beside the REST front, when start() got a port
        self.grpc_server = None
        # keep-alive connections waiting for their next request: close()
        # ends them, as the server's wait_closed() waits for every
        # connection (a pooled client's idle socket would hold it forever)
        self._idle_conns: set[asyncio.StreamWriter] = set()
        self._closing = False
        self.role = disagg.resolve_role(role)
        self.decode_upstreams = (list(decode_upstreams) if decode_upstreams is not None
                                 else disagg.decode_upstreams())
        self._handoff_timeout_s = float(os.environ.get("SCT_DISAGG_TIMEOUT_S", "30") or 30.0)
        self._handoff_inflight: dict[str, int] = {}
        # the handoff ledger (seconds and bytes summed over handoffs) and
        # the peer pull ledger; a pull's failure only costs the shortcut
        self.disagg_stats = {
            "handoffs_ok": 0, "handoffs_failed": 0, "local_fallbacks": 0,
            "imports_ok": 0, "imports_failed": 0, "handoff_bytes": 0,
            "export_s": 0.0, "import_decode_s": 0.0,
        }
        self.prefix_pull_stats = {
            "pulls_ok": 0, "pulls_failed": 0, "pull_misses": 0, "pull_bytes": 0,
            "pull_blocks": 0, "serves_ok": 0, "serve_misses": 0,
        }
        # the telemetry plane: the process's registry, this front's wire
        # edge, the warmup's wall seconds, and the profiler /profile/* runs
        self.metrics = DEFAULT_METRICS
        self._wire = WIRE.counter(WIRE_ENGINE_REST, service.deployment_name)
        self._warmup_total_s: float | None = None
        self._planes = False  # start() took the lag probe and the exporters
        self._profiler = None
        self._profile_dir: str | None = None

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    @property
    def grpc_port(self) -> int | None:
        return self.grpc_server.bound_port if self.grpc_server is not None else None

    async def start(self, host: str, port: int, *, grpc_port: int | None = None,
                    reuse_port: bool = False) -> None:
        """Listen (``/ping`` answers from here on), with the span exporters
        the environment selects, this engine's role on spans recorded off a
        request, and the event loop's lag probe.  ``grpc_port`` also starts
        the primary deployment's Seldon gRPC service (``engine/grpc_app.py``,
        0 for any free port); ``reuse_port`` shares both ports with the
        other worker processes (SO_REUSEPORT).  A gRPC port that does not
        bind fails the start (a gRPC-only client must not meet refusals from
        a ready engine) unless ``ENGINE_GRPC_OPTIONAL=1``, which serves REST
        alone."""
        configure_exporters_from_env()
        set_process_role(self.role)
        self._server = await asyncio.start_server(self._handle, host, port,
                                                  reuse_port=reuse_port or None)
        LOOP_LAG.start("engine")
        self._planes = True
        if grpc_port is not None:
            from seldon_core_tpu_torch.engine.grpc_app import start_engine_grpc

            try:
                self.grpc_server = await start_engine_grpc(
                    self.service, grpc_port, reuse_port=reuse_port,
                    host=None if host in ("0.0.0.0", "::", "") else host)
            except Exception as e:
                if os.environ.get("ENGINE_GRPC_OPTIONAL") == "1":
                    log.warning("gRPC server not started (optional): %s", e)
                    return
                await self.close()
                raise

    async def boot(self) -> None:
        """Build the graph's units off the event loop (loading a model
        blocks), then warm them; ``/ready`` turns true after."""
        t0 = time.perf_counter()
        try:
            await asyncio.to_thread(self.service.start)
            for svc in self.co_services:
                await asyncio.to_thread(svc.start)
            self._register_packed_units()
            if self.service.graph_deterministic():
                self._resp_cache = self.service.response_cache
                self._sem_cache = self.service.semantic_cache
            self.warmup_report = await self.service.warmup()
            for svc in self.co_services:
                # each co-tenant warms (captures) its own graphs before
                # readiness, in turn: no capture meets a co-tenant's traffic
                report = await svc.warmup()
                self.warmup_report.update({f"{svc.deployment_name}/{k}": v
                                           for k, v in report.items()})
            log.info("warmup: %s (seconds %s)", self.warmup_report,
                     self.service.walker.warmup_seconds)
        except Exception as e:
            self.boot_error = f"{type(e).__name__}: {e}"
            raise
        self._warmup_total_s = round(time.perf_counter() - t0, 3)
        self.ready = True

    def _register_packed_units(self) -> None:
        """Attach every generative unit of the primary and the co-resident
        deployments to the process's device arbiter, when there are
        co-resident deployments: a sole engine keeps the fast path."""
        if not self.co_services:
            return
        for svc in (self.service, *self.co_services):
            for unit in svc.generative_units():
                unit.register_packed()

    async def close(self) -> None:
        planes, self._planes = self._planes, False
        if planes:
            LOOP_LAG.stop()
        if self._profiler is not None:
            with contextlib.suppress(Exception):
                self._profiler.stop()
            self._profiler = self._profile_dir = None
        grpc_server, self.grpc_server = self.grpc_server, None
        if grpc_server is not None:
            await grpc_server.stop(grace=2.0)
        if self._server is not None:
            self._closing = True
            self._server.close()
            for w in list(self._idle_conns):
                w.close()
            await self._server.wait_closed()
        if planes:
            await close_exporters()
        for svc in self.co_services:
            await svc.close()
        await self.service.close()
        if qos.active_controller() is self.qos:
            qos.set_active_controller(None)

    async def _route(self, method: str, path: str, body: bytes,
                     headers: dict[str, str], query: str = "") -> tuple:
        """-> ``(status, body, content type)``, plus a dict of extra
        response headers where a route sets some."""
        qos.seed_from_headers(headers.get(qos.DEADLINE_HEADER), headers.get(qos.PRIORITY_HEADER))
        set_traceparent(headers.get(TRACEPARENT_HEADER))
        set_engine_role(self.role)
        if path.startswith("/disagg/") or path == "/stats/disagg":
            return await self._disagg_route(method, path, body, headers)
        if path == "/ping":
            return 200, b"pong", "text/plain"
        if path == "/ready":
            if self.paused:
                return 503, b"paused", "text/plain"
            if self.ready:
                return 200, b"ready", "text/plain"
            if self.boot_error:
                return 503, f"boot failed: {self.boot_error}".encode(), "text/plain"
            return 503, b"warming", "text/plain"
        if path in ("/pause", "/unpause"):
            self.paused = path == "/pause"
            return 200, (b"paused" if self.paused else b"unpaused"), "text/plain"
        if path == "/api/v0.1/predictions":
            if method != "POST":
                return _json(405, failure_status_dict(405, "POST a SeldonMessage"))
            return await self._predictions(body, headers)
        if path == "/api/v0.1/predictions/stream":
            if method != "POST":
                return _json(405, failure_status_dict(405, "POST a generate body"))
            try:
                ticket = self._admit(headers)
            except QosRejection as e:
                return self._qos_reject(e)
            reply = None
            try:
                reply = await self._predictions_stream(body, headers, ticket)
                return reply
            finally:  # an event stream releases it when it ends
                if not isinstance(reply, _EventStream):
                    ticket.release()
        if path in ("/api/v0.1/feedback", "/api/v1.0/feedback"):
            if method != "POST":
                return _json(405, failure_status_dict(405, "POST a Feedback message"))
            return await self._feedback(body, headers)
        if path == "/api/v0.1/embeddings":
            if method != "POST":
                return _json(405, failure_status_dict(405, "POST a tokens body"))
            return await self._admitted(self._embeddings, headers, body, headers)
        if path in ("/admin/drain", "/admin/undrain"):
            if method != "POST":
                return _json(405, failure_status_dict(405, f"POST to {path}"))
            if path == "/admin/drain":
                return await self._admin_drain(body)
            return self._admin_undrain()
        if path == "/prometheus":
            return self._prometheus()
        if path == "/stats/timeline":
            return _json(200, self._timeline(urllib.parse.parse_qs(query)))
        if path in ("/profile/start", "/profile/stop"):
            if method != "POST":
                return _json(405, failure_status_dict(405, f"POST to {path}"))
            if path == "/profile/start":
                return self._profile_start(body)
            return await self._profile_stop()
        if path in self._STATS:
            return _json(200, self._STATS[path](self))
        return _json(404, failure_status_dict(404, f"no route {path}"))

    # ------------------------------------------------------ telemetry plane

    def _prometheus(self) -> tuple:
        """The registry's exposition, after a scrape-time refresh of the KV
        pool gauges (host bookkeeping, no device sync) and the usage
        families; OpenMetrics with exemplars under SCT_METRICS_EXEMPLARS."""
        for svc in (self.service, *self.co_services):
            for unit in (svc.generative_units() if svc.walker is not None else []):
                unit.model.pool_snapshot()
        self.metrics.refresh_usage()
        return 200, self.metrics.expose(), self.metrics.expose_content_type()

    @staticmethod
    def _timeline(q: dict) -> dict:
        """``?trace=<id>``: every entry of that trace (a handoff's prefill
        and decode legs apart); else the newest ``n`` (default 20, at most
        200) and the ledger's counters."""
        trace = (q.get("trace") or [""])[0]
        if trace:
            return {"timeline": TIMELINE.by_trace(trace)}
        try:
            n = int((q.get("n") or ["20"])[0])
        except ValueError:
            n = 20
        return {"timeline": TIMELINE.recent(max(1, min(n, 200))), **TIMELINE.snapshot()}

    def _warmup_payload(self) -> dict:
        snap = self.service.warmup_snapshot()
        snap.update(warmed=self.ready, error=self.boot_error,
                    total_seconds=self._warmup_total_s)
        return {"warmup": snap}

    def _summary(self) -> dict:
        """One scrape for a fleet collector: the qos, breakdown, cache,
        wire and usage payloads and the mergeable stage histograms."""
        return {
            "qos": self.qos.snapshot(),
            "breakdown": self._breakdown(),
            "cache": self._cache_payload(),
            "wire": wire_stats_payload(),
            "usage": METER.snapshot(),
            "stage_hist": RECORDER.stage_histograms(),
        }

    def _cache_payload(self) -> dict:
        return {**self.service.cache_snapshot(), "prefix_pull": dict(self.prefix_pull_stats)}

    def _profile_start(self, body: bytes) -> tuple:
        """Start ``torch.profiler`` (CPU activity, and CUDA's on the card)
        into ``dir`` (default ``$TMPDIR/sct-profile``); 409 while one runs,
        500 when the directory cannot be made.  Start it on a warmed
        engine: every CUDA graph is captured at warmup, and a capture under
        the profiler would record the capture's kernels once, not the
        replays."""
        try:
            obj = json.loads(body) if body.strip() else {}
        except ValueError:
            obj = {}
        out_dir = (obj.get("dir") if isinstance(obj, dict) else None) or os.path.join(
            tempfile.gettempdir(), "sct-profile")
        if self._profiler is not None:
            return _json(409, {"error": "profiler already running", "dir": self._profile_dir})
        try:
            os.makedirs(out_dir, exist_ok=True)
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if str(self.service.device).startswith("cuda"):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 - the operator's bad path: a 500
            return _json(500, {"error": f"{type(e).__name__}: {e}"})
        self._profiler, self._profile_dir = prof, out_dir
        return _json(200, {"status": "profiling", "dir": out_dir})

    async def _profile_stop(self) -> tuple:
        """Stop the profiler (on the thread that started it) and write its
        Chrome trace into the directory (``trace-<pid>-<ms>.json``) off the
        event loop: a served wave's trace is tens of MB.  409 when none
        runs."""
        if self._profiler is None:
            return _json(409, {"error": "profiler not running"})
        prof, out_dir = self._profiler, self._profile_dir
        self._profiler = self._profile_dir = None
        path = os.path.join(out_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
        prof.stop()
        await asyncio.to_thread(prof.export_chrome_trace, path)
        return _json(200, {"status": "stopped", "dir": out_dir, "trace": path})

    # ------------------------------------------------------------ QoS plane

    def _admit(self, headers: dict[str, str]):
        """Seed the request's deadline and priority from its headers and pass
        admission: a ticket, or a :class:`QosRejection`.  With the
        controller off the request carries no deadline and no priority."""
        if not self.qos.enabled:
            qos.seed_from_headers(None, None)
            return self.qos.admit()
        budget_ms, priority = qos.seed_from_headers(
            headers.get(qos.DEADLINE_HEADER), headers.get(qos.PRIORITY_HEADER))
        if budget_ms is None and self.qos.default_deadline_ms:
            budget_ms = self.qos.default_deadline_ms
            qos.set_budget_ms(budget_ms)
        return self.qos.admit(priority, budget_s=budget_ms / 1e3 if budget_ms else None)

    def _qos_reject(self, e: QosRejection) -> tuple:
        """A shed as its reply: 429 with ``Retry-After``, or 504; the reason
        lands on a span."""
        with RECORDER.span("qos.shed", service=self.service.deployment_name) as sp:
            if sp is not None:
                sp.set_attr("reason", e.reason)
                sp.set_attr("code", e.status)
                sp.set_status("ERROR")
        extra = {"Retry-After": e.retry_after_header()} if e.status == 429 else {}
        return (e.status, json.dumps(failure_status_dict(e.status, str(e))).encode(),
                "application/json", extra)

    async def _admitted(self, handler, headers: dict[str, str], *args) -> tuple:
        """Run ``handler(*args)`` under an admission ticket, released when it
        returns, raises or is cancelled (its client left)."""
        try:
            ticket = self._admit(headers)
        except QosRejection as e:
            return self._qos_reject(e)
        try:
            return await handler(*args)
        except QosRejection as e:  # a queue below admission: 429, or 504 from the queue
            return self._qos_reject(e)
        finally:
            ticket.release()

    _STATS = {
        "/stats/qos": lambda self: {"qos": self.qos.snapshot()},
        "/stats/cache": lambda self: {"cache": self._cache_payload()},
        "/stats/usage": lambda self: {"usage": METER.snapshot()},
        "/stats/wire": lambda self: wire_stats_payload(),
        "/stats/warmup": lambda self: self._warmup_payload(),
        "/stats/summary": lambda self: self._summary(),
        "/stats/spans": lambda self: RECORDER.stats(),
        "/stats/breakdown": lambda self: self._breakdown(),
        "/stats/chaos": lambda self: {"chaos": chaos.snapshot()},
    }

    def _breakdown(self) -> dict:
        """Per-stage latency and each generative unit's snapshot with its
        packing ledger (a co-resident deployment's units under
        ``deployment/model``); on a packed card also the arbiter's ledger
        and the card's and the host's byte ledgers."""
        gen = {}
        for svc in (self.service, *self.co_services):
            units = svc.generative_units() if svc.walker is not None else []
            for unit in units:
                snap = unit.model.spec_snapshot()
                snap["packing"] = unit.scheduler.packing_snapshot()
                key = unit.model.name if svc is self.service else (
                    f"{svc.deployment_name}/{unit.model.name}")
                gen[key] = snap
        out = {"stages": RECORDER.breakdown(), "generation": gen}
        if self.co_services:
            out["packing"] = get_arbiter().snapshot()
            out["memory"] = {"hbm": device_memory(self.service.device).snapshot(),
                             "host": host_memory().snapshot()}
        return out

    async def _predictions_stream(self, body: bytes, headers: dict[str, str], ticket):
        """Validate an admitted stream request (every failure is a JSON
        error reply, before any header goes out) and return the
        :class:`_EventStream` that serves it under ``ticket``."""
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        unit, reason = self._single_generative_unit()
        if unit is None:
            return _json(400, failure_status_dict(400, reason))
        try:
            prompt, max_new, temperature, eos, adapter = self._parse_generate_body(
                body, unit, headers)
            unit.model.check_adapter(adapter)
        except (CodecError, GraphUnitError) as e:
            return _json(400, failure_status_dict(400, f"bad stream request: {e}"))
        peer = headers.get("x-sct-prefix-peer")
        if peer and self._peer_pull_enabled():
            await self._maybe_pull_prefix(unit, prompt, peer, headers.get("x-sct-prefix-depth"),
                                          adapter)
        return _EventStream(unit.stream_groups(prompt, max_new_tokens=max_new,
                                               temperature=temperature, eos_id=eos,
                                               adapter=adapter), ticket)

    async def _send_events(self, writer: asyncio.StreamWriter, stream: "_EventStream") -> None:
        """Write an event stream: the headers, one write per delivered
        group of tokens, the closing event.  The connection closes after
        it (the body ends there: no length, no chunking)."""
        with stream.ticket:  # released when the stream ends, however it ends
            tid = current_trace_id()
            echo = f"{TRACE_RESPONSE_HEADER}: {tid}\r\n".encode() if tid else b""
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\nX-Accel-Buffering: no\r\n" + echo
                         + b"Connection: close\r\n\r\n")
            self.stream_stats["streams"] += 1
            out: list[int] = []
            async with contextlib.aclosing(stream.groups) as groups:
                try:
                    await writer.drain()
                    try:
                        async for group in groups:
                            out.extend(group)
                            writer.write(b"".join(_event({"token": t}) for t in group))
                            self.stream_stats["events"] += len(group)
                            self.stream_stats["writes"] += 1
                            await writer.drain()
                        final = {"done": True, "tokens": out}
                    except ConnectionError:
                        raise
                    except Exception as e:  # noqa: BLE001 - the headers are gone: on the stream
                        log.warning("token stream failed: %s: %s", type(e).__name__, e)
                        final = {"error": f"{type(e).__name__}: {e}"}
                    writer.write(_event(final))
                    await writer.drain()
                except ConnectionError:
                    self.stream_stats["disconnects"] += 1

    async def _predictions(self, body: bytes, headers: dict[str, str]) -> tuple:
        """Parse, the exact tier, the semantic tier, admission, then one
        graph walk (collapsed with identical requests in flight) whose
        reply fills the tiers."""
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        dep = self.service.deployment_name
        with RECORDER.span("engine.predictions", service=dep, stage=STAGE_ENGINE_ROUTE) as sp:
            try:
                obj = request_json(body, headers)
            except CodecError as e:
                return _json(400, failure_status_dict(400, str(e)))
            cache_key = sem = None
            if self._resp_cache is not None:
                cache_key = request_key("predictions", self.service.spec_hash,
                                        canonical_body(obj))
                entry = self._resp_cache.get(dep, cache_key)
                if entry is not None:
                    if sp is not None:
                        sp.event("cache.hit", tier="engine")
                    return 200, entry.value, "application/json", {"x-sct-cache": "hit"}
            if self._sem_cache is not None:
                sem = await self._semantic_key(obj)
                hit = self._sem_cache.lookup(dep, *sem) if sem is not None else None
                if hit is not None:
                    if sp is not None:
                        sp.event("cache.hit", tier="semantic")
                    return 200, hit, "application/json", {"x-sct-cache": "semantic"}
            return await self._admitted(self._walk_and_fill, headers, obj, headers,
                                        cache_key, sem)

    async def _walk_and_fill(self, obj, headers: dict[str, str], cache_key: str | None,
                             sem: tuple | None) -> tuple:
        """An admitted predictions request: one graph walk (shared with the
        identical requests in flight when the exact tier is on), and its
        reply into the tiers."""
        dep = self.service.deployment_name
        try:
            payload = payload_from_dict(obj)
            await self._pull_prefix_from_header(payload, headers)
            if cache_key is not None:
                raw = await self.service.collapse.do(
                    cache_key, lambda: self._predict_json_bytes(payload))
                self._resp_cache.put(dep, cache_key, raw)
            else:
                raw = await self._predict_json_bytes(payload)
        except (CodecError, AdapterUnavailable) as e:
            return _json(400, failure_status_dict(400, str(e)))
        except GraphUnitError as e:
            return _json(500, failure_status_dict(500, str(e)))
        except asyncio.CancelledError:
            if asyncio.current_task().cancelling():
                raise  # this request's own client left
            # the request this one was collapsed into lost its client
            return _json(503, failure_status_dict(
                503, "the identical request this one waited on was cancelled; retry"))
        if sem is not None:
            self._sem_cache.put(dep, sem[0], raw, sem[1])
        return 200, raw, "application/json"

    async def _predict_json_bytes(self, payload: Payload) -> bytes:
        """One graph walk -> the reply's JSON bytes (what the tiers store and
        the collapser shares)."""
        out = await self.service.predict(payload)
        resp = payload_to_dict(out)
        resp["status"] = {"code": 200, "status": "SUCCESS"}
        return json.dumps(resp).encode()

    async def _semantic_key(self, obj) -> tuple | None:
        """``(pooled embedding, tag)`` of a single-prompt generative body, or
        None when the body does not qualify (not strData, a batch of
        prompts, no embedding unit).  An embed failure is a miss: the tier
        never fails a request it could have missed."""
        raw = obj.get("strData") if isinstance(obj, dict) else None
        if not isinstance(raw, str):
            return None
        try:
            inner = json.loads(raw)
        except ValueError:
            return None
        prompt = inner.get("tokens") if isinstance(inner, dict) else None
        if not isinstance(prompt, list) or not prompt or isinstance(prompt[0], list):
            return None
        unit = next((u for u in self._generative_units() if u.model.embed_enabled), None)
        if unit is None:
            return None
        try:
            vec = (await unit.embed_rows([np.asarray(prompt, np.int32)]))[0]
        except Exception:  # noqa: BLE001 - a miss, never a failed request
            log.debug("semantic tier: embedding failed; a miss", exc_info=True)
            return None
        return vec, semantic_tag(self.service.spec_hash, obj, inner)

    async def _feedback(self, body: bytes, headers: dict[str, str]) -> tuple[int, bytes, str]:
        """Replay a Feedback message's routed path with its reward."""
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        try:
            fb = feedback_from_dict(request_json(body, headers))
            await self.service.send_feedback(fb)
        except (CodecError, KeyError, ValueError) as e:
            return _json(400, failure_status_dict(400, str(e)))
        except GraphUnitError as e:
            return _json(500, failure_status_dict(500, str(e)))
        return _json(200, {"status": {"code": 200, "status": "SUCCESS"}})

    async def _embeddings(self, body: bytes, headers: dict[str, str]) -> tuple[int, bytes, str]:
        """Mean-pooled final hidden states from the graph's first generative
        unit with ``embed`` on (its own weights), each row through its
        scheduler; a ``(B, E)`` float32 ``rawTensor``."""
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        try:
            obj = request_json(body, headers)
            if isinstance(obj, dict) and "strData" in obj:
                obj = json.loads(obj["strData"])
            rows_in = obj.get("tokens") if isinstance(obj, dict) else None
            if not isinstance(rows_in, (list, tuple)) or not rows_in:
                raise CodecError("embeddings takes 'tokens': a flat list or a batch of lists")
            if not isinstance(rows_in[0], (list, tuple)):
                rows_in = [rows_in]
            rows = [np.asarray(r, np.int32) for r in rows_in]
        except (CodecError, TypeError, ValueError) as e:
            return _json(400, failure_status_dict(400, str(e)))
        unit = next((u for u in self._generative_units() if u.model.embed_enabled), None)
        if unit is None:
            return _json(400, failure_status_dict(
                400, "no embedding-capable generative unit in this graph (set the "
                     "generative unit's embed parameter, or SCT_EMBED=1)"))
        try:  # an empty row, ids outside the vocab or a row of max_seq ids
            rows = [unit.scheduler._validate_prompt(r) for r in rows]
        except GraphUnitError as e:
            return _json(400, failure_status_dict(400, str(e)))
        try:
            vecs = await unit.embed_rows(rows)
        except GraphUnitError as e:
            return _json(500, failure_status_dict(500, str(e)))
        resp = payload_to_dict(Payload(vecs, [], DataKind.RAW))
        resp["status"] = {"code": 200, "status": "SUCCESS"}
        return _json(200, resp)

    # -------------------------------------------- disaggregated prefill/decode

    def _generative_units(self) -> list:
        return self.service.generative_units() if self.service.walker is not None else []

    def _single_generative_unit(self):
        """``(unit, None)`` for a graph with exactly one generative unit, else
        ``(None, reason)``: a token stream and a handoff serve one unit."""
        units = self._generative_units()
        if len(units) == 1:
            return units[0], None
        if not units:
            return None, "the graph has no generative unit"
        return None, f"ambiguous: the graph has {len(units)} generative units"

    async def _disagg_route(self, method: str, path: str, body: bytes,
                            headers: dict[str, str]) -> tuple:
        if path == "/stats/disagg":
            return _json(200, {"disagg": {
                "role": self.role, "decode_upstreams": list(self.decode_upstreams),
                "handoff_inflight": dict(self._handoff_inflight), **self.disagg_stats,
                "prefix_pull": dict(self.prefix_pull_stats),
            }})
        routes = {"/disagg/generate": self._disagg_generate, "/disagg/import": self._disagg_import,
                  "/disagg/prefix/pull": self._disagg_prefix_pull}
        if path not in routes:
            return _json(404, failure_status_dict(404, f"no route {path}"))
        if method != "POST":
            return _json(405, failure_status_dict(405, f"POST to {path}"))
        if path == "/disagg/import" and self.role == disagg.ROLE_PREFILL:
            return _json(409, failure_status_dict(
                409, "a prefill-role engine does not import KV handoffs"))
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        unit, reason = self._single_generative_unit()
        if unit is None:
            return _json(400, failure_status_dict(400, reason))
        if path == "/disagg/prefix/pull":  # serves KV bytes, takes no slot
            return await routes[path](unit, body, headers)
        return await self._admitted(routes[path], headers, unit, body, headers)

    @staticmethod
    def _parse_generate_body(body: bytes, unit, headers: dict[str, str]) -> tuple:
        """The generative strData contract (a JSON or form body) -> ``(prompt,
        max_new, temperature, eos, adapter)`` (the body's ``"adapter"``, else
        the unit's default); raises :class:`CodecError`."""
        try:
            obj = request_json(body, headers)
            if isinstance(obj, dict) and "strData" in obj:
                obj = json.loads(obj["strData"])
            prompt = obj.get("tokens")
            if (not isinstance(prompt, (list, tuple)) or not prompt
                    or isinstance(prompt[0], (list, tuple))):
                raise CodecError("disagg generate takes ONE prompt: a flat 'tokens' list")
            max_new = obj.get("max_new_tokens")
            max_new = int(max_new) if max_new is not None else unit.max_new_tokens
            temperature = obj.get("temperature")
            temperature = float(temperature) if temperature is not None else unit.temperature
            eos = obj.get("eos_id", unit.eos_id)
            return (np.asarray(prompt, np.int32), max_new, temperature,
                    int(eos) if eos is not None else None, unit.resolve_adapter(obj))
        except CodecError:
            raise
        except (ValueError, TypeError, AttributeError) as e:
            raise CodecError(f"bad generate body: {e}") from None

    async def _disagg_generate(self, unit, body: bytes, headers: dict[str, str]) -> tuple:
        """Prefill here and hand the KV to a decode peer (a prefill engine
        with peers and more than one token to make), else generate here."""
        try:
            prompt, max_new, temperature, eos, adapter = self._parse_generate_body(
                body, unit, headers)
            unit.model.check_adapter(adapter)
        except (CodecError, GraphUnitError) as e:
            return _json(400, failure_status_dict(400, str(e)))
        peer = headers.get("x-sct-prefix-peer")
        if peer and self._peer_pull_enabled():
            await self._maybe_pull_prefix(unit, prompt, peer, headers.get("x-sct-prefix-depth"),
                                          adapter)
        try:
            if self.role == disagg.ROLE_PREFILL and self.decode_upstreams and max_new > 1:
                tokens, mode = await self._prefill_and_handoff(unit, prompt, max_new,
                                                               temperature, eos, adapter)
            else:
                out = await unit.scheduler.submit(prompt, max_new_tokens=max_new,
                                                  temperature=temperature, eos_id=eos,
                                                  adapter=adapter)
                tokens, mode = [int(t) for t in out], disagg.ROLE_UNIFIED
        except QueueFull as e:
            return _json(429, failure_status_dict(429, str(e)))
        except GraphUnitError as e:
            return _json(500, failure_status_dict(500, str(e)))
        return _json(200, {"tokens": tokens, "mode": mode})

    async def _prefill_and_handoff(self, unit, prompt, max_new: int, temperature: float,
                                   eos: int | None, adapter: str | None = None
                                   ) -> tuple[list[int], str]:
        """Prefill (through ``adapter``) into a pinned slot, export and POST
        the handoff, relay the peer's tokens.  The slot is released whatever
        happens, and any failure decodes locally instead.  Spans, as the
        JAX engine's: ``disagg.prefill`` over the pinned prefill,
        ``handoff.export`` over the export and framing (the frame's
        ``traceparent`` is this span, so the decode engine's import span is
        its child) and ``handoff.relay`` over the POST and the relay."""
        sched = unit.scheduler
        dep = self.service.deployment_name
        with RECORDER.span("disagg.prefill", service=dep) as psp:
            slot, tok1 = await sched.submit_prefill(prompt, temperature=temperature,
                                                    adapter=adapter)
            if psp is not None:
                psp.set_attr("slot", slot)
        try:
            with RECORDER.span("handoff.export", service=dep) as esp:
                t0 = time.perf_counter()
                # the export runs in this span's context (to_thread copies
                # the context): the frame names this span as its origin
                frame = await asyncio.to_thread(
                    build_handoff_frame, unit.model, slot, prompt, tok1, max_new_tokens=max_new,
                    temperature=temperature, eos_id=eos)
                self.disagg_stats["export_s"] += time.perf_counter() - t0
                self.disagg_stats["handoff_bytes"] += len(frame)
                if esp is not None:
                    esp.set_attr("bytes", len(frame))
                TIMELINE.note(current_trace_id(), "handoff-export", bytes=len(frame), slot=slot)
            with RECORDER.span("handoff.relay", service=dep):
                tokens = await self._send_handoff(frame)
            self.disagg_stats["handoffs_ok"] += 1
            return tokens, "disagg"
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - the request falls back, never fails
            self.disagg_stats["handoffs_failed"] += 1
            TIMELINE.note(current_trace_id(), "handoff-failed", error=str(e)[:200])
            log.warning("KV handoff failed (%s: %s); decoding locally", type(e).__name__, e)
        finally:
            sched.release_external(slot)
        self.disagg_stats["local_fallbacks"] += 1
        out = await sched.submit(prompt, max_new_tokens=max_new, temperature=temperature,
                                 eos_id=eos, adapter=adapter)
        return [int(t) for t in out], "unified-fallback"

    async def _send_handoff(self, frame: bytes, *, target: str | None = None,
                            extra_headers: dict[str, str] | None = None) -> list[int]:
        """POST one frame to ``target``, by default a decode peer (the one
        configured, or the less busy of two picked at random), with the
        request's ``traceparent``, its QoS headers and ``extra_headers``,
        and return its tokens.
        The chaos site ``disagg.handoff.send`` may fail or tear the frame
        here."""
        if target is None:
            ups = self.decode_upstreams
            if len(ups) == 1:
                target = ups[0]
            else:
                a, b = random.sample(ups, 2)
                target = min((a, b), key=lambda u: self._handoff_inflight.get(u, 0))
        headers = {**outgoing_headers(), **qos.outgoing_qos_headers(), **(extra_headers or {})}
        if chaos.ENABLED:
            # a raise lands in the caller's fallback, a torn frame is refused
            # by the importer's codec check
            frame = await chaos.act("disagg.handoff.send", frame)
        self._handoff_inflight[target] = self._handoff_inflight.get(target, 0) + 1
        try:
            status, _, data = await http_post(target, "/disagg/import", frame,
                                              "application/octet-stream", self._handoff_timeout_s,
                                              headers)
        finally:
            self._handoff_inflight[target] -= 1
        if status != 200:
            raise RuntimeError(f"decode peer {target} answered {status}: {data[:200]!r}")
        return [int(t) for t in json.loads(data)["tokens"]]

    async def _disagg_import(self, unit, body: bytes, headers: dict[str, str]) -> tuple:
        """Import a prefill engine's handoff at the next sync point, decode
        to the end, answer the tokens (the first included)."""
        t0 = time.perf_counter()
        try:
            payload = await asyncio.to_thread(decode_handoff, body)
        except (ValueError, HandoffError) as e:
            self.disagg_stats["imports_failed"] += 1
            return _json(400, failure_status_dict(400, f"bad handoff frame: {e}"))
        self.disagg_stats["import_decode_s"] += time.perf_counter() - t0
        # the frame's traceparent (the prefill engine's export span) wins over
        # the header: the import and decode spans and the timeline stitch
        # under the original request even when a hop dropped the header
        frame_tp = payload.get("traceparent")
        if frame_tp:
            set_traceparent(str(frame_tp))
        drain_seed = headers.get("x-sct-drain-seed")
        if drain_seed is not None:
            # a drain's migration: the source's seed counter, so a sampled
            # stream goes on with the seeds its uninterrupted run would draw
            try:
                unit.scheduler.adopt_seed(int(drain_seed))
            except ValueError:
                return _json(400, failure_status_dict(400, "bad x-sct-drain-seed"))
        with RECORDER.span("disagg.import", service=self.service.deployment_name) as isp:
            if isp is not None:
                isp.set_attr("handoff.version", int(payload.get("hv", 1)))
                if payload.get("origin_span"):
                    isp.set_attr("origin_span_id", str(payload["origin_span"]))
            try:
                out = await apply_handoff(unit, payload)
            except (HandoffError, QueueFull, GraphUnitError) as e:
                self.disagg_stats["imports_failed"] += 1
                if isp is not None:
                    isp.set_status("ERROR")
                # a good frame for another pool: 409; a full queue: 429
                code = (409 if isinstance(e, HandoffError) else 429 if isinstance(e, QueueFull)
                        else 500)
                return _json(code, failure_status_dict(code, str(e)))
        self.disagg_stats["imports_ok"] += 1
        return _json(200, {"tokens": [int(t) for t in out]})

    async def _disagg_prefix_pull(self, unit, body: bytes, headers: dict[str, str]) -> tuple:
        """Serve the longest prefix chain this engine holds for the tokens,
        as a prefix-chain frame (404 when it holds none)."""
        try:
            req = request_json(body, headers)
            toks = req.get("tokens")
            if not (isinstance(toks, list) and toks
                    and all(isinstance(t, int) and not isinstance(t, bool) for t in toks)):
                raise ValueError("a prefix pull takes a flat 'tokens' list")
            max_blocks = int(req.get("max_blocks", 64))
            adapter = req.get("adapter")
            adapter = str(adapter) if adapter else None
        except (ValueError, TypeError, AttributeError) as e:
            return _json(400, failure_status_dict(400, str(e)))
        tokens = np.asarray(toks, np.int32)
        exported = await asyncio.to_thread(unit.model.export_prefix_kv, tokens, max_blocks,
                                           adapter)
        if exported is None:
            self.prefix_pull_stats["serve_misses"] += 1
            return _json(404, failure_status_dict(404, "no prefix chain for these tokens"))
        depth, k, v, k_scale, v_scale = exported
        frame = await asyncio.to_thread(encode_prefix_chain, tokens, k, v,
                                        block_size=unit.model.kv_block_size,
                                        k_scale=k_scale, v_scale=v_scale, adapter=adapter)
        self.prefix_pull_stats["serves_ok"] += 1
        return 200, frame, "application/octet-stream", {"x-sct-prefix-depth": str(int(depth))}

    @staticmethod
    def _peer_pull_enabled() -> bool:
        return os.environ.get("SCT_PREFIX_PEER_PULL", "0") == "1"

    async def _pull_prefix_from_header(self, payload, headers: dict[str, str]) -> None:
        """The predictions path's peer pull: with ``x-sct-prefix-peer`` set
        and pulls on, a strData request's flat prompt pulls its chain."""
        peer = headers.get("x-sct-prefix-peer")
        unit = self._single_generative_unit()[0] if peer and self._peer_pull_enabled() else None
        if unit is None or not isinstance(payload.data, str):
            return
        try:
            obj = json.loads(payload.data)
            toks = obj.get("tokens")
        except (ValueError, AttributeError):
            return
        if (isinstance(toks, list) and toks
                and all(isinstance(t, int) and not isinstance(t, bool) for t in toks)):
            await self._maybe_pull_prefix(unit, np.asarray(toks, np.int32), peer,
                                          headers.get("x-sct-prefix-depth"),
                                          unit.resolve_adapter(obj))

    async def _maybe_pull_prefix(self, unit, tokens, peer: str, depth_hint=None,
                                 adapter: str | None = None) -> bool:
        """Pull ``tokens``' prefix chain made through ``adapter`` from
        ``peer`` and install it at the next sync point, unless the local
        tiers already hold as deep a chain under that adapter's salt.  Any
        failure only counts in the ledger: the request then prefills as it
        would have (the chain enters the pool only through
        ``install_prefix_chain``, all or nothing)."""
        model = unit.model
        if model.prefix_index is None:
            return False
        tokens = np.asarray(tokens, np.int32).ravel()
        cap = min(tokens.size // model.kv_block_size, model.max_blocks_per_slot)
        if cap < 1:
            return False
        try:
            hint = int(depth_hint) if depth_hint else 0
        except (TypeError, ValueError):
            hint = 0
        salt = adapter_salt(adapter)
        have = model.prefix_index.peek_depth(tokens, cap, salt)
        if model.host_store is not None and have < cap:
            have = max(have, model.host_store.peek_depth(tokens, have + 1, cap, salt))
        if have >= cap or (hint and have >= hint):
            return False  # nothing a pull could add
        try:
            pull: dict = {"tokens": [int(t) for t in tokens], "max_blocks": int(cap)}
            if adapter:
                pull["adapter"] = adapter
            req = json.dumps(pull)
            if chaos.ENABLED:  # a raise costs the shortcut, as a failed pull does
                await chaos.act("disagg.prefix.pull")
            status, _, frame = await http_post(peer, "/disagg/prefix/pull", req.encode(),
                                               "application/json", self._handoff_timeout_s)
            if status == 404:  # the peer no longer holds it: a miss
                self.prefix_pull_stats["pull_misses"] += 1
                return False
            if status != 200:
                raise RuntimeError(f"peer {peer} answered {status}: {frame[:200]!r}")
            payload = await asyncio.to_thread(decode_prefix_chain, frame)
            check_pool(model, payload, "prefix chain")
            absorbed = await unit.scheduler.install_prefix(
                payload["tokens"], payload["k"], payload["v"],
                k_scale=payload.get("k_scale"), v_scale=payload.get("v_scale"), adapter=adapter)
            self.prefix_pull_stats["pulls_ok"] += 1
            self.prefix_pull_stats["pull_bytes"] += len(frame)
            self.prefix_pull_stats["pull_blocks"] += int(absorbed)
            TIMELINE.note(current_trace_id(), "prefix-pull", peer=peer, blocks=int(absorbed),
                          bytes=len(frame))
            return absorbed > 0
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - costs the shortcut, never the request
            self.prefix_pull_stats["pulls_failed"] += 1
            log.warning("peer prefix pull from %s failed (%s: %s); prefilling", peer,
                        type(e).__name__, e)
            TIMELINE.note(current_trace_id(), "prefix-pull-failed", peer=peer,
                          error=str(e)[:200])
            return False

    # ----------------------------------------------------------- live drain

    def _drain_snapshot(self, sched) -> dict:
        """The current drain for a 409: this app's drain (phase, peer,
        progress, elapsed ms), or a parked view when the drain was begun at
        the scheduler; with the records parked and the draining flag."""
        st = dict(self._drain_state or {})
        start = st.pop("started", None)
        if start is not None:
            st["elapsed_ms"] = round((time.monotonic() - start) * 1e3, 3)
        if not st:
            st = {"phase": "parked", "peer": None}
        snap = sched.packing_snapshot()
        st["parked"] = int(snap["suspended"])
        st["draining"] = bool(snap["draining"])
        return st

    async def _admin_drain(self, body: bytes) -> tuple:
        """``POST /admin/drain``: quiesce the primary's generative unit (every
        live stream suspended at its next sync point), then migrate each
        record to ``peer`` and relay its tokens, or, with no peer, keep
        them parked until ``/admin/undrain``."""
        unit, reason = self._single_generative_unit()
        if unit is None:
            return _json(400, failure_status_dict(400, reason))
        try:
            obj = json.loads(body) if body.strip() else {}
            if not isinstance(obj, dict):
                raise ValueError("a drain body is a JSON object")
            peer = str(obj["peer"]) if obj.get("peer") else None
            timeout_s = float(obj.get("timeout_s", 30.0))
        except (ValueError, TypeError) as e:
            return _json(400, failure_status_dict(400, f"bad drain body: {e}"))
        sched = unit.scheduler
        if self._drain_state is not None or sched._draining:
            # idempotent: a retry sees how far the drain in flight got
            return _json(409, {**failure_status_dict(409, "drain already in progress"),
                               "drain": self._drain_snapshot(sched)})
        t0 = time.perf_counter()
        self._drain_state = {"phase": "quiescing", "peer": peer, "timeout_s": timeout_s,
                             "migrated": 0, "failed": 0, "started": time.monotonic()}
        sched.drain_begin()
        try:
            quiesced = await sched.drain_wait_quiesced(timeout_s)
        except BaseException:
            self._drain_state = None  # no phantom drain to wedge later calls
            raise
        migrated, failed = 0, []
        if peer:
            self._drain_state["phase"] = "migrating"
            pairs = sched.drain_take()
            # one counter value for every frame: adopting it is idempotent
            seed = {"x-sct-drain-seed": str(sched._seed)}
            try:
                for req, frame in pairs:
                    try:
                        tokens = await self._send_handoff(frame, target=peer, extra_headers=seed)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:  # noqa: BLE001 - the stream resumes here
                        log.warning("drain: migrating a stream to %s failed (%s: %s); it "
                                    "resumes locally", peer, type(e).__name__, e)
                        failed.append((req, frame))
                        self._drain_state["failed"] = len(failed)
                        continue
                    sched.complete_migrated(req, tokens)
                    migrated += 1
                    self._drain_state["migrated"] = migrated
            finally:
                # whatever was not relayed (a cancel mid-loop too) re-parks,
                # then the drain lifts and the parked records resume here
                failed += pairs[migrated + len(failed):]
                if failed:
                    sched.drain_abort(failed)
                sched.drain_finish()
                self._drain_state = None
        else:
            self._drain_state["phase"] = "parked"
        snap = sched.packing_snapshot()
        return _json(200, {"quiesced": bool(quiesced), "peer": peer, "migrated": migrated,
                           "failed": len(failed), "parked": int(snap["suspended"]),
                           "draining": bool(snap["draining"]),
                           "duration_ms": round((time.perf_counter() - t0) * 1e3, 3)})

    def _admin_undrain(self) -> tuple:
        """``POST /admin/undrain``: lift a parked drain; the parked records
        re-queue as imports and go on bit-exactly."""
        unit, reason = self._single_generative_unit()
        if unit is None:
            return _json(400, failure_status_dict(400, reason))
        sched = unit.scheduler
        st = self._drain_state
        if st is not None and st["phase"] in ("quiescing", "migrating"):
            # lifting it now would fork the streams already relayed
            return _json(409, {**failure_status_dict(
                409, "drain in flight; undrain applies only after it parks or finishes"),
                "drain": self._drain_snapshot(sched)})
        if not sched._draining:
            return _json(409, failure_status_dict(409, "engine is not draining"))
        sched.drain_finish()
        self._drain_state = None
        return _json(200, {"draining": False, "resuming": True})

    # the routes timed in seldon_api_engine_server_requests_duration_seconds,
    # by the JAX engine's service names
    _SERVICES = {
        "/api/v0.1/predictions": "predictions", "/api/v1.0/predictions": "predictions",
        "/api/v0.1/predictions/stream": "predictions_stream",
        "/api/v0.1/embeddings": "embeddings", "/api/v0.1/feedback": "feedback",
        "/api/v1.0/feedback": "feedback", "/disagg/generate": "disagg_generate",
        "/disagg/import": "disagg_import", "/disagg/prefix/pull": "disagg_prefix_pull",
        "/admin/drain": "admin_drain", "/admin/undrain": "admin_undrain",
    }

    def _note_request(self, path: str, method: str, status: int, t0: float) -> None:
        service = self._SERVICES.get(path)
        if service is not None:
            self.metrics.server_requests.labels(
                self.service.deployment_name, self.service.predictor.name, service, method,
                str(status)).observe(time.perf_counter() - t0)

    @staticmethod
    async def _until_disconnect(reader: asyncio.StreamReader, coro):
        """Run a route in this task, and cancel it when the client closes the
        connection first (its scheduler withdraws the request, its
        admission ticket is released); None then.  A timer checks every
        ``DISCONNECT_POLL_S`` and reads nothing: a pipelined request stays
        buffered.  It sees only the end of the client's writes, so a client
        that half-closes its side after a whole request counts as gone and
        gets no reply."""
        loop, task = asyncio.get_running_loop(), asyncio.current_task()
        left = False

        def poll():
            nonlocal timer, left
            if reader.at_eof():
                left = True
                task.cancel()
            else:
                timer = loop.call_later(DISCONNECT_POLL_S, poll)

        timer = loop.call_later(DISCONNECT_POLL_S, poll)
        try:
            reply = await coro
        except asyncio.CancelledError:
            if left and task.uncancel() == 0:  # ours, not the server's
                return None
            raise
        finally:
            timer.cancel()
        if left:  # the route swallowed the cancel: the client is gone all the same
            task.uncancel()
            return None
        return reply

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while not self._closing:
                self._idle_conns.add(writer)
                try:
                    req = await read_request(reader, _body_limit)
                except BadRequest as e:
                    writer.write(response(e.status, str(e).encode(), "text/plain", False))
                    await writer.drain()
                    break
                finally:
                    self._idle_conns.discard(writer)
                if req is None:
                    break
                method, path, version, headers, body, query = req
                keep = keep_alive(version, headers)
                t0 = time.perf_counter()
                try:
                    reply = await self._until_disconnect(
                        reader, self._route(method, path, body, headers, query))
                    if reply is None:  # the client left: its request was cancelled
                        break
                    if isinstance(reply, _EventStream):
                        await self._send_events(writer, reply)
                        self._note_request(path, method, 200, t0)
                        break
                    status, payload, ctype, *extra = reply
                except Exception as e:  # noqa: BLE001 - the connection must get an answer
                    log.exception("request %s %s failed", method, path)
                    status, payload, ctype = _json(
                        500, failure_status_dict(500, f"{type(e).__name__}: {e}")
                    )
                    extra = []
                more = dict(extra[0]) if extra else {}
                tid = current_trace_id()
                if tid:
                    more[TRACE_RESPONSE_HEADER] = tid
                writer.write(response(status, payload, ctype, keep, more))
                await writer.drain()
                # the front's wire edge: request and reply bodies
                self._wire.record(bytes_in=len(body), bytes_out=len(payload),
                                  duration_s=time.perf_counter() - t0)
                self._note_request(path, method, status, t0)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()


async def _serve(host: str, port: int, device: str, role: str | None,
                 decode: str | None, grpc_port: int | None = None,
                 reuse_port: bool = False, stop: asyncio.Event | None = None) -> None:
    """Serve until SIGTERM or SIGINT (or ``stop``): the REST front and, with
    ``grpc_port``, the gRPC service, with the loop tuned once the units are
    warm (``utils/loops.py``: warmup and the captures run under the default
    collector).  The deployment is named ``SELDON_DEPLOYMENT_ID`` when set,
    else the predictor's name."""
    import signal

    service = PredictionService(load_predictor_spec(), device=device,
                                deployment_name=os.environ.get("SELDON_DEPLOYMENT_ID", ""))
    co_services = [PredictionService(spec, device=device) for spec in load_co_predictor_specs()]
    app = EngineApp(service, role=role, decode_upstreams=disagg.decode_upstreams(decode),
                    co_services=co_services)
    stop = stop or asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        with contextlib.suppress(NotImplementedError, RuntimeError, ValueError):
            loop.add_signal_handler(sig, stop.set)
    try:
        await app.start(host, port, grpc_port=grpc_port, reuse_port=reuse_port)
        log.info("engine listening on %s:%d, gRPC %s (device %s, role %s)", host, app.port,
                 app.grpc_port, device, app.role)
        await app.boot()
        tune_server_loop()
        log.info("engine ready")
        await stop.wait()
    finally:
        await app.close()


def _serve_worker(host: str, port: int, device: str, role: str | None, decode: str | None,
                  grpc_port: int | None, reuse_port: bool) -> None:
    """One engine process (the target of the spawned workers)."""
    logging.basicConfig(level=logging.INFO)
    with contextlib.suppress(KeyboardInterrupt):
        asyncio.run(_serve(host, port, device, role, decode, grpc_port, reuse_port))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu engine on PyTorch")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("ENGINE_SERVER_PORT", "8000"))
    )
    parser.add_argument(
        "--grpc-port", type=int, default=int(os.environ.get("ENGINE_SERVER_GRPC_PORT", "5001")),
        help="the Seldon gRPC service's port (h2 data plane)")
    parser.add_argument(
        "--workers", type=int, default=int(os.environ.get("ENGINE_WORKERS", "1")),
        help="worker processes sharing both ports via SO_REUSEPORT. Use >1 only for "
             "CPU-bound graphs (stubs, routing): a graph with a model on the card owns "
             "the device and must stay at 1 (batching provides its concurrency)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--role", default=None, choices=disagg.ROLES,
                        help=f"disaggregated serving role (default: ${disagg.ROLE_ENV} or unified)")
    parser.add_argument("--disagg-decode", default=None, metavar="HOST:PORT,...",
                        help=f"a prefill engine's decode peers (default: "
                             f"${disagg.DECODE_UPSTREAMS_ENV})")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)
    disagg.resolve_role(args.role)  # an unknown role in the env fails here
    serve = (args.host, args.port, args.device, args.role, args.disagg_decode, args.grpc_port)
    if args.workers <= 1:
        _serve_worker(*serve, False)
        return
    # spawned, never forked: a forked child cannot use the parent's CUDA state
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_serve_worker, args=(*serve, True))
             for _ in range(args.workers - 1)]
    for p in procs:
        p.start()
    try:
        _serve_worker(*serve, True)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10)


if __name__ == "__main__":
    main()
