"""Transports from the engine to remote graph units: the port's copy of
the JAX package's ``engine/transport.py``, on the pooled stdlib client
(``wire/h1client.py``) in place of aiohttp.

A unit behind a REST endpoint is a wrapped model microservice (the
port's ``runtime/server.py``, the JAX package's, or any server with the
same routes).  Each hop posts the unit's JSON message with the request's
``traceparent`` and its remaining deadline and priority
(``x-sct-deadline-ms``, ``x-sct-priority``), and retries transient
failures a bounded number of times: any method when the connection was
never made, and only the pure methods (``/predict``, ``/aggregate``) when
the request may have reached the unit.

A unit behind a GRPC endpoint is called over the h2 data plane
(``engine/grpc_transport.py``), with the same retry classes.  Every hop's
request and reply bytes count on the ``engine-node`` wire edge of its
unit (``obs/wire.py``).
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from typing import Any

import numpy as np

from seldon_core_tpu_torch.contract.codec import (
    feedback_to_dict,
    payload_from_dict,
    payload_to_dict,
)
from seldon_core_tpu_torch.contract.payload import FeedbackPayload, Payload
from seldon_core_tpu_torch.graph.spec import PredictiveUnitSpec, TransportType, UnitType
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.graph.walker import ROUTE_ALL, default_client_factory
from seldon_core_tpu_torch.obs.spans import TRACEPARENT_HEADER, get_traceparent
from seldon_core_tpu_torch.obs.wire import WIRE, WIRE_ENGINE_NODE
from seldon_core_tpu_torch.qos.context import outgoing_qos_headers
from seldon_core_tpu_torch.wire.h1client import H1ConnectError, H1Pool, H1SentError


class RemoteUnitError(GraphUnitError):
    """A remote unit failed or returned an error status."""


RETRY_ATTEMPTS = 3
RETRY_BASE_DELAY_S = 0.05
RETRYABLE_HTTP = frozenset({502, 503, 504})


async def retry_backoff(attempt: int) -> None:
    """Jittered exponential backoff before retry ``attempt + 1``."""
    await asyncio.sleep(RETRY_BASE_DELAY_S * (2 ** attempt) * (0.5 + random.random()))


class RetryBudget:
    """Token-bucket retry budget.  Each forwarded request ``earn``s
    ``rate`` retry tokens (capped at ``burst``); each retry ``spend``s one.
    Under sustained upstream failure the retry amplification is bounded at
    about ``rate``: retries must never turn a replica brownout into a flood
    of its own.  Single-owner (one event loop)."""

    def __init__(self, burst: float, rate: float):
        self.burst = max(0.0, float(burst))
        self.rate = max(0.0, float(rate))
        self.tokens = self.burst
        self.spent = 0
        self.denied = 0

    def earn(self) -> None:
        self.tokens = min(self.burst, self.tokens + self.rate)

    def spend(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.spent += 1
            return True
        self.denied += 1
        return False

    def snapshot(self) -> dict:
        return {"tokens": round(self.tokens, 3), "burst": self.burst, "rate": self.rate,
                "spent": self.spent, "denied": self.denied}


class _RetryableConnect(Exception):
    """The connection was never made: safe to retry any method."""

    def __init__(self, cause: Exception):
        self.cause = cause


class _RetryableSent(Exception):
    """The request may have reached the peer: retry only idempotent methods."""

    def __init__(self, cause: Exception):
        self.cause = cause


async def retry_loop(attempt, *, idempotent: bool, attempts: int = RETRY_ATTEMPTS,
                     budget: RetryBudget | None = None, backoff=None):
    """The bounded retry of every hop (the engine's REST node hops and the
    gateway's forward): up to ``attempts`` awaits of ``attempt(i)``, which
    returns the result or raises :class:`_RetryableConnect`,
    :class:`_RetryableSent` or anything else (no retry).  On exhaustion, or
    a sent failure of a method that is not idempotent, the last classified
    error's ``cause`` is raised.  ``budget`` gates every retry (an empty
    bucket raises the last cause at once); ``backoff`` (an ``async f(i)``)
    replaces the default delay between attempts."""
    last: Exception | None = None
    for i in range(attempts):
        try:
            return await attempt(i)
        except _RetryableConnect as e:
            last = e.cause
        except _RetryableSent as e:
            if not idempotent:
                raise e.cause from None
            last = e.cause
        if i < attempts - 1:
            if budget is not None and not budget.spend():
                raise last
            await (backoff(i) if backoff is not None else retry_backoff(i))
    raise last  # type: ignore[misc]


class RestNodeClient:
    """The walker's client for a unit behind a REST endpoint: JSON over one
    pooled keep-alive connection set to the unit's host and port."""

    def __init__(self, spec: PredictiveUnitSpec, pool: H1Pool, timeout_s: float = 5.0):
        self.spec = spec
        self.pool = pool
        self.timeout_s = timeout_s
        ep = spec.endpoint
        self.base = f"http://{ep.service_host}:{ep.service_port}"
        # the hop's wire accounting (client edge: out = request, in = reply)
        self._wire = WIRE.counter(WIRE_ENGINE_NODE, spec.name)

    async def _post(self, path: str, body: dict[str, Any], idempotent: bool) -> dict[str, Any]:
        return await retry_loop(lambda _i: self._post_once(path, body), idempotent=idempotent)

    async def _post_once(self, path: str, body: dict[str, Any]) -> dict[str, Any]:
        # the trace context and the request's REMAINING deadline ride every hop
        headers = outgoing_qos_headers()
        tp = get_traceparent()
        if tp:
            headers[TRACEPARENT_HEADER] = tp
        name = self.spec.name
        raw = json.dumps(body).encode()
        t0 = time.perf_counter()
        try:
            resp = await self.pool.post(path, raw, headers, timeout=self.timeout_s)
        except H1ConnectError as e:
            raise _RetryableConnect(
                RemoteUnitError(f"unit {name!r} {path} unreachable: {e}")) from e
        except (H1SentError, asyncio.TimeoutError) as e:
            raise _RetryableSent(
                RemoteUnitError(f"unit {name!r} {path} failed: {type(e).__name__}: {e}")) from e
        self._wire.record(bytes_in=len(resp.body), bytes_out=len(raw),
                          duration_s=time.perf_counter() - t0)
        try:
            data = json.loads(resp.body)
        except ValueError as e:
            raise _RetryableSent(RemoteUnitError(
                f"unit {name!r} {path} failed: HTTP {resp.status}, a reply that is not "
                f"JSON: {e}")) from e
        if resp.status in RETRYABLE_HTTP:
            raise _RetryableSent(RemoteUnitError(f"unit {name!r} {path} -> HTTP {resp.status}"))
        if resp.status != 200:
            status = data.get("status") if isinstance(data, dict) else None
            reason = status.get("info", "") if isinstance(status, dict) else ""
            raise RemoteUnitError(f"unit {name!r} {path} -> HTTP {resp.status}: {reason}")
        return data

    def _merge(self, p: Payload, out: Payload) -> Payload:
        """Keep the request's one shared meta, with the remote's additions."""
        p.meta.merge_from(out.meta)
        out.meta = p.meta
        out.meta.request_path.setdefault(self.spec.name, self.base)
        return out

    # Retry after a send only for the pure methods: a MODEL's predict and a
    # COMBINER's aggregate.  A transformer may be a stateful online detector
    # and a router may count its pulls; feedback must never count twice.

    async def transform_input(self, p: Payload) -> Payload:
        if self.spec.type == UnitType.MODEL:
            reply = await self._post("/predict", payload_to_dict(p), idempotent=True)
        else:
            reply = await self._post("/transform-input", payload_to_dict(p), idempotent=False)
        return self._merge(p, payload_from_dict(reply))

    async def transform_output(self, p: Payload) -> Payload:
        reply = await self._post("/transform-output", payload_to_dict(p), idempotent=False)
        return self._merge(p, payload_from_dict(reply))

    async def route(self, p: Payload) -> int:
        out = payload_from_dict(await self._post("/route", payload_to_dict(p), idempotent=False))
        self._merge(p, out)
        if not out.is_numeric():
            return ROUTE_ALL
        return int(np.asarray(out.array).ravel()[0])

    async def aggregate(self, ps: list[Payload]) -> Payload:
        body = {"seldonMessages": [payload_to_dict(p) for p in ps]}
        out = payload_from_dict(await self._post("/aggregate", body, idempotent=True))
        return self._merge(ps[0], out)

    async def send_feedback(self, fb: FeedbackPayload, routing: int | None) -> None:
        body = feedback_to_dict(fb)
        if routing is not None:
            body["routing"] = routing
        await self._post("/send-feedback", body, idempotent=False)


class TransportManager:
    """Builds the walker's clients and owns one :class:`H1Pool` per
    (host, port) of the graph's REST units and one gRPC channel per GRPC
    unit's endpoint.  The walker may be built off
    the engine's loop: a pool binds to the loop that first posts through
    it."""

    def __init__(self, timeout_s: float = 5.0, device: str = "cuda"):
        self.timeout_s = timeout_s
        self.device = device
        self.pools: dict[tuple[str, int], H1Pool] = {}
        self._channels = None  # the GRPC units' ChannelCache, made at first use

    async def close(self) -> None:
        pools, self.pools = self.pools, {}
        for pool in pools.values():
            await pool.close()
        channels, self._channels = self._channels, None
        if channels is not None:
            await channels.close()

    def pool(self, host: str, port: int) -> H1Pool:
        key = (host, int(port))
        if key not in self.pools:
            self.pools[key] = H1Pool(host, int(port))
        return self.pools[key]

    def client_factory(self, spec: PredictiveUnitSpec):
        ep = spec.endpoint
        if ep.type == TransportType.REST:
            return RestNodeClient(spec, self.pool(ep.service_host, ep.service_port),
                                  self.timeout_s)
        if ep.type == TransportType.GRPC:
            from seldon_core_tpu_torch.engine.grpc_transport import ChannelCache, GrpcNodeClient

            if self._channels is None:
                self._channels = ChannelCache()
            try:
                return GrpcNodeClient(spec, self._channels, self.timeout_s)
            except NotImplementedError as e:  # the grpcio transport, refused
                raise GraphUnitError(f"unit {spec.name!r}: {e}") from e
        return default_client_factory(spec, self.device)
