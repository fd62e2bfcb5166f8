"""The engine's client for graph units behind a GRPC endpoint: the port's
copy of the JAX package's ``engine/grpc_transport.py`` on the h2 data
plane (``FastGrpcChannel``).

One multiplexed channel per endpoint, made lazily, cached in a
:class:`ChannelCache` owned by the engine's ``TransportManager`` and closed
with the service.  Each call carries the request's ``traceparent`` and
retries as the REST node client does (``engine/transport.py``
``retry_loop``): any method when the connection was never made or a
GOAWAY refused the stream, the pure methods only when the request may
have reached the unit.  The hop's bytes count on the unit's
``engine-node`` wire edge.  ``SCT_GRPC_IMPL=grpcio`` raises by name.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from seldon_core_tpu_torch.contract import (
    FeedbackPayload,
    Payload,
    feedback_to_proto,
    payload_from_proto,
    payload_to_proto,
)
from seldon_core_tpu_torch.graph.spec import PredictiveUnitSpec, UnitType
from seldon_core_tpu_torch.graph.walker import ROUTE_ALL
from seldon_core_tpu_torch.obs.spans import outgoing_headers
from seldon_core_tpu_torch.obs.wire import WIRE, WIRE_ENGINE_NODE
from seldon_core_tpu_torch.proto import prediction as pb
from seldon_core_tpu_torch.proto.grpc_defs import use_grpcio
from seldon_core_tpu_torch.wire import (
    FastGrpcChannel,
    FastStub,
    GrpcCallError,
    GrpcStreamRefusedError,
)

GRPC_UNAVAILABLE = 14

# wordings that mean the TCP connect itself failed, so the request never
# reached the peer and even a method that is not idempotent may retry.
# Matched case-insensitively (they are no stable API); an unknown wording
# fails safe to "sent".  A connection reset is not here: it happens on an
# established connection, after the request may have been processed.
_CONNECT_FAILURE_MARKERS = (
    "failed to connect",
    "connection refused",
    "connect failed",
    "econnrefused",
    "no route to host",
    "name resolution",
    "dns resolution",
)


def _is_connect_failure(details: str | None) -> bool:
    d = (details or "").lower()
    return any(m in d for m in _CONNECT_FAILURE_MARKERS)


class ChannelCache:
    """target -> channel: one multiplexed connection per endpoint."""

    def __init__(self):
        self._channels: dict[str, FastGrpcChannel] = {}

    def get(self, target: str) -> FastGrpcChannel:
        ch = self._channels.get(target)
        if ch is None:
            use_grpcio()  # raises by name when the grpcio transport is asked for
            ch = self._channels[target] = FastGrpcChannel(target)
        return ch

    async def close(self) -> None:
        channels, self._channels = list(self._channels.values()), {}
        for ch in channels:
            await ch.close()


class GrpcNodeClient:
    """The walker's client for a unit behind a GRPC endpoint: typed calls
    to a wrapped model microservice (``runtime/grpc_service.py``)."""

    def __init__(self, spec: PredictiveUnitSpec, channels: ChannelCache,
                 timeout_s: float = 5.0):
        self.spec = spec
        self.timeout = timeout_s
        ep = spec.endpoint
        self.target = f"{ep.service_host}:{ep.service_port}"
        ch = channels.get(self.target)
        self._model = FastStub(ch, "Model")
        self._router = FastStub(ch, "Router")
        self._transformer = FastStub(ch, "Transformer")
        self._output_transformer = FastStub(ch, "OutputTransformer")
        self._combiner = FastStub(ch, "Combiner")
        # the hop's wire accounting (client edge: out = request, in = reply),
        # the REST client's edge label
        self._wire = WIRE.counter(WIRE_ENGINE_NODE, spec.name)

    async def _call(self, method, request, idempotent: bool = True) -> Payload:
        from seldon_core_tpu_torch.engine.transport import (
            RemoteUnitError,
            _RetryableConnect,
            _RetryableSent,
            retry_loop,
        )

        name = self.spec.name
        metadata = tuple(outgoing_headers().items())

        async def attempt(_i: int) -> pb.SeldonMessage:
            try:
                return await method(request, timeout=self.timeout, metadata=metadata)
            except GrpcCallError as e:
                err = RemoteUnitError(f"unit {name!r} gRPC {self.target} failed: {e}")
                # UNAVAILABLE is the gRPC 503: transient, retried if
                # idempotent, and for any method when its wording says the
                # connect itself failed
                if e.status == GRPC_UNAVAILABLE:
                    if _is_connect_failure(e.message):
                        raise _RetryableConnect(err) from e
                    raise _RetryableSent(err) from e
                raise err from e
            except ConnectionRefusedError as e:
                raise _RetryableConnect(RemoteUnitError(
                    f"unit {name!r} gRPC {self.target} unreachable: {e}")) from e
            except GrpcStreamRefusedError as e:
                # refused by a GOAWAY: provably never processed (RFC 7540
                # §6.8), so safe to retry any method
                raise _RetryableConnect(RemoteUnitError(
                    f"unit {name!r} gRPC {self.target} refused: {e}")) from e
            except (ConnectionError, asyncio.TimeoutError, OSError) as e:
                raise _RetryableSent(RemoteUnitError(
                    f"unit {name!r} gRPC {self.target} failed: {e}")) from e

        t0 = time.perf_counter()
        reply = await retry_loop(attempt, idempotent=idempotent)
        self._wire.record(bytes_in=reply.ByteSize(), bytes_out=request.ByteSize(),
                          duration_s=time.perf_counter() - t0)
        if reply.status is not None and reply.status.status == pb.Status.FAILURE:
            raise RemoteUnitError(f"unit {name!r} gRPC failure: {reply.status.info}")
        return payload_from_proto(reply)

    def _merge(self, p: Payload, out: Payload) -> Payload:
        """Keep the request's one shared meta, with the remote's additions."""
        p.meta.merge_from(out.meta)
        out.meta = p.meta
        out.meta.request_path.setdefault(self.spec.name, self.target)
        return out

    # Retry after a send only for the pure methods: a MODEL's predict and a
    # COMBINER's aggregate (a transformer may be a stateful online detector
    # and a router may count its pulls; feedback must never count twice).

    async def transform_input(self, p: Payload) -> Payload:
        if self.spec.type == UnitType.MODEL:
            out = await self._call(self._model.Predict, payload_to_proto(p), idempotent=True)
        else:
            out = await self._call(self._transformer.TransformInput, payload_to_proto(p),
                                   idempotent=False)
        return self._merge(p, out)

    async def transform_output(self, p: Payload) -> Payload:
        out = await self._call(self._output_transformer.TransformOutput, payload_to_proto(p),
                               idempotent=False)
        return self._merge(p, out)

    async def route(self, p: Payload) -> int:
        out = await self._call(self._router.Route, payload_to_proto(p), idempotent=False)
        self._merge(p, out)
        if not out.is_numeric():
            return ROUTE_ALL
        return int(np.asarray(out.array).ravel()[0])

    async def aggregate(self, ps: list[Payload]) -> Payload:
        req = pb.SeldonMessageList(seldonMessages=[payload_to_proto(p) for p in ps])
        out = await self._call(self._combiner.Aggregate, req, idempotent=True)
        return self._merge(ps[0], out)

    async def send_feedback(self, fb: FeedbackPayload, routing: int | None) -> None:
        req = feedback_to_proto(fb)
        if routing is not None:
            if req.response is None:
                req.response = pb.SeldonMessage()
            if req.response.meta is None:
                req.response.meta = pb.Meta()
            req.response.meta.routing[self.spec.name] = routing
        stub = self._router if self.spec.type == UnitType.ROUTER else self._model
        await self._call(stub.SendFeedback, req, idempotent=False)
