"""The engine's gRPC service: ``Seldon`` (Predict, SendFeedback and the
server-streaming StreamPredict), the port's copy of the JAX package's
``engine/grpc_app.py`` on the h2 data plane (``wire/h2grpc.py``).

The gRPC twin of the engine's REST routes: a request's ``traceparent``
metadata seeds the trace context as a REST header does, and each unary
call's request and reply bytes count on the ``engine-grpc`` wire edge of
the deployment (``obs/wire.py``).  ``ENGINE_GRPC_IMPL=grpcio`` raises by
name (the card has no grpcio).
"""

from __future__ import annotations

import json
import logging
import time

from seldon_core_tpu_torch.contract import (
    Payload,
    feedback_from_proto,
    payload_from_proto,
    payload_to_proto,
)
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.obs.spans import TRACEPARENT_HEADER, set_traceparent
from seldon_core_tpu_torch.obs.wire import WIRE, WIRE_ENGINE_GRPC
from seldon_core_tpu_torch.proto import prediction as pb
from seldon_core_tpu_torch.proto.grpc_defs import raw_handlers, unary_guard, use_grpcio
from seldon_core_tpu_torch.wire import FastGrpcServer, GrpcCallError

log = logging.getLogger(__name__)

INVALID_ARGUMENT = 3


class SeldonGrpc:
    def __init__(self, service: PredictionService):
        self.service = service
        self._wire = WIRE.counter(WIRE_ENGINE_GRPC, service.deployment_name)

    @unary_guard
    async def Predict(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        t0 = time.perf_counter()
        out = await self.service.predict(payload_from_proto(request))
        msg = payload_to_proto(out)
        msg.status = pb.Status(code=200, status=pb.Status.SUCCESS)
        self._wire.record(bytes_in=request.ByteSize(), bytes_out=msg.ByteSize(),
                          duration_s=time.perf_counter() - t0)
        return msg

    @unary_guard
    async def SendFeedback(self, request: pb.Feedback, context) -> pb.SeldonMessage:
        await self.service.send_feedback(feedback_from_proto(request))
        msg = payload_to_proto(Payload())
        self._wire.record(bytes_in=request.ByteSize(), bytes_out=msg.ByteSize())
        return msg

    async def stream_predict_raw(self, payload: bytes):
        """The raw-bytes adapter of the h2 plane: parse once, serialize each
        streamed message."""
        async for msg in self.stream_predict(pb.SeldonMessage.FromString(payload)):
            yield msg.SerializeToString()

    async def stream_predict(self, req: pb.SeldonMessage):
        """Server-streaming generation (``rpc Seldon.StreamPredict``; the
        REST twin is ``POST /api/v0.1/predictions/stream``).  The request's
        strData is ``{"tokens": [...], "max_new_tokens": N, "temperature":
        t, "eos_id": e}``; the replies are one strData ``{"token": id}`` per
        generated token, then ``{"done": true, "tokens": [...]}``.  A bad
        request is INVALID_ARGUMENT, with the JAX engine's texts."""
        units = self.service.generative_units()
        if len(units) != 1:
            raise GrpcCallError(
                INVALID_ARGUMENT,
                "streaming needs exactly one generative unit in the graph "
                f"(found {len(units)})",
            )
        if not req.strData:
            raise GrpcCallError(INVALID_ARGUMENT, "StreamPredict takes strData JSON")
        try:
            body = json.loads(req.strData)
            prompt = body["tokens"]
            if not isinstance(prompt, (list, tuple)) or (
                prompt and isinstance(prompt[0], (list, tuple))
            ):
                raise ValueError("streaming takes ONE prompt: flat 'tokens' list")
            # coerced inside the validation, as the REST twin: a malformed
            # option is the client's error
            max_new = body.get("max_new_tokens")
            max_new = int(max_new) if max_new is not None else None
            temperature = body.get("temperature")
            temperature = float(temperature) if temperature is not None else None
            eos = body.get("eos_id")
            eos = int(eos) if eos is not None else None
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise GrpcCallError(INVALID_ARGUMENT, f"bad stream request: {e}") from e

        tokens: list[int] = []
        try:
            async for tok in units[0].stream(prompt, max_new_tokens=max_new,
                                             temperature=temperature, eos_id=eos):
                tokens.append(tok)
                yield pb.SeldonMessage(strData=json.dumps({"token": tok}))
        except GraphUnitError as e:
            raise GrpcCallError(INVALID_ARGUMENT, str(e)) from e
        yield pb.SeldonMessage(strData=json.dumps({"done": True, "tokens": tokens}))


def _seed_trace_context(headers: list) -> None:
    """gRPC ingress feeds the same trace-context propagation as REST: the
    request's ``traceparent`` metadata, in the handler task's context."""
    key = TRACEPARENT_HEADER.encode()
    set_traceparent(next((v.decode() for k, v in headers if k == key), None))


async def start_engine_grpc(service: PredictionService, port: int, *,
                            reuse_port: bool = False, host: str | None = None):
    """Start the engine's Seldon gRPC service on the h2 data plane and
    return the server (``bound_port`` is the port, real when asked for
    0)."""
    use_grpcio()  # raises by name when the grpcio transport is asked for
    handler = SeldonGrpc(service)
    server = FastGrpcServer(
        raw_handlers("Seldon", {"Predict": handler.Predict,
                                "SendFeedback": handler.SendFeedback}),
        on_request_headers=_seed_trace_context,
        stream_handlers={"/seldon.protos.Seldon/StreamPredict": handler.stream_predict_raw},
    )
    server.bound_port = await server.start(port, host=host, reuse_port=reuse_port)
    log.info("engine gRPC (Seldon service, h2 data plane) on :%d", server.bound_port)
    return server
