"""The model microservice's gRPC server: the port's copy of the JAX
package's ``runtime/grpc_service.py`` on the h2 data plane
(``wire/h2grpc.py``).

The gRPC twin of ``runtime/server.py``: one user component behind the
per-type services (``Model``, ``Router``, ``Transformer``,
``OutputTransformer``, ``Combiner``) and ``Generic``.  Errors come back as
a SeldonMessage with a FAILURE status, never as transport errors: a bad
message 400, a :class:`GraphUnitError` or any other exception of the
user's code 500.  ``SCT_GRPC_IMPL=grpcio`` raises by name.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import signal
from typing import Any

import numpy as np

from seldon_core_tpu_torch.contract import (
    Payload,
    feedback_from_proto,
    payload_from_proto,
    payload_to_proto,
)
from seldon_core_tpu_torch.graph.spec import PredictiveUnitSpec, UnitType
from seldon_core_tpu_torch.graph.walker import LocalClient, make_annotation_lock
from seldon_core_tpu_torch.proto import prediction as pb
from seldon_core_tpu_torch.proto.grpc_defs import (
    failure_message,
    raw_handlers,
    unary_guard,
    use_grpcio,
)
from seldon_core_tpu_torch.wire import FastGrpcServer

log = logging.getLogger(__name__)


class ComponentGrpc:
    """Every unary handler of one wrapped component."""

    def __init__(self, component: Any, name: str = "model", service_type: str = "MODEL"):
        self.component = component
        self.name = name
        self.service_type = service_type
        # two client views of one component sharing ONE annotation lock, as
        # the REST server's (runtime/server.py)
        shared_lock = make_annotation_lock(component)
        self._model_client = LocalClient(
            PredictiveUnitSpec(name=name, type=UnitType.MODEL), component, tag_lock=shared_lock)
        self._transformer_client = LocalClient(
            PredictiveUnitSpec(name=name, type=UnitType.TRANSFORMER), component,
            tag_lock=shared_lock)

    @unary_guard
    async def Predict(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        out = await self._model_client.transform_input(payload_from_proto(request))
        return payload_to_proto(out)

    @unary_guard
    async def TransformInput(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        out = await self._transformer_client.transform_input(payload_from_proto(request))
        return payload_to_proto(out)

    @unary_guard
    async def TransformOutput(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        out = await self._transformer_client.transform_output(payload_from_proto(request))
        return payload_to_proto(out)

    @unary_guard
    async def Route(self, request: pb.SeldonMessage, context) -> pb.SeldonMessage:
        payload = payload_from_proto(request)
        branch = await self._model_client.route(payload)
        # the branch as a 1x1 ndarray, like the reference router runtime
        return payload_to_proto(payload.with_array(np.array([[branch]]), names=[]))

    @unary_guard
    async def Aggregate(self, request: pb.SeldonMessageList, context) -> pb.SeldonMessage:
        payloads = [payload_from_proto(m) for m in request.seldonMessages]
        if not payloads:
            return failure_message("seldonMessages list is empty", 400)
        return payload_to_proto(await self._model_client.aggregate(payloads))

    @unary_guard
    async def SendFeedback(self, request: pb.Feedback, context) -> pb.SeldonMessage:
        fb = feedback_from_proto(request)
        routing = None
        if fb.response is not None:
            routing = fb.response.meta.routing.get(self.name)
        await self._model_client.send_feedback(
            fb, int(routing) if routing is not None else None)
        return payload_to_proto(Payload())


def register(server: FastGrpcServer, handler: ComponentGrpc) -> None:
    """Register the per-type services and Generic on a fast server, from
    the one table of :func:`_service_tables`."""
    for service, table in _service_tables(handler).items():
        for path, fn in raw_handlers(service, table).items():
            server.add_handler(path, fn)


def _service_tables(handler: ComponentGrpc) -> dict[str, dict[str, Any]]:
    return {
        "Model": {"Predict": handler.Predict, "SendFeedback": handler.SendFeedback},
        "Router": {"Route": handler.Route, "SendFeedback": handler.SendFeedback},
        "Transformer": {"TransformInput": handler.TransformInput},
        "OutputTransformer": {"TransformOutput": handler.TransformOutput},
        "Combiner": {"Aggregate": handler.Aggregate},
        "Generic": {
            "TransformInput": handler.Predict
            if handler.service_type == "MODEL"
            else handler.TransformInput,
            "TransformOutput": handler.TransformOutput,
            "Route": handler.Route,
            "Aggregate": handler.Aggregate,
            "SendFeedback": handler.SendFeedback,
        },
    }


async def start_grpc(component: Any, port: int, name: str = "model",
                     service_type: str = "MODEL", host: str | None = None) -> FastGrpcServer:
    """Start the microservice's gRPC server on the h2 data plane; the
    returned server's ``bound_port`` is the port (real when asked for 0)."""
    use_grpcio()  # raises by name when the grpcio transport is asked for
    handler = ComponentGrpc(component, name=name, service_type=service_type)
    server = FastGrpcServer({})
    register(server, handler)
    server.bound_port = await server.start(port, host=host)
    log.info("microservice gRPC (h2 data plane) on :%d (%s %s)", server.bound_port, name,
             service_type)
    return server


def serve_grpc(component: Any, port: int, name: str = "model",
               service_type: str = "MODEL") -> None:
    """Serve until SIGTERM or SIGINT, then stop gracefully and return, so
    the interpreter's exit handlers (the persistence flush) run."""

    async def main() -> None:
        server = await start_grpc(component, port, name=name, service_type=service_type)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            with contextlib.suppress(NotImplementedError, RuntimeError):
                loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await server.stop(grace=5)

    asyncio.run(main())
