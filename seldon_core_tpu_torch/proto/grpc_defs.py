"""gRPC service definitions for the prediction contract: the port's copy
of the JAX package's ``proto/grpc_defs.py`` without its grpcio half.

The service table is data (``proto/prediction.proto``'s seven services and
``Seldon.StreamPredict``); the h2 data plane (``wire/h2grpc.py``) serves
and calls it through :func:`raw_handlers` and ``FastStub``.  The card has
no grpcio, so the grpcio transport (``ENGINE_GRPC_IMPL=grpcio`` or
``SCT_GRPC_IMPL=grpcio``) raises by name.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Any, Callable

from seldon_core_tpu_torch.proto import prediction as pb

PACKAGE = "seldon.protos"

MAX_MSG = 256 * 1024 * 1024

GRPCIO_REFUSED = ("the grpcio gRPC transport is not in the port (the card has no grpcio); "
                  "the h2 data plane (wire/h2grpc.py) serves gRPC")

_SM = pb.SeldonMessage
_FB = pb.Feedback
_SML = pb.SeldonMessageList

# service -> method -> (request type, response type), as prediction.proto
SERVICES: dict[str, dict[str, tuple[Any, Any]]] = {
    "Generic": {
        "TransformInput": (_SM, _SM),
        "TransformOutput": (_SM, _SM),
        "Route": (_SM, _SM),
        "Aggregate": (_SML, _SM),
        "SendFeedback": (_FB, _SM),
    },
    "Model": {"Predict": (_SM, _SM), "SendFeedback": (_FB, _SM)},
    "Router": {"Route": (_SM, _SM), "SendFeedback": (_FB, _SM)},
    "Transformer": {"TransformInput": (_SM, _SM)},
    "OutputTransformer": {"TransformOutput": (_SM, _SM)},
    "Combiner": {"Aggregate": (_SML, _SM)},
    "Seldon": {"Predict": (_SM, _SM), "SendFeedback": (_FB, _SM)},
}

# the server-streaming methods (rpc Seldon.StreamPredict)
STREAM_SERVICES: dict[str, dict[str, tuple[Any, Any]]] = {
    "Seldon": {"StreamPredict": (_SM, _SM)},
}


def full_service_name(service: str) -> str:
    return f"{PACKAGE}.{service}"


def failure_message(reason: str, code: int = 500) -> pb.SeldonMessage:
    """A SeldonMessage carrying a FAILURE status: wire-level errors stay in
    the contract instead of surfacing as transport errors."""
    return pb.SeldonMessage(status=pb.Status(code=code, info=reason, reason=reason,
                                             status=pb.Status.FAILURE))


def unary_guard(fn: Callable) -> Callable:
    """Wrap an async unary handler: codec errors -> 400 FAILURE, graph/user
    errors -> 500 FAILURE, never a raw transport exception."""
    from seldon_core_tpu_torch.contract import CodecError
    from seldon_core_tpu_torch.graph.units import GraphUnitError

    log = logging.getLogger(fn.__module__)

    @functools.wraps(fn)
    async def wrapped(self, request, context):
        try:
            return await fn(self, request, context)
        except CodecError as e:
            return failure_message(str(e), 400)
        except GraphUnitError as e:
            return failure_message(str(e), 500)
        except Exception as e:  # handler code may raise anything
            log.exception("unhandled error in %s", fn.__qualname__)
            return failure_message(f"{type(e).__name__}: {e}", 500)

    return wrapped


def use_grpcio() -> bool:
    """The transport selector of the JAX package: the h2 data plane is the
    default, and ``SCT_GRPC_IMPL=grpcio`` (or the engine's
    ``ENGINE_GRPC_IMPL``) selected grpcio, which the port refuses."""
    if (os.environ.get("ENGINE_GRPC_IMPL") == "grpcio"
            or os.environ.get("SCT_GRPC_IMPL") == "grpcio"):
        raise NotImplementedError(f"ENGINE_GRPC_IMPL/SCT_GRPC_IMPL=grpcio: {GRPCIO_REFUSED}")
    return False


def raw_handlers(service: str, handlers: dict[str, Callable]) -> dict[str, Callable]:
    """Adapt message-typed async handlers (``fn(msg, context)``) to the
    fast server's path -> bytes-handler table."""
    out: dict[str, Callable] = {}
    for method, fn in handlers.items():
        req, _res = SERVICES[service][method]

        def make(fn=fn, req=req):
            async def raw(payload: bytes) -> bytes:
                reply = await fn(req.FromString(payload), None)
                return reply.SerializeToString()

            return raw

        out[f"/{full_service_name(service)}/{method}"] = make()
    return out
