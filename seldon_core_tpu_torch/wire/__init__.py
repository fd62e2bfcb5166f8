"""The wire on asyncio and the stdlib alone: the HTTP/1.1 pooled client
the engine's remote graph hops use (``h1client.py``), the request reading
and body parsing the engine and the wrapper runtime share
(``h1server.py``), and the gRPC data plane (``h2grpc.py`` over
``hpack.py``) with the JAX package's exported names."""

from seldon_core_tpu_torch.wire.h2grpc import (
    FastGrpcChannel,
    FastGrpcServer,
    FastStub,
    GrpcCallError,
    GrpcStreamRefusedError,
)

__all__ = [
    "FastGrpcChannel",
    "FastGrpcServer",
    "FastStub",
    "GrpcCallError",
    "GrpcStreamRefusedError",
]
