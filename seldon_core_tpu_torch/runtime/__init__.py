"""The user-model microservice runtime (the reference's wrapper runtime):
a user component behind the REST routes a graph's remote unit answers
(``server.py``) and their gRPC twin (``grpc_service.py``), its command
line (``microservice.py``), the outlier
detector adapter (``outlier.py``) and state persistence
(``persistence.py``), and the ``SCT_*`` settings the gateway and the fleet
plane read (``settings.py``, a trimmed copy of the JAX registry).

The exports load lazily (PEP 562), so that ``python -m
seldon_core_tpu_torch.runtime.microservice`` does not import its own
module twice."""

__all__ = ["MicroserviceApp", "serve", "load_component"]


def __getattr__(name):
    if name in ("MicroserviceApp", "serve"):
        from seldon_core_tpu_torch.runtime import server

        return getattr(server, name)
    if name == "load_component":
        from seldon_core_tpu_torch.runtime.microservice import load_component

        return load_component
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
