"""The graph walker: the MODEL-node path of the JAX package's
``graph/walker.py``.

A request walks the unit's ``transform_input`` (a MODEL's ``predict``, or
``predict_raw`` for full control of the payload) and the component's
``tags()``/``metrics()`` merge into the request's shared meta.  The runtime
node is built once at startup.  Graphs with children (routers, combiners)
are refused at build time: the port does not walk them yet.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable

import numpy as np

from seldon_core_tpu_torch.contract.payload import Metric, Payload
from seldon_core_tpu_torch.graph.spec import (
    Method,
    PredictiveUnitSpec,
    TransportType,
    UnitType,
)
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin, has_builtin


async def _call(fn: Callable[..., Any], *args: Any) -> Any:
    """Call a component method that may be sync or async; sync calls run on
    the default thread pool so numpy/torch work never blocks the loop."""
    if inspect.iscoroutinefunction(fn):
        return await fn(*args)
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(fn, *args))


class LocalClient:
    """In-process client over a duck-typed component object."""

    def __init__(self, spec: PredictiveUnitSpec, component: Any):
        self.spec = spec
        self.component = component

    def _annotate(self, p: Payload) -> Payload:
        """Merge component tags/metrics into the shared request meta."""
        comp = self.component
        tags = getattr(comp, "tags", None)
        if callable(tags):
            p.meta.tags.update(tags() or {})
        metrics = getattr(comp, "metrics", None)
        if callable(metrics):
            for m in metrics() or []:
                p.meta.metrics.append(
                    Metric(
                        key=m.get("key", ""),
                        type=m.get("type", "COUNTER"),
                        value=float(m.get("value", 0.0)),
                    )
                )
        p.meta.request_path.setdefault(self.spec.name, type(comp).__name__)
        return p

    def _names_out(self, result: np.ndarray, p: Payload) -> list[str]:
        class_names = getattr(self.component, "class_names", None)
        if class_names:
            return [str(c) for c in class_names]
        if result.ndim >= 2 and len(p.names) == result.shape[-1]:
            return p.names
        return []

    async def transform_input(self, p: Payload) -> Payload:
        comp = self.component
        raw_fn = getattr(comp, "predict_raw", None)
        if callable(raw_fn):
            out = await _call(raw_fn, p)
            if not isinstance(out, Payload):
                raise GraphUnitError(f"{self.spec.name}.predict_raw must return a Payload")
            out.meta = p.meta  # keep the shared request meta
            return self._annotate(out)
        fn = getattr(comp, "predict", None)
        if fn is None:
            return self._annotate(p)
        result = np.asarray(await _call(fn, p.array, p.names))
        return self._annotate(p.with_array(result, self._names_out(result, p)))


def default_client_factory(spec: PredictiveUnitSpec, device: str) -> LocalClient:
    if spec.endpoint.type != TransportType.LOCAL:
        raise GraphUnitError(
            f"unit {spec.name!r}: this engine serves LOCAL units only, not "
            f"{spec.endpoint.type.value}"
        )
    if not has_builtin(spec.implementation):
        raise GraphUnitError(
            f"unit {spec.name!r} has a LOCAL endpoint but no built-in "
            f"implementation ({spec.implementation.value})"
        )
    return LocalClient(
        spec, create_builtin(spec.implementation, spec.parameters_dict(), device=device)
    )


class GraphWalker:
    """Executes a one-node MODEL graph, its unit built from the built-in
    registry on ``device``."""

    def __init__(self, spec: PredictiveUnitSpec, device: str = "cuda"):
        if spec.children:
            raise GraphUnitError(
                f"unit {spec.name!r} has children: routers and combiners are not "
                "served by this engine yet"
            )
        if spec.type not in (None, UnitType.MODEL):
            raise GraphUnitError(
                f"unit {spec.name!r} is a {spec.type.value}: this engine serves "
                "MODEL units only"
            )
        self.spec = spec
        self.methods = set(spec.resolved_methods() or [Method.TRANSFORM_INPUT])
        self.client = default_client_factory(spec, device)

    @property
    def component(self) -> Any:
        return self.client.component

    async def warmup(self) -> dict[str, int]:
        """Run the unit's warmup off the event loop; unit name -> runs."""
        fn = getattr(self.component, "warmup", None)
        if not callable(fn):
            return {}
        return {self.spec.name: await asyncio.to_thread(fn)}

    async def aclose(self) -> None:
        closer = getattr(self.component, "close", None)
        if closer is not None:
            res = closer()
            if asyncio.iscoroutine(res):
                await res

    async def predict(self, payload: Payload) -> Payload:
        if Method.TRANSFORM_INPUT in self.methods:
            return await self.client.transform_input(payload)
        return payload
