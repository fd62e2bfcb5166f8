"""The async graph walker: the port's copy of the JAX package's
``graph/walker.py``.

Walks the PredictiveUnit tree per request: ``transform_input`` -> ``route``
-> children (fanned out concurrently) -> ``aggregate`` ->
``transform_output``, merging meta tags and recording each router's choice
in ``meta.routing``, which the feedback walk replays.  A
``CASCADE_ROUTER`` walks its ordered tiers cheapest first and escalates on
its component's decision.  The runtime tree is built once at startup; all
payloads of one request share one mutable :class:`Meta`.

With a ``node_cache`` (``cache/content.py``, built when ``SCT_CACHE=1``)
a deterministic MODEL node serves an exact repeat of its input from the
cache without calling its component (``request_path`` says ``"cache"``).

A unit behind a REST endpoint is walked through the ``client_factory``
the engine passes (``engine/transport.py``); it is never deterministic,
and it has no in-process component to warm or close.

Left out here: the obs spans (``predict(trace=True)`` still writes
``sct_trace_ms`` into the tags).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import time
from typing import Any, Callable

import numpy as np

from seldon_core_tpu_torch.cache.content import payload_cache_key
from seldon_core_tpu_torch.contract.payload import FeedbackPayload, Metric, Payload
from seldon_core_tpu_torch.graph.spec import (
    Method,
    PredictiveUnitSpec,
    PredictorSpec,
    TransportType,
    UnitType,
)
from seldon_core_tpu_torch.graph.units import (
    GraphUnitError,
    SeldonComponent,
    create_builtin,
    has_builtin,
)

ROUTE_ALL = -1  # route() result meaning "send to every child"


def make_annotation_lock(component: Any) -> "asyncio.Lock | None":
    """A lock for a component whose per-request annotations (``tags()`` /
    ``metrics()``) live on the shared instance: without it two concurrent
    requests interleave call and read, and one reply carries the other's
    tags.  Only components that override ``tags`` or ``metrics`` of
    :class:`SeldonComponent` are locked, unless they declare
    ``SAFE_ANNOTATIONS = True`` (cumulative counters that tolerate races)."""
    if getattr(component, "SAFE_ANNOTATIONS", False):
        return None
    cls = type(component)
    for name in ("tags", "metrics"):
        fn = getattr(component, name, None)
        if callable(fn) and getattr(cls, name, None) is not getattr(SeldonComponent, name, None):
            return asyncio.Lock()
    return None


async def _in_pool(fn: Callable[..., Any], *args: Any) -> Any:
    """Run a sync component method on the default thread pool, in a copy of
    the request's context; the context variables it sets (a guardrail's
    QoS class) are written back to the request's context afterwards, as if
    it had run inline, and the pool thread keeps none of them.  (The JAX
    walker's ``loop.run_in_executor`` runs the method in the pool thread's
    own context: its writes stay in that thread, for later requests.)"""
    ctx = contextvars.copy_context()
    out = await asyncio.get_running_loop().run_in_executor(None, ctx.run, fn, *args)
    for var, value in ctx.items():
        try:
            same = var.get() is value
        except LookupError:
            same = False
        if not same:
            var.set(value)
    return out


class LocalClient:
    """In-process client over a duck-typed component object: a MODEL's
    TRANSFORM_INPUT is its ``predict``, a TRANSFORMER's its
    ``transform_input``.  A component that declares ``INLINE_SYNC`` on its
    own class runs its sync methods on the event loop; other sync methods
    run on the thread pool (:func:`_in_pool`)."""

    def __init__(self, spec: PredictiveUnitSpec, component: Any,
                 tag_lock: "asyncio.Lock | None" = None):
        self.spec = spec
        self.component = component
        self._tag_lock = tag_lock if tag_lock is not None else make_annotation_lock(component)
        # on the component's OWN class: a user subclass of a built-in may
        # override a method with blocking work
        self._inline = bool(type(component).__dict__.get("INLINE_SYNC", False))

    # -- helpers ----------------------------------------------------------

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

    async def _locked(self, coro_fn, *args):
        if self._tag_lock is not None:
            async with self._tag_lock:
                return await coro_fn(*args)
        return await coro_fn(*args)

    async def _call(self, fn, *args):
        if inspect.iscoroutinefunction(fn):
            return await fn(*args)
        if self._inline:
            return fn(*args)
        return await _in_pool(fn, *args)

    async def _transform_inner(self, p: Payload, method_name: str) -> Payload:
        comp = self.component
        raw_fn = getattr(comp, f"{method_name}_raw", None)
        if callable(raw_fn):
            out = await self._call(raw_fn, p)
            if not isinstance(out, Payload):
                raise GraphUnitError(f"{self.spec.name}.{method_name}_raw must return a Payload")
            out.meta = p.meta  # keep the shared request meta
            return self._annotate(out)
        fn = getattr(comp, method_name, None)
        if fn is None:
            return self._annotate(p)  # identity, as the transformer runtime does
        result = np.asarray(await self._call(fn, p.array, p.names))
        return self._annotate(p.with_array(result, self._names_out(result, p)))

    # -- the walker's calls -----------------------------------------------

    async def transform_input(self, p: Payload) -> Payload:
        method = "predict" if self.spec.type == UnitType.MODEL else "transform_input"
        return await self._locked(self._transform_inner, p, method)

    async def transform_output(self, p: Payload) -> Payload:
        return await self._locked(self._transform_inner, p, "transform_output")

    async def route(self, p: Payload) -> int:
        return await self._locked(self._route_inner, p)

    async def _route_inner(self, p: Payload) -> int:
        fn = getattr(self.component, "route", None)
        if fn is None:
            return ROUTE_ALL
        result = await self._call(fn, p.array if p.is_numeric() else p.data, p.names)
        branch = int(np.asarray(result).ravel()[0])
        self._annotate(p)
        return branch

    async def aggregate(self, ps: list[Payload]) -> Payload:
        return await self._locked(self._aggregate_inner, ps)

    async def _aggregate_inner(self, ps: list[Payload]) -> Payload:
        comp = self.component
        raw_fn = getattr(comp, "aggregate_raw", None)
        if callable(raw_fn):
            out = await self._call(raw_fn, ps)
            out.meta = ps[0].meta
            return self._annotate(out)
        fn = getattr(comp, "aggregate", None)
        if fn is None:
            if len(ps) != 1:
                raise GraphUnitError(
                    f"unit {self.spec.name!r} received {len(ps)} child outputs "
                    "but has no aggregate method"
                )
            return ps[0]
        result = np.asarray(await self._call(fn, [p.array for p in ps], [p.names for p in ps]))
        return self._annotate(ps[0].with_array(result, self._names_out(result, ps[0])))

    async def send_feedback(self, fb: FeedbackPayload, routing: int | None) -> None:
        fn = getattr(self.component, "send_feedback", None)
        if fn is None:
            return
        req = fb.request
        X = req.array if req is not None and req.is_numeric() else None
        names = req.names if req is not None else []
        truth = fb.truth.array if fb.truth is not None and fb.truth.is_numeric() else None
        # an inline bandit updates its counters on the loop thread, the
        # thread its route() reads them from
        await self._call(fn, X, names, fb.reward, truth, routing)


class _NodeState:
    """Runtime node: spec, client and children, built once at startup."""

    __slots__ = ("spec", "client", "children", "methods", "deterministic")

    def __init__(self, spec: PredictiveUnitSpec, client: Any,
                 children: list["_NodeState"]):
        self.spec = spec
        self.client = client
        self.children = children
        self.methods = set(spec.resolved_methods())
        # a node is deterministic only when its in-process component
        # DECLARES it: a remote unit never is
        self.deterministic = bool(getattr(self.component, "DETERMINISTIC", False))

    @property
    def component(self) -> Any:
        """The in-process component, or None for a remote unit."""
        return getattr(self.client, "component", None)


def default_client_factory(spec: PredictiveUnitSpec, device: str = "cuda") -> LocalClient:
    """LOCAL endpoints get an in-process client over the built-in registry,
    built on ``device``; remote endpoints need the engine's transports."""
    if spec.endpoint.type != TransportType.LOCAL:
        raise GraphUnitError(
            f"unit {spec.name!r}: no transport for {spec.endpoint.type.value} endpoints "
            "(build the walker with the engine's client_factory)"
        )
    if not has_builtin(spec.implementation):
        raise GraphUnitError(
            f"unit {spec.name!r} has a LOCAL endpoint but no built-in "
            f"implementation ({spec.implementation.value}); register a component "
            "via GraphWalker(components={...})"
        )
    return LocalClient(
        spec, create_builtin(spec.implementation, spec.parameters_dict(), device=device)
    )


class GraphWalker:
    """Executes an inference graph.

    ``components`` maps unit name -> in-process component object; the other
    units come from ``client_factory(spec)`` (default: the built-in
    registry, built on ``device``).
    ``feedback_hook(name, fb)`` fires for every unit the feedback walk
    reaches.  ``node_cache`` (a ``ResponseCache``) turns the node tier on.
    """

    def __init__(
        self,
        spec: PredictiveUnitSpec,
        components: dict[str, Any] | None = None,
        client_factory: Callable[[PredictiveUnitSpec], Any] | None = None,
        feedback_hook: Callable[[str, FeedbackPayload], None] | None = None,
        *,
        device: str = "cuda",
        node_cache: Any = None,
    ):
        self.spec = spec
        self.node_cache = node_cache
        self._components = components or {}
        self._factory = client_factory or (lambda s: default_client_factory(s, device))
        self._feedback_hook = feedback_hook
        self.warmup_seconds: dict[str, float] = {}
        # unit -> the programs its warmup made (buckets, window graphs):
        # /stats/warmup shows that readiness covered what is served
        self.warmup_variants: dict[str, list[str]] = {}
        self.root = self._build(spec)

    @property
    def component(self) -> Any:
        """The root unit's component (None when the root is remote)."""
        return self.root.component

    def _nodes(self):
        """Every runtime node, in pre-order (children in spec order)."""
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(node.children))

    def deterministic(self) -> bool:
        """True when EVERY node's component declares determinism: one
        randomized router makes the whole graph's replies uncacheable."""
        return all(node.deterministic for node in self._nodes())

    def _build(self, spec: PredictiveUnitSpec) -> _NodeState:
        if spec.name in self._components:
            client = LocalClient(spec, self._components[spec.name])
        else:
            client = self._factory(spec)
        node = _NodeState(spec, client, [self._build(c) for c in spec.children])
        if (spec.type == UnitType.CASCADE_ROUTER and spec.children
                and not callable(getattr(node.component, "decide", None))):
            raise GraphUnitError(
                f"unit {spec.name!r} is a CASCADE_ROUTER but has no in-process decide() "
                "policy (a remote cascade router is not served)")
        return node

    def iter_components(self):
        """Yield ``(unit_name, component)`` for every in-process node, in
        pre-order."""
        for node in self._nodes():
            if node.component is not None:
                yield node.spec.name, node.component

    async def warmup(self) -> dict[str, int]:
        """Run every unit's warmup off the event loop, one unit after the
        other (two generative units capture their graphs on one card);
        returns unit name -> warm-up runs, and each unit's wall seconds
        land in :attr:`warmup_seconds`."""
        report: dict[str, int] = {}
        self.warmup_seconds = {}
        self.warmup_variants = {}
        for name, comp in self.iter_components():
            fn = getattr(comp, "warmup", None)
            if callable(fn):
                t0 = time.perf_counter()
                report[name] = await asyncio.to_thread(fn)
                self.warmup_seconds[name] = round(time.perf_counter() - t0, 3)
                variants = getattr(comp, "warmup_variants", None)
                if callable(variants):
                    self.warmup_variants[name] = variants()
        return report

    async def aclose(self) -> None:
        """Close the components that hold resources (a generative unit's
        scheduler)."""
        for _, comp in self.iter_components():
            closer = getattr(comp, "close", None)
            if closer is not None:
                res = closer()
                if asyncio.iscoroutine(res):
                    await res

    # -- prediction walk --------------------------------------------------

    async def predict(self, payload: Payload, trace: bool = False) -> Payload:
        """Walk the graph.  ``trace`` records each node's wall time (its
        children included) into ``meta.tags["sct_trace_ms"]``."""
        if not trace:
            return await self._execute(self.root, payload)
        timings: dict[str, float] = {}
        out = await self._execute(self.root, payload, timings)
        out.meta.tags["sct_trace_ms"] = {k: round(v * 1000.0, 3) for k, v in timings.items()}
        return out

    async def _execute(self, node: _NodeState, p: Payload,
                       timings: dict | None = None) -> Payload:
        if timings is None:
            return await self._execute_inner(node, p, timings)
        t0 = time.perf_counter()
        try:
            return await self._execute_inner(node, p, timings)
        finally:
            timings[node.spec.name] = time.perf_counter() - t0

    async def _execute_inner(self, node: _NodeState, p: Payload,
                             timings: dict | None = None) -> Payload:
        if node.spec.type == UnitType.CASCADE_ROUTER and node.children:
            return await self._execute_cascade(node, p, timings)
        methods = node.methods
        if Method.TRANSFORM_INPUT in methods:
            if (self.node_cache is not None and node.deterministic
                    and node.spec.type == UnitType.MODEL):
                p = await self._model_cached(node, p)
            else:
                p = await node.client.transform_input(p)
        if node.children:
            branch = ROUTE_ALL
            if Method.ROUTE in methods:
                branch = await node.client.route(p)
                p.meta.routing[node.spec.name] = branch
            if branch == ROUTE_ALL:
                results = list(await asyncio.gather(
                    *(self._execute(c, p, timings) for c in node.children)))
            else:
                if not 0 <= branch < len(node.children):
                    raise GraphUnitError(
                        f"unit {node.spec.name!r} routed to child {branch} "
                        f"but has {len(node.children)} children"
                    )
                results = [await self._execute(node.children[branch], p, timings)]
            if Method.AGGREGATE in methods:
                p = await node.client.aggregate(results)
            elif len(results) == 1:
                p = results[0]
            else:
                raise GraphUnitError(
                    f"unit {node.spec.name!r} has {len(results)} child outputs and no combiner"
                )
        if Method.TRANSFORM_OUTPUT in methods:
            p = await node.client.transform_output(p)
        return p

    async def _model_cached(self, node: _NodeState, p: Payload) -> Payload:
        """A deterministic MODEL node through the node tier: an exact repeat
        of its input skips the component (and its device step); a payload
        with nothing hashable goes to the component."""
        key = payload_cache_key(p)
        if key is None:
            return await node.client.transform_input(p)
        ns = node.spec.name
        entry = self.node_cache.get(ns, key)
        if entry is not None:
            data, names, kind = entry.value
            p.meta.request_path.setdefault(ns, "cache")
            return Payload(data=data, names=list(names), kind=kind, meta=p.meta)
        out = await node.client.transform_input(p)
        nbytes = out.data.nbytes if isinstance(out.data, np.ndarray) else len(out.data or b"")
        self.node_cache.put(ns, key, (out.data, list(out.names), out.kind), nbytes=nbytes)
        return out

    async def _execute_cascade(self, node: _NodeState, p: Payload,
                               timings: dict | None = None) -> Payload:
        """CASCADE_ROUTER: walk the ordered tiers cheapest first.  After
        each tier but the last answers, the component's ``decide`` reads
        the confidence the tier's reply carries and the request's remaining
        deadline budget; escalation walks the NEXT tier with the ORIGINAL
        payload (whose meta the earlier tier has annotated: tags, metrics
        and request path accumulate, as in the JAX walker).  The chosen
        tier's reply ships unmodified, and the tier index lands in
        ``meta.routing`` for the feedback walk."""
        comp = node.component
        n_tiers = len(node.children)
        tier = 0
        out = await self._execute(node.children[0], p, timings)
        while tier < n_tiers - 1:
            escalate, _reason = comp.decide(comp.read_confidence(out), tier, n_tiers)
            if not escalate:
                break
            note_esc = getattr(comp, "note_escalation", None)
            if callable(note_esc):
                note_esc()
            tier += 1
            out = await self._execute(node.children[tier], p, timings)
        p.meta.routing[node.spec.name] = tier
        note = getattr(comp, "note_served", None)
        if callable(note):
            note(tier)
        node.client._annotate(out)
        return out

    # -- feedback walk ----------------------------------------------------

    async def send_feedback(self, fb: FeedbackPayload) -> None:
        """Replay the routed path recorded in ``response.meta.routing``,
        delivering the reward to every unit with SEND_FEEDBACK on it; a
        node with no recorded branch passes the feedback to every child."""
        await self._feedback(self.root, fb)

    async def _feedback(self, node: _NodeState, fb: FeedbackPayload) -> None:
        routing_map = fb.response.meta.routing if fb.response is not None else {}
        branch = routing_map.get(node.spec.name)
        if Method.SEND_FEEDBACK in node.methods:
            await node.client.send_feedback(fb, branch)
            if self._feedback_hook is not None:
                self._feedback_hook(node.spec.name, fb)
        if not node.children:
            return
        if branch is not None and 0 <= branch < len(node.children):
            await self._feedback(node.children[branch], fb)
        else:
            await asyncio.gather(*(self._feedback(c, fb) for c in node.children))


def walker_from_predictor(predictor: PredictorSpec, components: dict[str, Any] | None = None,
                          *, device: str = "cuda") -> GraphWalker:
    return GraphWalker(predictor.graph, components=components, device=device)
