"""Per-predictor prediction service: the graph walker over the whole
tree plus request-scope logic (puid assignment), the feedback walk, the
graph's generative units, the response tiers and the transports to the
graph's remote units (``engine/transport.py``).

The spec hash (``cache/content.py``) is folded into every response-cache
key, so another spec never serves this one's entries.  With ``SCT_CACHE=1``
(and ``SCT_CACHE_DEPLOYMENTS``, when set, naming this deployment) the
service holds the walker's node tier, the engine's exact tier and the
request collapser; ``SCT_SEMCACHE=1`` adds the semantic tier.

The predictor comes from ``ENGINE_PREDICTOR`` (base64 JSON, the same
variable the JAX engine reads), else ``./deploymentdef.json``, else the
built-in SIMPLE_MODEL graph.  ``ENGINE_CO_PREDICTORS`` (a base64 JSON list
of predictor specs) names the deployments an engine boots beside it on the
same card, time-sharing it under the device arbiter (chip packing).
"""

from __future__ import annotations

import base64
import json
import os
import uuid
from typing import Any

from seldon_core_tpu_torch.cache import (
    SingleFlight,
    cache_deployments,
    response_cache_from_env,
    semantic_cache_from_env,
    spec_hash,
)
from seldon_core_tpu_torch.contract.payload import FeedbackPayload, Payload
from seldon_core_tpu_torch.engine.transport import TransportManager
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.graph.walker import GraphWalker
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS
from seldon_core_tpu_torch.utils.metrics import MetricsRegistry

ENGINE_PREDICTOR_ENV = "ENGINE_PREDICTOR"
# chip packing: a base64 JSON list of ADDITIONAL predictor specs booted in
# the same process, time-sharing the card
ENGINE_CO_PREDICTORS_ENV = "ENGINE_CO_PREDICTORS"
PREDICTOR_FILE_FALLBACK = "./deploymentdef.json"

DEFAULT_PREDICTOR: dict[str, Any] = {
    "name": "default",
    "graph": {
        "name": "simple-model",
        "type": "MODEL",
        "implementation": "SIMPLE_MODEL",
    },
}


def load_predictor_spec(environ: dict[str, str] | None = None) -> PredictorSpec:
    """Resolve the predictor: env ``ENGINE_PREDICTOR`` (base64 JSON) ->
    ``./deploymentdef.json`` -> the built-in SIMPLE_MODEL default."""
    env = environ if environ is not None else os.environ
    raw = env.get(ENGINE_PREDICTOR_ENV)
    if raw:
        return PredictorSpec.from_dict(json.loads(base64.b64decode(raw)))
    if os.path.exists(PREDICTOR_FILE_FALLBACK):
        with open(PREDICTOR_FILE_FALLBACK) as f:
            return PredictorSpec.from_dict(json.load(f))
    return PredictorSpec.from_dict(DEFAULT_PREDICTOR)


def load_co_predictor_specs(environ: dict[str, str] | None = None) -> list[PredictorSpec]:
    """The co-resident predictor specs of chip packing: ``ENGINE_CO_PREDICTORS``
    is a base64 JSON list of predictor specs, booted beside the primary as
    further :class:`PredictionService` s that time-share the card under
    the device arbiter.  Empty when unset."""
    env = environ if environ is not None else os.environ
    raw = env.get(ENGINE_CO_PREDICTORS_ENV)
    if not raw:
        return []
    decoded = json.loads(base64.b64decode(raw))
    if not isinstance(decoded, list):
        raise ValueError(f"{ENGINE_CO_PREDICTORS_ENV} must decode to a JSON list of "
                         "predictor specs")
    return [PredictorSpec.from_dict(p) for p in decoded]


class PredictionService:
    """Owns one predictor's walker and transports for the process lifetime.
    Units are built on ``device`` by :meth:`start` (a blocking call: it
    loads the models); ``components`` (unit name -> component) mounts
    in-process components in place of the built-in registry's; a unit
    behind a REST endpoint is called over HTTP within
    ``transport_timeout_s`` a hop.  ``deployment_name`` (the engine's
    ``SELDON_DEPLOYMENT_ID``) names the deployment on every metric label,
    wire edge, meter key and cache allow-list check; empty, the
    predictor's name does."""

    def __init__(self, predictor: PredictorSpec, *, device: str = "cuda",
                 components: dict[str, Any] | None = None,
                 transport_timeout_s: float = 5.0, metrics: MetricsRegistry | None = None,
                 deployment_name: str = ""):
        self.predictor = predictor
        self.metrics = metrics or DEFAULT_METRICS
        self.warmup_report: dict[str, int] = {}
        self.deployment_name = deployment_name or predictor.name
        self.device = device
        self._components = components or {}
        self.transports = TransportManager(timeout_s=transport_timeout_s, device=device)
        self.walker: GraphWalker | None = None
        self.spec_hash = spec_hash(predictor)
        allowed = cache_deployments()
        cache_on = allowed is None or self.deployment_name in allowed
        self.node_cache = response_cache_from_env("node") if cache_on else None
        self.response_cache = response_cache_from_env("engine") if cache_on else None
        self.semantic_cache = semantic_cache_from_env() if cache_on else None
        self.collapse = SingleFlight()

    def start(self) -> None:
        self.walker = GraphWalker(self.predictor.graph, components=self._components,
                                  client_factory=self.transports.client_factory,
                                  feedback_hook=self._on_feedback,
                                  device=self.device, node_cache=self.node_cache)

    def _walker(self) -> GraphWalker:
        if self.walker is None:
            raise RuntimeError("PredictionService.start() not called")
        return self.walker

    async def warmup(self) -> dict[str, int]:
        self.warmup_report = await self._walker().warmup()
        return self.warmup_report

    def warmup_snapshot(self) -> dict[str, Any]:
        """``GET /stats/warmup``'s per-unit part: warm-up runs, wall
        seconds, and the programs (buckets, window graphs) each made."""
        w = self.walker
        return {"programs": dict(self.warmup_report),
                "seconds": dict(w.warmup_seconds) if w is not None else None,
                "variants": dict(w.warmup_variants) if w is not None else None}

    def _on_feedback(self, unit_name: str, fb: FeedbackPayload) -> None:
        self.metrics.feedback.labels(self.deployment_name, self.predictor.name,
                                     unit_name).inc()
        self.metrics.feedback_reward.labels(self.deployment_name, self.predictor.name,
                                            unit_name).inc(fb.reward)

    async def predict(self, payload: Payload) -> Payload:
        walker = self._walker()
        if not payload.meta.puid:
            payload.meta.puid = uuid.uuid4().hex
        out = await walker.predict(payload)
        if out.meta.metrics:  # a user model's custom metrics
            self.metrics.record_custom(self.deployment_name, self.predictor.name,
                                       self.predictor.graph.name, out.meta.metrics)
        return out

    async def send_feedback(self, fb: FeedbackPayload) -> None:
        """Replay the routed path of ``fb.response`` with its reward."""
        await self._walker().send_feedback(fb)

    def graph_deterministic(self) -> bool:
        """Whether every unit of the graph declares determinism."""
        return self.walker is not None and self.walker.deterministic()

    def cache_snapshot(self) -> dict:
        """The ``GET /stats/cache`` payload: the response tiers, the
        collapser and each generative unit's prefix index."""
        out: dict = {
            "spec_hash": self.spec_hash,
            "graph_deterministic": self.walker.deterministic() if self.walker else None,
            "collapse": self.collapse.snapshot(),
        }
        for key, cache in (("response", self.response_cache), ("semantic", self.semantic_cache),
                           ("node", self.node_cache)):
            if cache is not None:
                out[key] = cache.snapshot()
        if self.walker is not None:
            prefix = {u.model.name: snap for u in self.generative_units()
                      if (snap := u.model.prefix_snapshot()) is not None}
            if prefix:
                out["prefix"] = prefix
        return out

    def generative_units(self) -> list:
        """Every generative component of the graph, in walk order."""
        from seldon_core_tpu_torch.executor.generation import GenerativeComponent

        return [comp for _, comp in self._walker().iter_components()
                if isinstance(comp, GenerativeComponent)]

    async def close(self) -> None:
        if self.walker is not None:
            await self.walker.aclose()
        await self.transports.close()
