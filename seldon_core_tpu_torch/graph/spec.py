"""Inference-graph specification: the JSON a SeldonDeployment-style
resource declares, parsed with dataclasses.

The same JSON as the JAX package's ``graph/spec.py`` (there parsed by
pydantic): a tree of predictive units.  Unknown keys are ignored, as
pydantic does by default; a wrong type or enum value raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

from seldon_core_tpu_torch.contract.parameters import parse_parameters


class UnitType(str, enum.Enum):
    MODEL = "MODEL"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"
    CASCADE_ROUTER = "CASCADE_ROUTER"
    GUARDRAIL = "GUARDRAIL"


class Implementation(str, enum.Enum):
    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"
    EPSILON_GREEDY = "EPSILON_GREEDY"
    THOMPSON_SAMPLING = "THOMPSON_SAMPLING"
    MAHALANOBIS_OUTLIER = "MAHALANOBIS_OUTLIER"
    JAX_MODEL = "JAX_MODEL"
    JAX_GENERATIVE = "JAX_GENERATIVE"
    CASCADE_ROUTER = "CASCADE_ROUTER"
    GUARDRAIL = "GUARDRAIL"


class Method(str, enum.Enum):
    TRANSFORM_INPUT = "TRANSFORM_INPUT"
    TRANSFORM_OUTPUT = "TRANSFORM_OUTPUT"
    ROUTE = "ROUTE"
    AGGREGATE = "AGGREGATE"
    SEND_FEEDBACK = "SEND_FEEDBACK"


class TransportType(str, enum.Enum):
    REST = "REST"
    GRPC = "GRPC"
    LOCAL = "LOCAL"


TYPE_METHODS: dict[UnitType, list[Method]] = {
    UnitType.MODEL: [Method.TRANSFORM_INPUT],
    UnitType.ROUTER: [Method.ROUTE, Method.SEND_FEEDBACK],
    UnitType.COMBINER: [Method.AGGREGATE],
    UnitType.TRANSFORMER: [Method.TRANSFORM_INPUT],
    UnitType.OUTPUT_TRANSFORMER: [Method.TRANSFORM_OUTPUT],
    UnitType.CASCADE_ROUTER: [Method.SEND_FEEDBACK],
    UnitType.GUARDRAIL: [Method.TRANSFORM_INPUT],
}


def _obj(d: Any, what: str) -> dict:
    if not isinstance(d, dict):
        raise ValueError(f"{what} must be a JSON object, got {type(d).__name__}")
    return d


def _str(d: dict, key: str, default: Any = dataclasses.MISSING) -> str:
    if key not in d:
        if default is dataclasses.MISSING:
            raise ValueError(f"missing required field {key!r}")
        return default
    value = d[key]
    if not isinstance(value, str):
        raise ValueError(f"field {key!r} must be a string, got {value!r}")
    return value


@dataclasses.dataclass
class Endpoint:
    service_host: str = ""
    service_port: int = 0
    type: TransportType = TransportType.LOCAL

    @classmethod
    def from_dict(cls, d: Any) -> "Endpoint":
        d = _obj(d, "endpoint")
        return cls(
            service_host=_str(d, "service_host", ""),
            service_port=int(d.get("service_port", 0)),
            type=TransportType(d.get("type", "LOCAL")),
        )


@dataclasses.dataclass
class Parameter:
    name: str
    value: str
    type: str = "STRING"

    @classmethod
    def from_dict(cls, d: Any) -> "Parameter":
        d = _obj(d, "parameter")
        value = d.get("value")
        if isinstance(value, (bool, int, float)):
            value = str(value)  # pydantic's lax mode coerces scalars the same way
        if not isinstance(value, str):
            raise ValueError(f"parameter value must be a string, got {value!r}")
        return cls(name=_str(d, "name"), value=value, type=_str(d, "type", "STRING"))


@dataclasses.dataclass
class PredictiveUnitSpec:
    """One node of the inference graph."""

    name: str
    children: list["PredictiveUnitSpec"] = dataclasses.field(default_factory=list)
    type: Optional[UnitType] = None
    implementation: Implementation = Implementation.UNKNOWN_IMPLEMENTATION
    methods: Optional[list[Method]] = None
    endpoint: Endpoint = dataclasses.field(default_factory=Endpoint)
    parameters: list[Parameter] = dataclasses.field(default_factory=list)

    def resolved_methods(self) -> list[Method]:
        """Explicit methods win; otherwise derived from type."""
        if self.methods is not None:
            return self.methods
        if self.type is not None:
            return TYPE_METHODS[self.type]
        return []

    def parameters_dict(self) -> dict[str, Any]:
        return parse_parameters([dataclasses.asdict(p) for p in self.parameters])

    def iter_nodes(self):
        """Pre-order traversal."""
        yield self
        for child in self.children:
            yield from child.iter_nodes()

    @classmethod
    def from_dict(cls, d: Any) -> "PredictiveUnitSpec":
        d = _obj(d, "graph unit")
        methods = d.get("methods")
        utype = d.get("type")
        return cls(
            name=_str(d, "name"),
            children=[cls.from_dict(c) for c in d.get("children") or []],
            type=None if utype is None else UnitType(utype),
            implementation=Implementation(
                d.get("implementation") or "UNKNOWN_IMPLEMENTATION"
            ),
            methods=None if methods is None else [Method(m) for m in methods],
            endpoint=Endpoint.from_dict(d.get("endpoint") or {}),
            parameters=[Parameter.from_dict(p) for p in d.get("parameters") or []],
        )


@dataclasses.dataclass
class PredictorSpec:
    """A deployable predictor: a graph plus replica/annotation config."""

    name: str
    graph: PredictiveUnitSpec
    replicas: int = 1
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    version: str = ""

    @classmethod
    def from_dict(cls, d: Any) -> "PredictorSpec":
        d = _obj(d, "predictor")
        if "graph" not in d:
            raise ValueError("missing required field 'graph'")
        return cls(
            name=_str(d, "name"),
            graph=PredictiveUnitSpec.from_dict(d["graph"]),
            replicas=int(d.get("replicas", 1)),
            annotations={str(k): str(v) for k, v in (d.get("annotations") or {}).items()},
            labels={str(k): str(v) for k, v in (d.get("labels") or {}).items()},
            version=_str(d, "version", ""),
        )
