"""In-memory request/response payload for the data plane.

A copy of the JAX package's ``contract/payload.py`` for the port (which
imports nothing of the JAX package).  The wire format (JSON) is decoded
exactly once at the boundary into :class:`Payload` — a thin record holding
a numpy array (or bytes / str) plus metadata — and the graph walk operates
on it.  Device transfer happens only inside the executor.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np


class DataKind(enum.Enum):
    """Which member of the SeldonMessage data oneof the payload came from.

    Preserved across graph nodes so the response is encoded the same way the
    request was (the reference preserves ndarray-vs-tensor encoding too,
    reference: engine/.../predictors/PredictorUtils.java:107-127).
    """

    TENSOR = "tensor"
    NDARRAY = "ndarray"
    RAW = "rawTensor"
    BINARY = "binData"
    STRING = "strData"
    EMPTY = "empty"


@dataclasses.dataclass
class Metric:
    """A custom metric emitted by user model code."""

    key: str
    type: str = "COUNTER"  # COUNTER | GAUGE | TIMER
    value: float = 0.0


@dataclasses.dataclass
class Meta:
    """Request metadata threaded through the graph.

    ``puid`` correlates a request end-to-end (reference:
    engine/.../service/PredictionService.java:52-58); ``routing`` records the
    child index each router chose, which the feedback walk replays
    (reference: engine/.../predictors/PredictiveUnitBean.java:126-168);
    ``tags`` are merged across every node's response.
    """

    puid: str = ""
    tags: dict[str, Any] = dataclasses.field(default_factory=dict)
    routing: dict[str, int] = dataclasses.field(default_factory=dict)
    request_path: dict[str, str] = dataclasses.field(default_factory=dict)
    metrics: list[Metric] = dataclasses.field(default_factory=list)

    def merge_from(self, other: "Meta") -> None:
        """Merge another node's response meta into this one."""
        if other.puid:
            self.puid = other.puid
        self.tags.update(other.tags)
        self.routing.update(other.routing)
        self.request_path.update(other.request_path)
        self.metrics.extend(other.metrics)


@dataclasses.dataclass
class Payload:
    """The unit of data flowing through the inference graph."""

    data: np.ndarray | bytes | str | None = None
    names: list[str] = dataclasses.field(default_factory=list)
    kind: DataKind = DataKind.EMPTY
    meta: Meta = dataclasses.field(default_factory=Meta)

    @classmethod
    def from_array(
        cls,
        array: np.ndarray,
        names: list[str] | None = None,
        kind: DataKind = DataKind.NDARRAY,
        meta: Meta | None = None,
    ) -> "Payload":
        return cls(
            data=np.asarray(array),
            names=list(names or []),
            kind=kind,
            meta=meta or Meta(),
        )

    @property
    def array(self) -> np.ndarray:
        """The numeric payload; raises if this payload is not numeric."""
        if not isinstance(self.data, np.ndarray):
            raise TypeError(
                f"payload holds {self.kind.value!r} data, not a numeric array"
            )
        return self.data

    def is_numeric(self) -> bool:
        return isinstance(self.data, np.ndarray)

    def with_array(self, array: np.ndarray, names: list[str] | None = None) -> "Payload":
        """A new payload with replaced numeric data, preserving encoding+meta."""
        kind = self.kind
        if kind in (DataKind.BINARY, DataKind.STRING, DataKind.EMPTY):
            kind = DataKind.NDARRAY
        return Payload(
            data=np.asarray(array),
            names=list(names) if names is not None else list(self.names),
            kind=kind,
            meta=self.meta,
        )


@dataclasses.dataclass
class FeedbackPayload:
    """A reward signal for the feedback walk (reference: proto/prediction.proto
    ``Feedback{request, response, reward, truth}``)."""

    request: Payload | None = None
    response: Payload | None = None
    reward: float = 0.0
    truth: Payload | None = None
