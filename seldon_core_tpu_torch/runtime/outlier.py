"""The OUTLIER_DETECTOR service type: the port's copy of the JAX
package's ``runtime/outlier.py``.

An outlier detector is served as a transform-input service: the request
passes through unchanged while ``meta.tags.outlierScore`` carries the
per-row scores, as the reference wrapper runtime does.  A user component
needs only:

    class MyDetector:
        def score(self, X, feature_names) -> array of per-row scores

``--service-type OUTLIER_DETECTOR`` wraps it in this adapter.
"""

from __future__ import annotations

import inspect
from typing import Any

import numpy as np


class OutlierDetectorAdapter:
    """Transform-input adapter over a user ``score()`` component."""

    def __init__(self, component: Any):
        if not hasattr(component, "score"):
            raise TypeError(
                f"{type(component).__name__} has no score() method — an "
                "OUTLIER_DETECTOR component must expose "
                "score(X, feature_names)"
            )
        self.component = component
        self._last_scores: np.ndarray | None = None

    def transform_input(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        fn = self.component.score
        # reference detectors take (X, feature_names); plain scorers take X
        if len(inspect.signature(fn).parameters) >= 2:
            scores = fn(X, names)
        else:
            scores = fn(X)
        self._last_scores = np.atleast_1d(np.asarray(scores, dtype=float))
        return X

    def tags(self) -> dict[str, Any]:
        if self._last_scores is None:
            return {}
        # the reference runtime's wire tag
        return {"outlierScore": self._last_scores.tolist()}

    def metrics(self) -> list[dict[str, Any]]:
        inner = getattr(self.component, "metrics", None)
        return inner() if callable(inner) else []

    # persistence passthrough: the DETECTOR holds the online state
    def get_state(self):
        inner = getattr(self.component, "get_state", None)
        if callable(inner):
            return inner()
        raise AttributeError("component has no get_state")

    def set_state(self, state) -> None:
        inner = getattr(self.component, "set_state", None)
        if callable(inner):
            inner(state)
        else:
            raise AttributeError("component has no set_state")
