"""Cascade router: answer cheap when you can, escalate when you must.

The port's copy of the JAX package's ``graphllm/cascade.py``.  A
``CASCADE_ROUTER`` unit's children are an ORDERED tier list, cheapest
first.  The walker runs tier 0, reads the confidence its generative unit
put into the reply (the mean top-2 logit margin over the generated
tokens, computed inside the captured decode blocks and fetched with the
tokens: no extra host sync) and asks this component whether to escalate;
escalation walks the next tier with the ORIGINAL request.

Escalation is deadline-aware: when the request's remaining budget cannot
fit the next tier's expected time to first token (``ttft_ms`` /
``SCT_CASCADE_TTFT_MS``), the cheap answer ships.

Not deterministic: the same input escalates or not with the runtime
confidence and the request's deadline.
"""

from __future__ import annotations

import json
import os
from typing import Any

from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.graph.units import SeldonComponent
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS


class CascadeRouter(SeldonComponent):
    """The decision policy of a CASCADE_ROUTER node (the walker owns the
    tier loop; this component owns "escalate or ship").

    Graph parameters: ``threshold`` (the mean top-2 logit margin below
    which the cheap answer is not trusted; env ``SCT_CASCADE_CONF``,
    default 2.0), ``ttft_ms`` (the next tier's expected time to first
    token: escalation is skipped when the remaining deadline budget is
    smaller; env ``SCT_CASCADE_TTFT_MS``; 0 turns the gate off), ``name``
    (the metrics' label).
    """

    INLINE_SYNC = True  # microseconds of python math; skip the executor hop
    DETERMINISTIC = False  # escalation depends on confidence and deadline
    # cumulative counters that tolerate races; a lock would serialize
    # every request through the cascade
    SAFE_ANNOTATIONS = True

    def __init__(self, threshold: float | None = None, ttft_ms: float | None = None,
                 name: str = "cascade", **_: Any):
        if threshold is None:
            threshold = float(os.environ.get("SCT_CASCADE_CONF", "2.0"))
        if ttft_ms is None:
            ttft_ms = float(os.environ.get("SCT_CASCADE_TTFT_MS", "0"))
        self.threshold = float(threshold)
        self.ttft_ms = float(ttft_ms)
        self.name = str(name)
        # the served-by-tier and escalation ledger
        self.served_by_tier: dict[int, int] = {}
        self.escalations = 0
        self.last_confidence: float | None = None

    def read_confidence(self, payload: Any) -> float | None:
        """The mean confidence of a tier's reply, or None when the reply
        carries no signal (a numeric payload, ``conf_signal`` off)."""
        data = getattr(payload, "data", None)
        if not isinstance(data, (str, bytes)):
            return None
        try:
            body = json.loads(data)
        except (ValueError, TypeError):
            return None
        conf = body.get("confidence") if isinstance(body, dict) else None
        if conf is None:
            return None
        if isinstance(conf, (list, tuple)):
            vals = [float(c) for c in conf if c is not None]
            return sum(vals) / len(vals) if vals else None
        try:
            return float(conf)
        except (TypeError, ValueError):
            return None

    def decide(self, confidence: float | None, tier: int, n_tiers: int) -> tuple[bool, str]:
        """``(escalate, reason)`` after tier ``tier`` answered; never called
        for the last tier.  Reasons: ``no-signal``, ``confident``,
        ``deadline-budget``, ``low-confidence``."""
        self.last_confidence = confidence
        if confidence is not None:
            DEFAULT_METRICS.cascade_confidence.labels(self.name).set(confidence)
        if confidence is None:
            # no signal: trust the cheap tier rather than escalate blind
            return False, "no-signal"
        if confidence >= self.threshold:
            return False, "confident"
        if self.ttft_ms > 0:
            rem = qos.remaining_s()
            if rem is not None and rem * 1e3 < self.ttft_ms:
                # the next tier cannot answer in time: the cheap answer on
                # time beats a better one after the deadline
                return False, "deadline-budget"
        return True, "low-confidence"

    def note_escalation(self) -> None:
        self.escalations += 1
        DEFAULT_METRICS.cascade_escalations.labels(self.name).inc()

    def note_served(self, tier: int) -> None:
        self.served_by_tier[tier] = self.served_by_tier.get(tier, 0) + 1
        DEFAULT_METRICS.cascade_requests.labels(self.name, str(tier)).inc()

    def tags(self) -> dict[str, Any]:
        if self.last_confidence is None:
            return {}
        return {"cascade_confidence": round(self.last_confidence, 4)}

    def metrics(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = [
            {"key": f"{self.name}_cascade_escalations", "type": "GAUGE",
             "value": self.escalations}
        ]
        for tier, n in sorted(self.served_by_tier.items()):
            out.append({"key": f"{self.name}_cascade_served_tier{tier}", "type": "GAUGE",
                        "value": n})
        return out
