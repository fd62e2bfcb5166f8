"""Guardrail units: policy stages declared in the spec, not hard-coded.

The port's copy of the JAX package's ``graphllm/guardrail.py``.  A
``GUARDRAIL`` unit is a graph transformer (pre- via ``TRANSFORM_INPUT``,
post- via ``methods: [TRANSFORM_OUTPUT]`` on the unit spec) running one
policy pipeline over string payloads:

1. **block**: regexes that REJECT the request (Status FAILURE, like any
   unit error);
2. **PII scrub**: e-mail addresses, phone numbers and SSNs replaced with
   ``[REDACTED]``;
3. **stop tokens**: the text is cut at the first stop string found;
4. **length policy**: truncated to ``max_chars``;
5. **classifier hook**: a ``module:callable`` returning ``(allow,
   reason)``.

Numeric payloads pass through untouched.  A pre-guardrail re-seeds the
request's QoS priority with its own class (``qos_class`` /
``SCT_GUARDRAIL_CLASS``) for the walk downstream of it.  Every action is
counted in :attr:`Guardrail.actions`.  Without a classifier hook the
pipeline is a pure function of the text and the unit declares
``DETERMINISTIC``.
"""

from __future__ import annotations

import importlib
import os
import re
from typing import Any, Callable

from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.graph.units import GraphUnitError, SeldonComponent
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS

# conservative, low-false-positive PII patterns
_PII_PATTERNS: tuple[tuple[str, re.Pattern], ...] = (
    ("email", re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.-]+\b")),
    ("ssn", re.compile(r"\b\d{3}-\d{2}-\d{4}\b")),
    # a lookbehind, not \b: a parenthesized area code has no word boundary
    # before the "("
    ("phone", re.compile(
        r"(?<!\w)(?:\+?\d{1,2}[ .-]?)?(?:\(\d{3}\) ?|\d{3})[ .-]?\d{3}[ .-]?\d{4}\b")),
)
REDACTED = "[REDACTED]"


def _load_hook(path: str) -> Callable[[str], Any]:
    """Resolve a ``module:callable`` classifier hook."""
    mod_name, _, attr = path.partition(":")
    if not mod_name or not attr:
        raise GraphUnitError(f"classifier must be 'module:callable', got {path!r}")
    try:
        fn = getattr(importlib.import_module(mod_name), attr)
    except (ImportError, AttributeError) as e:
        raise GraphUnitError(f"cannot load classifier {path!r}: {e}") from e
    if not callable(fn):
        raise GraphUnitError(f"classifier {path!r} is not callable")
    return fn


class Guardrail(SeldonComponent):
    """Graph parameters: ``block`` (comma-separated regexes that reject,
    case-insensitive), ``scrub_pii`` (default on), ``max_chars`` (0 =
    unbounded), ``stop_tokens`` (comma-separated strings), ``classifier``
    (a ``module:callable`` hook, or a callable), ``qos_class``
    (``interactive``/``batch``; env ``SCT_GUARDRAIL_CLASS``), ``name``
    (the metrics' label)."""

    SAFE_ANNOTATIONS = True  # cumulative counters that tolerate races

    def __init__(self, block: str | None = None, scrub_pii: Any = True, max_chars: int = 0,
                 stop_tokens: str | None = None, classifier: Any = None,
                 qos_class: str | None = None, name: str = "guardrail", **_: Any):
        self.name = str(name)
        self.block_patterns: list[re.Pattern] = []
        for raw in (block or "").split(","):
            raw = raw.strip()
            if not raw:
                continue
            try:
                self.block_patterns.append(re.compile(raw, re.IGNORECASE))
            except re.error as e:
                raise GraphUnitError(f"bad block regex {raw!r}: {e}") from e
        self.scrub_pii = str(scrub_pii).lower() not in ("0", "false", "no", "")
        self.max_chars = int(max_chars)
        self.stop_tokens = [s for s in (stop_tokens or "").split(",") if s]
        if callable(classifier):
            self.classifier: Callable | None = classifier
        elif classifier:
            self.classifier = _load_hook(str(classifier))
        else:
            self.classifier = None
        self.qos_class = qos.parse_priority(
            qos_class if qos_class is not None
            else os.environ.get("SCT_GUARDRAIL_CLASS", "interactive")
        )
        # per instance: a classifier hook may be stateful
        self.DETERMINISTIC = self.classifier is None
        self.actions: dict[str, int] = {}

    def _note(self, action: str) -> None:
        self.actions[action] = self.actions.get(action, 0) + 1
        DEFAULT_METRICS.guardrail_actions.labels(self.name, action).inc()

    def apply(self, text: str) -> tuple[str, list[str]]:
        """Run the pipeline over ``text`` -> ``(clean_text, actions)``.
        Raises :class:`GraphUnitError` when a block rule or the classifier
        rejects."""
        actions: list[str] = []
        for pat in self.block_patterns:
            if pat.search(text):
                self._note("block")
                raise GraphUnitError(
                    f"guardrail {self.name!r} blocked the request (rule {pat.pattern!r})"
                )
        if self.classifier is not None:
            verdict = self.classifier(text)
            allow, reason = verdict if isinstance(verdict, tuple) else (bool(verdict), "")
            if not allow:
                self._note("block")
                raise GraphUnitError(
                    f"guardrail {self.name!r} classifier rejected the "
                    f"request{': ' + reason if reason else ''}"
                )
        if self.scrub_pii:
            scrubbed = text
            for _, pat in _PII_PATTERNS:
                scrubbed = pat.sub(REDACTED, scrubbed)
            if scrubbed != text:
                actions.append("scrub")
                self._note("scrub")
                text = scrubbed
        for stop in self.stop_tokens:
            idx = text.find(stop)
            if idx >= 0:
                text = text[:idx]
                actions.append("stop")
                self._note("stop")
                break
        if self.max_chars and len(text) > self.max_chars:
            text = text[: self.max_chars]
            actions.append("truncate")
            self._note("truncate")
        if not actions:
            self._note("pass")
        return text, actions

    def _apply_payload(self, p: Any, stage: str) -> Any:
        # downstream of a PRE-guardrail runs under the guardrail's class
        if stage == "pre" and self.qos_class != qos.get_priority():
            qos.set_priority(self.qos_class)
        if getattr(p, "kind", None) != DataKind.STRING:
            return p  # token tensors are not text
        text = p.data if isinstance(p.data, str) else p.data.decode("utf-8")
        clean, _ = self.apply(text)
        if clean is text:
            return p
        return Payload(clean, list(p.names), DataKind.STRING, p.meta)

    def transform_input_raw(self, p: Any) -> Any:
        return self._apply_payload(p, "pre")

    def transform_output_raw(self, p: Any) -> Any:
        return self._apply_payload(p, "post")

    def metrics(self) -> list[dict[str, Any]]:
        return [{"key": f"{self.name}_guardrail_{action}", "type": "GAUGE", "value": n}
                for action, n in sorted(self.actions.items())]
