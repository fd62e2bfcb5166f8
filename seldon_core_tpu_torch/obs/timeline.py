"""Per-request generation lifecycle timelines: the port's copy of the JAX
package's ``obs/timeline.py``.

Spans answer "where did the latency go per hop"; the flight recorder
answers it per stage.  Neither can answer "what happened to THIS
generation": how deep its prefix reuse went, how its chunks paced, how
many speculative drafts its verify passes accepted, whether its decode
pipeline broke overlap and why, and how it ended.  This module is that
missing ledger — a bounded per-request event list fed by the
``GenerationScheduler`` and the disagg handoff path, keyed by the
request's trace id so ``GET /stats/timeline?trace=<id>`` reconstructs the
whole lifecycle after the fact (the packing verbs and a drain's
``drain-export`` included).

Strict no-host-sync rule: every event is stamped from values the host
ALREADY holds (fetched token counts, reservation bookkeeping, queue
state).  Nothing here may touch a device tensor: the decode loop's
one-fetch-a-block audits run with the ledger on.

Memory is bounded by construction: the ledger keeps at most
``SCT_TIMELINE_MAX`` request entries (deque, oldest evicted) of at most
``SCT_TIMELINE_EVENTS`` events each; consecutive identical events (a
parked loop re-reporting the same pause) collapse into a repeat count
instead of new rows.  ``SCT_TIMELINE=0`` disables recording entirely.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any

ENABLE_ENV = "SCT_TIMELINE"
MAX_REQUESTS_ENV = "SCT_TIMELINE_MAX"
MAX_EVENTS_ENV = "SCT_TIMELINE_EVENTS"

_FALSY = ("", "0", "false", "off", "no")

# chip-packing verbs, stamped by the scheduler when the
# device arbiter preempts a batch deployment: ``preempt`` marks the
# victim decision (attrs: victim deployment), ``suspend`` the KV export
# into the host-DRAM suspend store (attrs: blocks freed, record bytes),
# and ``resume`` the bit-exact re-import at a later admission sync point.
# All three mirror onto the request's span via the scheduler's ``_tl``.
EVENT_PREEMPT = "preempt"
EVENT_SUSPEND = "suspend"
EVENT_RESUME = "resume"


class Timeline:
    """One request's bounded, append-only event ledger."""

    __slots__ = (
        "trace_id", "model", "role", "start", "attrs", "events",
        "dropped", "done", "_max",
    )

    def __init__(
        self,
        trace_id: str | None,
        model: str,
        role: str | None,
        max_events: int,
        attrs: dict | None = None,
    ):
        self.trace_id = trace_id
        self.model = model
        self.role = role
        self.start = time.time()
        self.attrs = attrs or {}
        # rows are [name, epoch_ts, attrs, repeat_count]
        self.events: list[list] = []
        self.dropped = 0
        self.done: str | None = None
        self._max = int(max_events)

    def event(self, name: str, **attrs: Any) -> None:
        """Append one event (epoch-stamped).  A repeat of the immediately
        preceding event (same name + attrs) bumps its count instead of
        growing the list — bounded even if a parked loop re-reports."""
        ev = self.events
        if ev:
            last = ev[-1]
            if last[0] == name and last[2] == attrs:
                last[3] += 1
                return
        if len(ev) >= self._max:
            self.dropped += 1
            return
        ev.append([name, time.time(), attrs, 1])

    def end(self, reason: str, **attrs: Any) -> None:
        """Record the terminal transition (idempotent: the first terminal
        reason wins — a deadline reap must not be overwritten by the
        bookkeeping that follows it)."""
        if self.done is not None:
            return
        self.done = reason
        self.event("terminal", reason=reason, **attrs)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "model": self.model,
            "role": self.role,
            "start": self.start,
            "done": self.done,
            "attrs": self.attrs,
            "dropped": self.dropped,
            "events": [
                {"name": n, "ts": ts, "attrs": a, **({"n": c} if c > 1 else {})}
                for n, ts, a, c in self.events
            ],
        }


class TimelineLedger:
    """Process-wide bounded store of request :class:`Timeline` entries.

    ``begin`` returns the entry (or None when disabled) for the scheduler
    to append to without further lookups; ``note`` attaches an event to
    the NEWEST entry of a trace id (used by layers — the disagg handoff
    path — that hold the trace but not the handle)."""

    def __init__(
        self,
        max_requests: int | None = None,
        max_events: int | None = None,
        enabled: bool | None = None,
    ):
        if max_requests is None:
            max_requests = int(os.environ.get(MAX_REQUESTS_ENV) or 512)
        if max_events is None:
            max_events = int(os.environ.get(MAX_EVENTS_ENV) or 256)
        if enabled is None:
            enabled = os.environ.get(ENABLE_ENV, "1").strip().lower() not in _FALSY
        self.enabled = bool(enabled)
        self.max_events = max(8, int(max_events))
        self._entries: deque[Timeline] = deque(maxlen=max(1, int(max_requests)))
        self._lock = threading.Lock()
        self.begun = 0

    def begin(
        self,
        trace_id: str | None,
        *,
        model: str = "",
        role: str | None = None,
        **attrs: Any,
    ) -> Timeline | None:
        if not self.enabled:
            return None
        if role is None:
            from seldon_core_tpu_torch.obs.spans import current_engine_role

            role = current_engine_role()
        tl = Timeline(trace_id, model, role, self.max_events, attrs or None)
        with self._lock:
            self._entries.append(tl)
            self.begun += 1
        return tl

    def note(self, trace_id: str | None, name: str, **attrs: Any) -> bool:
        """Append ``name`` to the newest entry for ``trace_id`` (False when
        no entry exists — e.g. ledger disabled or already evicted)."""
        if not self.enabled or not trace_id:
            return False
        with self._lock:
            for tl in reversed(self._entries):
                if tl.trace_id == trace_id:
                    break
            else:
                return False
        tl.event(name, **attrs)
        return True

    def by_trace(self, trace_id: str) -> list[dict]:
        """Every entry recorded for ``trace_id``, oldest first — a disagg
        request shows its prefill-pool and decode-pool legs as separate
        entries sharing the trace."""
        with self._lock:
            return [
                tl.to_dict() for tl in self._entries if tl.trace_id == trace_id
            ]

    def recent(self, n: int = 20) -> list[dict]:
        with self._lock:
            out = list(self._entries)[-max(1, int(n)):]
        return [tl.to_dict() for tl in reversed(out)]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "begun": self.begun,
                "held": len(self._entries),
                "max_requests": self._entries.maxlen,
                "max_events": self.max_events,
            }


# default process-wide ledger (mirrors obs.spans.RECORDER)
TIMELINE = TimelineLedger()
