"""Request-scoped QoS context: deadline and priority propagation.

The port's copy of the JAX package's ``qos/context.py``.  A client stamps
``x-sct-deadline-ms`` (the REMAINING time budget in milliseconds) and
optionally ``x-sct-priority`` (``interactive`` | ``batch``).  Ingress turns
the budget into an ABSOLUTE monotonic deadline held in a contextvar, which
every later stage of the request (the graph walk, the cascade's
escalation gate, the batching queue, the generation scheduler) reads
without plumbing.  An outgoing hop re-serializes
the header with the budget left.

asyncio tasks inherit contextvars, so the walker's fan-out sees the
ingress deadline; a call run on the thread pool with
``loop.run_in_executor`` does not (the pool thread has its own context).
"""

from __future__ import annotations

import contextvars
import os
import time

DEADLINE_HEADER = "x-sct-deadline-ms"
PRIORITY_HEADER = "x-sct-priority"

PRIO_INTERACTIVE = "interactive"
PRIO_BATCH = "batch"
_PRIORITIES = (PRIO_INTERACTIVE, PRIO_BATCH)
PACK_SLO_ENV = "SCT_PACK_SLO_MS"

# absolute time.monotonic() deadline of the current request (None = no SLO)
_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "sct_qos_deadline", default=None
)
_priority: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sct_qos_priority", default=PRIO_INTERACTIVE
)
# the Retry-After hint (delta-seconds) set where a shed was decided, read
# where the wire reply is built
_retry_after: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "sct_qos_retry_after", default=None
)


def set_retry_after(value: str | None) -> None:
    _retry_after.set(value)


def get_retry_after() -> str | None:
    return _retry_after.get()


def parse_deadline_ms(value) -> float | None:
    """Strict parse of an ``x-sct-deadline-ms`` value: a positive finite
    number of milliseconds, else None (a malformed SLO degrades to "no
    SLO", never to a crash or an instant timeout)."""
    if value is None:
        return None
    if isinstance(value, bytes):
        value = value.decode("latin-1", "replace")
    try:
        ms = float(value)
    except (TypeError, ValueError):
        return None
    if not (ms > 0.0) or ms != ms or ms == float("inf"):
        return None
    return ms


def parse_priority(value) -> str:
    """``interactive`` unless the client explicitly says ``batch``: an
    unknown class never lands in the lower tier by typo."""
    if isinstance(value, bytes):
        value = value.decode("latin-1", "replace")
    if isinstance(value, str) and value.strip().lower() == PRIO_BATCH:
        return PRIO_BATCH
    return PRIO_INTERACTIVE


def priority_rank(priority: str) -> int:
    """Lower rank pops first."""
    return 0 if priority == PRIO_INTERACTIVE else 1


def pack_slo_ms(default: float = 250.0) -> float:
    """The interactive queue-wait SLO band of a packed card
    (``SCT_PACK_SLO_MS``): the device arbiter preempts a batch co-tenant
    when an interactive deployment's queue-wait pressure crosses it."""
    try:
        return float(os.environ.get(PACK_SLO_ENV, "") or default)
    except ValueError:
        return default


def set_budget_ms(budget_ms: float | None) -> None:
    """Seed this request's absolute deadline from a remaining-ms budget
    (None clears: a fresh ingress must not inherit a stale deadline)."""
    if budget_ms is None:
        _deadline.set(None)
    else:
        _deadline.set(time.monotonic() + budget_ms / 1e3)


def set_deadline(deadline: float | None) -> None:
    _deadline.set(deadline)


def get_deadline() -> float | None:
    return _deadline.get()


def remaining_s(deadline: float | None = None) -> float | None:
    """Seconds left on ``deadline`` (default: the context's), None = no SLO.
    May be negative: callers tell "expired" from "unbounded"."""
    d = _deadline.get() if deadline is None else deadline
    if d is None:
        return None
    return d - time.monotonic()


def expired(deadline: float | None = None) -> bool:
    r = remaining_s(deadline)
    return r is not None and r <= 0.0


def set_priority(priority: str) -> None:
    _priority.set(priority if priority in _PRIORITIES else PRIO_INTERACTIVE)


def get_priority() -> str:
    return _priority.get()


def seed_from_headers(deadline_value, priority_value) -> tuple[float | None, str]:
    """Ingress helper: parse and seed both contextvars in one shot (an
    absent header resets its variable) and clear a stale Retry-After hint;
    returns ``(budget_ms, priority)`` as parsed."""
    budget_ms = parse_deadline_ms(deadline_value)
    priority = parse_priority(priority_value)
    set_budget_ms(budget_ms)
    set_priority(priority)
    _retry_after.set(None)
    return budget_ms, priority


def outgoing_qos_headers() -> dict[str, str]:
    """Headers for a downstream hop: the deadline re-stamped with the budget
    REMAINING now (never below 1 ms: 0 or less would parse as "no SLO"
    downstream), plus the priority class when it is not the default.  {}
    when the request carries no SLO."""
    out: dict[str, str] = {}
    r = remaining_s()
    if r is not None:
        out[DEADLINE_HEADER] = str(max(1.0, round(r * 1e3, 3)))
    if _priority.get() == PRIO_BATCH:
        out[PRIORITY_HEADER] = PRIO_BATCH
    return out
