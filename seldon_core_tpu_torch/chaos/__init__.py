"""Deterministic fault injection for the serving plane: the port's copy of
the JAX package's ``chaos`` package (docs/RESILIENCE.md).

Seeded, site-registered fault points on the hops that can fail in
production, so that a recovery path is exercised by injected failure.
In the port four sites have a caller: the engine's KV handoff POST
(``disagg.handoff.send``, which a live drain's migration rides), its peer
prefix pull (``disagg.prefix.pull``), the gateway's forward of its
fallback cores (``gw.forward``) and its splice front's upstream send
(``gw.h1``).

Activation is one environment variable, read at import::

    SCT_CHAOS_PLAN="disagg.handoff.send:torn:only=1"
    SCT_CHAOS_SEED=7     # probabilistic rules replay identically per seed

With the plan unset :data:`ENABLED` is False and every site costs one
module-attribute check; the decode loop carries no site at all.  The plan
grammar and the site registry live in :mod:`seldon_core_tpu_torch.chaos.plan`.

One verb call per hop, so each request counts one arrival::

    from seldon_core_tpu_torch import chaos
    ...
    if chaos.ENABLED:
        frame = await chaos.act("disagg.handoff.send", frame)

:func:`act` interprets every kind: raisable kinds raise (reset ->
``ConnectionResetError``, timeout -> ``TimeoutError``, ioerror ->
``OSError``, exit -> ``os._exit``), slow/hang await their delay, torn
returns a truncated payload.  :func:`fire` raises the raisable kinds,
:func:`mangle` tears a payload, and :func:`check` returns the rule for
sites with semantics of their own.  Every verb is a no-op for rules bound
to other sites.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading

from seldon_core_tpu_torch.chaos.plan import (  # noqa: F401  (re-exported)
    KINDS,
    SITES,
    FaultPlan,
    PlanError,
    Rule,
    parse_plan,
)

__all__ = [
    "ENABLED", "SITES", "KINDS", "FaultPlan", "PlanError", "Rule",
    "parse_plan", "configure", "configure_from_env", "reset", "check",
    "fire", "mangle", "pause", "act", "snapshot",
]

# False means every site is one attribute check and nothing below runs
ENABLED = False

_plan: FaultPlan | None = None
_rng = random.Random(0)
_arrivals: dict[str, int] = {}
_fired: dict[str, int] = {}
_lock = threading.Lock()


def configure(plan_text: str | None, seed: int = 0) -> None:
    """(Re)arm the chaos plane from a plan string; None or empty disarms."""
    global ENABLED, _plan, _rng
    with _lock:
        _arrivals.clear()
        _fired.clear()
        if not plan_text:
            ENABLED = False
            _plan = None
            return
        _plan = parse_plan(plan_text, seed)
        _rng = random.Random(seed)
        ENABLED = bool(_plan.rules)


def configure_from_env(environ=None) -> None:
    """Arm from ``SCT_CHAOS_PLAN`` and ``SCT_CHAOS_SEED`` (default 0)."""
    env = os.environ if environ is None else environ
    configure(env.get("SCT_CHAOS_PLAN") or None, int(env.get("SCT_CHAOS_SEED") or 0))


def reset() -> None:
    """Disarm and zero all counters."""
    configure(None)


def check(site: str) -> Rule | None:
    """Record one arrival at ``site``; the triggered rule, or None."""
    if site not in SITES:
        raise PlanError(f"unregistered chaos site {site!r}")
    if _plan is None:
        return None
    with _lock:
        _arrivals[site] = arrival = _arrivals.get(site, 0) + 1
        for rule in _plan.for_site(site):
            if rule.matches(arrival, _rng):
                _fired[site] = _fired.get(site, 0) + 1
                return rule
    return None


def _raise_kind(site: str, rule: Rule) -> None:
    if rule.kind == "reset":
        raise ConnectionResetError(f"chaos[{site}]: injected connection reset")
    if rule.kind == "timeout":
        raise TimeoutError(f"chaos[{site}]: injected timeout")
    if rule.kind == "ioerror":
        raise OSError(f"chaos[{site}]: injected I/O error")
    if rule.kind == "exit":
        os._exit(rule.code)


def fire(site: str) -> None:
    """Raise the site's injected failure, if the plan says so now (the
    other kinds are consumed without effect)."""
    rule = check(site)
    if rule is not None:
        _raise_kind(site, rule)


def _delay_s(rule: Rule) -> float:
    return (rule.delay_ms if rule.kind == "slow" else max(rule.delay_ms, 60_000.0)) / 1e3


async def act(site: str, payload: bytes | None = None) -> bytes | None:
    """ONE arrival, fully interpreted: raisable kinds raise, slow/hang await
    their delay, torn returns the truncated ``payload``; anything else
    passes ``payload`` through."""
    rule = check(site)
    if rule is None:
        return payload
    _raise_kind(site, rule)
    if rule.kind == "torn" and payload is not None:
        return payload[: max(1, int(len(payload) * rule.frac))]
    if rule.kind in ("slow", "hang"):
        await asyncio.sleep(_delay_s(rule))
    return payload


def mangle(site: str, data: bytes) -> bytes:
    """Tear a byte payload per the plan."""
    rule = check(site)
    if rule is None or rule.kind != "torn":
        return data
    return data[: max(1, int(len(data) * rule.frac))]


async def pause(site: str) -> None:
    """Inject a slow or hung peer: await the rule's delay."""
    rule = check(site)
    if rule is not None and rule.kind in ("slow", "hang"):
        await asyncio.sleep(_delay_s(rule))


def snapshot() -> dict:
    """Per-site arrival and firing counters (``GET /stats/chaos``)."""
    with _lock:
        return {
            "enabled": ENABLED,
            "arrivals": dict(_arrivals),
            "fired": dict(_fired),
            "rules": [{"site": r.site, "kind": r.kind, "fired": r.fired}
                      for r in (_plan.rules if _plan else [])],
        }


# arm from the environment at import: an engine picks the plan up with no
# wiring, and an unset plan stays inert
configure_from_env()
