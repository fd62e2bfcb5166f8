"""The ``SCT_*`` settings this port reads through typed getters: a trimmed
copy of the JAX package's ``runtime/settings.py`` registry, with the JAX
names, types and defaults.

It holds only the keys of the gateway, its replica router and the fleet
plane (collector, history rings, SLO engine) that this port reads here; the
gateway's QoS knobs (``SCT_GW_QOS_*``) are read by
``qos.AdmissionController.from_env`` under their prefix.  A call site reads a key with
:func:`get_int`, :func:`get_float`, :func:`get_bool` or :func:`get_str`; an
undeclared key raises ``KeyError``, so a default lives in one place.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

__all__ = ["Setting", "REGISTRY", "declare", "get_raw", "get_str", "get_int",
           "get_float", "get_bool"]


@dataclass(frozen=True)
class Setting:
    """One declared variable: its textual default (the string a call site
    would pass to ``os.environ.get``; None means unset), its type and a
    one-line doc."""

    name: str
    default: str | None
    type: str  # "str" | "int" | "float" | "bool"
    doc: str
    section: str


REGISTRY: dict[str, Setting] = {}

# values get_bool takes as false; anything else (a bare "set" too) is true
_FALSY = ("", "0", "false", "off", "no")


def declare(name: str, default: str | None, type: str, doc: str, *,
            section: str = "general") -> Setting:
    if name in REGISTRY:
        raise ValueError(f"duplicate setting declaration: {name}")
    if not name.startswith("SCT_"):
        raise ValueError(f"settings registry is for SCT_* vars, got {name}")
    s = Setting(name, default, type, doc, section)
    REGISTRY[name] = s
    return s


def _lookup(name: str) -> Setting:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"{name} is not declared in seldon_core_tpu_torch.runtime.settings") \
            from None


def get_raw(name: str, environ=None) -> str | None:
    """The raw environment string, else the declared default."""
    env = os.environ if environ is None else environ
    s = _lookup(name)
    v = env.get(name)
    return s.default if v is None else v


def get_str(name: str, environ=None) -> str | None:
    v = get_raw(name, environ)
    return v if v else _lookup(name).default


def get_int(name: str, environ=None) -> int:
    s = _lookup(name)
    v = get_raw(name, environ)
    try:
        return int(v or s.default or 0)
    except ValueError:
        return int(s.default or 0)


def get_float(name: str, environ=None) -> float:
    s = _lookup(name)
    v = get_raw(name, environ)
    try:
        return float(v or s.default or 0.0)
    except ValueError:
        return float(s.default or 0.0)


def get_bool(name: str, environ=None) -> bool:
    v = get_raw(name, environ)
    return (v if v is not None else "").strip().lower() not in _FALSY


# -- gateway deadlines (the gateway's QoS knobs, SCT_GW_QOS_*, are read by
# qos.AdmissionController.from_env under its prefix, as the engine's are) --
declare("SCT_DEFAULT_DEADLINE_MS", "0", "float",
        "Gateway-wide default deadline for requests without one (ms).", section="qos")

# -- gateway data plane --------------------------------------------------------
declare("SCT_REST_IMPL", "h1", "str",
        "Gateway REST server (``h1``: the splice front; ``aiohttp`` is not ported).",
        section="gateway")
declare("SCT_GW_UPSTREAM_CONNS", "8", "int",
        "Pooled upstream connections per engine endpoint.", section="gateway")
declare("SCT_GW_PIPELINE_BUF", "65536", "int",
        "Per-connection read-ahead cap while a response is in flight (bytes).",
        section="gateway")
declare("SCT_GW_ROUTE_POLL_S", "2", "float",
        "Replica /stats poll interval for prefix-affine routing (s).", section="gateway")
declare("SCT_GW_ROUTE_PREFIX", "1", "bool",
        "Longest-prefix replica routing over the replicas' polled digests.",
        section="gateway")
declare("SCT_GW_PEER_YIELD", "4", "int",
        "Inflight gap at which prefix affinity yields to load (with peer pull).",
        section="gateway")
declare("SCT_GW_POLL_FAILS", "2", "int",
        "Consecutive failed polls before the router clears a replica's digests.",
        section="resilience")
declare("SCT_GW_RETRY_BUDGET", "10", "float",
        "Per-deployment retry-budget burst.", section="resilience")
declare("SCT_GW_RETRY_RATE", "0.2", "float",
        "Retry tokens earned per forwarded request.", section="resilience")
declare("SCT_GW_RETRY_BACKOFF_MS", "25", "float",
        "Base delay of the gateway's jittered exponential retry backoff (ms).",
        section="resilience")
declare("SCT_GW_RETRY_BACKOFF_MAX_MS", "1000", "float",
        "Cap on the gateway's per-attempt retry backoff (ms).", section="resilience")
declare("SCT_GW_CB_FAILS", "3", "int",
        "Consecutive forward failures that eject a replica (0 = no breaker).",
        section="resilience")
declare("SCT_GW_CB_EJECT_S", "5", "float",
        "Ejection window before one half-open probe request.", section="resilience")
declare("SCT_SCALE", "1", "bool",
        "The operator's autoscale reconciler (the operator slice; the port's "
        "gateway refuses an explicit request for it).", section="autoscale")

# -- fleet telemetry (collector, history rings, SLO engine) ------------------
declare("SCT_FLEET", "1", "bool",
        "Run the fleet collector: per-deployment aggregation of the replicas' "
        "/stats/summary into GET /stats/fleet.", section="fleet")
declare("SCT_FLEET_POLL_S", "10", "float", "Fleet collector poll interval (s, jittered).",
        section="fleet")
declare("SCT_FLEET_JITTER", "0.2", "float", "Poll-interval jitter fraction [0, 1].",
        section="fleet")
declare("SCT_FLEET_TIMEOUT_S", "2.0", "float", "Per-replica scrape timeout (s).",
        section="fleet")
declare("SCT_FLEET_STALE_POLLS", "3", "int",
        "Polls without a successful scrape before a replica is stale.", section="fleet")
declare("SCT_FLEET_FAIL_DAMP", "3", "int",
        "Consecutive scrape failures before a replica's scrapes are damped.",
        section="fleet")
declare("SCT_FLEET_HISTORY_SLOTS", "360", "int",
        "Slots per history ring per resolution (10 s and 2 min rings).", section="fleet")
declare("SCT_SLO", "1", "bool", "Evaluate declared SLO objectives as burn rates.",
        section="fleet")
declare("SCT_SLO_DEFAULT", None, "str",
        "Fallback SLO spec for deployments without the annotation.", section="fleet")
declare("SCT_SLO_FAST_WINDOW_S", "60", "float", "Fast burn-rate window (s).",
        section="fleet")
declare("SCT_SLO_SLOW_WINDOW_S", "600", "float", "Slow burn-rate window (s).",
        section="fleet")
declare("SCT_SLO_PAGE_BURN", "14.0", "float", "Burn rate that pages.", section="fleet")
declare("SCT_SLO_WARN_BURN", "6.0", "float", "Burn rate that warns.", section="fleet")
