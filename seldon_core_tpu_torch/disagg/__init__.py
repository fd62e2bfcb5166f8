"""Disaggregated prefill/decode serving: engine roles.

The port's copy of the JAX package's ``disagg/__init__.py`` role rules.
An engine boots as ``prefill``, ``decode`` or ``unified`` (``--role`` or
``SCT_ENGINE_ROLE``).  A prefill engine prefills, exports the prompt's
paged-KV blocks and the first sampled token in a handoff frame
(``disagg/handoff.py``) and POSTs it to one of its decode peers
(``--disagg-decode`` or ``SCT_DISAGG_DECODE``); a decode engine imports
the blocks into its own pool and decodes.  A failed handoff falls back to
local decode on the prefill engine and leaks no block.  The gateway's
replica router is ``disagg/router.py``.
"""

from __future__ import annotations

import os

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_UNIFIED = "unified"
ROLES = (ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED)

ROLE_ENV = "SCT_ENGINE_ROLE"
DECODE_UPSTREAMS_ENV = "SCT_DISAGG_DECODE"


def resolve_role(value: str | None = None, environ: dict | None = None) -> str:
    """Engine role: ``value``, else ``SCT_ENGINE_ROLE``, else unified.  An
    unknown role raises ``ValueError`` at boot: a mistyped role must never
    serve as a unified engine inside a split pool."""
    env = environ if environ is not None else os.environ
    role = (value or env.get(ROLE_ENV, "") or ROLE_UNIFIED).strip().lower()
    if role not in ROLES:
        raise ValueError(f"engine role {role!r} is not one of {', '.join(ROLES)}")
    return role


def decode_upstreams(value: str | None = None, environ: dict | None = None) -> list[str]:
    """A prefill engine's decode peers: a comma-separated ``host:port`` list
    (``value``, else ``SCT_DISAGG_DECODE``)."""
    env = environ if environ is not None else os.environ
    raw = value if value is not None else env.get(DECODE_UPSTREAMS_ENV, "")
    return [u.strip() for u in raw.split(",") if u.strip()]


__all__ = [
    "ROLE_PREFILL", "ROLE_DECODE", "ROLE_UNIFIED", "ROLES", "ROLE_ENV", "DECODE_UPSTREAMS_ENV",
    "resolve_role", "decode_upstreams",
]
