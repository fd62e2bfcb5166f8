"""Per-tenant usage metering: who spent the device.  The port's copy of
the JAX package's ``obs/metering.py``.

:class:`UsageMeter` is a process-wide table of cumulative counters keyed
by ``(deployment, adapter, qos_class)``:

* **device seconds**: each decode block's seconds (read from CUDA events
  at the block's one fetch) split over the slots it served by token
  share; a batching queue's step charges its whole device time to the
  owning deployment;
* **tokens**: prefilled, decoded, accepted drafts, and prefix tokens
  saved per tier;
* **costs of failure**: shed and reaped requests, and the decode tokens
  spent on requests that were later reaped (``tokens_wasted``);
* **packing**: the wall seconds the device arbiter granted a deployment
  (``grant_s``) and the bytes x seconds its suspend records were parked
  (``suspend_byte_s``).

Every ``add`` uses values the host already holds at a sync point; nothing
here reads a device tensor.  The table keeps at most
``SCT_METER_MAX_KEYS`` rows (LRU); an evicted row folds into ``other``,
so totals are conserved.  ``SCT_METER=0`` turns it off.  ``/prometheus``
exports the top ``SCT_METER_TOP_K`` rows (default 16) by device time and
sums the rest into one ``other`` row (:meth:`UsageMeter.export_rows`).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

ENABLE_ENV = "SCT_METER"
MAX_KEYS_ENV = "SCT_METER_MAX_KEYS"
TOP_K_ENV = "SCT_METER_TOP_K"

# the counter vocabulary (the JAX package's)
FIELDS = (
    "device_s",            # token-share-attributed device seconds
    "grant_s",             # wall seconds the device arbiter granted
    "tokens_prefill",      # prompt tokens prefilled on the device
    "tokens_decode",       # tokens emitted by decode blocks
    "tokens_spec_accepted",  # of those, accepted drafts
    "tokens_spec_accepted_ngram",
    "tokens_spec_accepted_heads",
    "tokens_spec_accepted_draft",
    "tokens_saved_hbm",    # prefix tokens not prefilled: a pool hit
    "tokens_saved_dram",   # ... promoted from the DRAM tier
    "tokens_saved_peer",   # ... pulled from a peer
    "tokens_wasted",       # tokens spent on requests later reaped
    "requests_completed",
    "requests_shed",       # admission and queue-overflow sheds
    "requests_reaped",     # deadline reaps, disconnects, errors
    "requests_cached",     # answered from a response cache
    "suspend_byte_s",      # bytes x seconds parked in the suspend store
)

OTHER_KEY = ("other", "", "")

_SEP = "|"
_FALSY = ("", "0", "false", "off", "no")


def key_str(deployment: str, adapter: str = "", qos: str = "") -> str:
    """A meter key's wire form, ``deployment|adapter|qos``; the base model's
    adapter is the empty string."""
    return f"{deployment}{_SEP}{adapter}{_SEP}{qos}"


def split_key(key: str) -> tuple[str, str, str]:
    parts = key.split(_SEP, 2)
    parts += [""] * (3 - len(parts))
    return parts[0], parts[1], parts[2]


class UsageMeter:
    """Bounded per-tenant usage counter table (thread-safe)."""

    def __init__(self, max_keys: int | None = None, top_k: int | None = None,
                 enabled: bool | None = None):
        if max_keys is None:
            max_keys = int(os.environ.get(MAX_KEYS_ENV) or 512)
        if top_k is None:
            top_k = int(os.environ.get(TOP_K_ENV) or 16)
        if enabled is None:
            enabled = os.environ.get(ENABLE_ENV, "1").strip().lower() not in _FALSY
        self.enabled = bool(enabled)
        self.max_keys = max(1, int(max_keys))
        self.top_k = max(1, int(top_k))
        self._lock = threading.Lock()
        self._table: OrderedDict[str, dict] = OrderedDict()
        self._other: dict[str, float] = {}
        self.evicted = 0

    def add(self, deployment: str, adapter: str = "", qos: str = "", **fields: float) -> None:
        """Fold ``fields`` (of :data:`FIELDS`) into the row of
        ``(deployment, adapter, qos)``; O(1) under one lock."""
        if not self.enabled or not fields:
            return
        k = key_str(deployment, adapter, qos)
        with self._lock:
            row = self._table.get(k)
            if row is None:
                row = self._table[k] = {}
                if len(self._table) > self.max_keys:
                    _, old = self._table.popitem(last=False)
                    for f, v in old.items():
                        self._other[f] = self._other.get(f, 0.0) + v
                    self.evicted += 1
            else:
                self._table.move_to_end(k)
            for f, v in fields.items():
                row[f] = row.get(f, 0.0) + v

    def reset(self) -> None:
        with self._lock:
            self._table.clear()
            self._other.clear()
            self.evicted = 0

    def size(self) -> int:
        with self._lock:
            return len(self._table)

    def totals(self) -> dict[str, float]:
        """Every field summed over the rows and the ``other`` rollup."""
        return self.snapshot()["total"]

    def snapshot(self) -> dict:
        """The ``GET /stats/usage`` payload: every leaf but ``enabled`` is a
        number, so replicas' snapshots sum key by key."""
        with self._lock:
            keys = {k: dict(row) for k, row in self._table.items()}
            other = dict(self._other)
            evicted = self.evicted
        totals: dict[str, float] = dict(other)
        for row in keys.values():
            for f, v in row.items():
                totals[f] = totals.get(f, 0.0) + v
        return {"enabled": self.enabled, "keys": keys, "other": other,
                "evicted": evicted, "total": totals}

    def export_rows(self) -> list[tuple[tuple[str, str, str], dict]]:
        """The ``seldon_usage_*`` export: the top ``top_k`` rows by device
        seconds (then grant seconds, then tokens), the rest and the evicted
        history summed into one :data:`OTHER_KEY` row."""
        with self._lock:
            rows = [(k, dict(row)) for k, row in self._table.items()]
            other = dict(self._other)
        rows.sort(key=lambda kr: (kr[1].get("device_s", 0.0), kr[1].get("grant_s", 0.0),
                                  kr[1].get("tokens_decode", 0.0)
                                  + kr[1].get("tokens_prefill", 0.0)), reverse=True)
        out = [(split_key(k), row) for k, row in rows[:self.top_k]]
        for _, row in rows[self.top_k:]:
            for f, v in row.items():
                other[f] = other.get(f, 0.0) + v
        if other:
            out.append((OTHER_KEY, other))
        return out


# the process-wide meter
METER = UsageMeter()


def get_meter() -> UsageMeter:
    return METER
