"""Named LoRA adapter registry over the stacked device pool.

The port's copy of the JAX package's ``executor/lora.py``.  The device side
is a static ``(n_layers, n_adapters, ...)`` tensor stack (``models/llama.py``
``init_lora_params``) that every prefill, decode step and captured decode
block reads; THIS module is the host-side arbitration on top of it: which
named adapter lives in which pool row, reference counts while generation
slots use a row, LRU eviction of idle rows when a new adapter needs one,
and the per-adapter serving ledger (tokens, loads, occupancy).

Row 0 is the reserved NULL adapter — all-zero factors, never evictable,
never assigned a name: a request with no adapter decodes through it
bit-identically to a lora-off build.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class AdapterPoolFull(RuntimeError):
    """Every adapter row is referenced by an in-flight generation slot;
    nothing can be evicted to make room for a new adapter."""


class UnknownAdapter(KeyError):
    """The request names an adapter this pool has never registered."""


class _Row:
    __slots__ = ("name", "refs", "tokens", "loads", "tick")

    def __init__(self) -> None:
        self.name: str | None = None
        self.refs = 0
        self.tokens = 0
        self.loads = 0
        self.tick = 0


class AdapterPool:
    """name -> pool-row registry with refcounts and LRU eviction.

    ``writer(idx, factors)`` installs one adapter's factors into device
    row ``idx`` (the GenerativeModel provides it: an in-place copy into the
    row, so captured decode blocks read the new factors).
    """

    def __init__(
        self,
        n_adapters: int,
        rank: int,
        *,
        writer: Callable[[int, Any], None],
    ):
        if int(n_adapters) < 2:
            raise ValueError(
                f"adapter pool needs >= 2 rows (row 0 is the null adapter), "
                f"got {n_adapters}"
            )
        self.n_adapters = int(n_adapters)
        self.rank = int(rank)
        self._writer = writer
        self._by_name: dict[str, int] = {}
        # row 0 = null adapter: permanently reserved, never in _rows churn
        self._rows = [_Row() for _ in range(self.n_adapters)]
        self._lock = threading.Lock()
        self._tick = 0
        self.evictions = 0
        self.loads = 0

    def __contains__(self, name: object) -> bool:
        with self._lock:
            return name in self._by_name

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_name)

    @property
    def capacity(self) -> int:
        """Rows available to NAMED adapters (the null row is reserved)."""
        return self.n_adapters - 1

    # -------------------------------------------------------- registration

    def _find_row(self) -> int:
        """A free row, else the least-recently-used zero-ref row (LRU
        eviction under pressure).  Caller holds the lock."""
        for i in range(1, self.n_adapters):
            if self._rows[i].name is None:
                return i
        victim = None
        for i in range(1, self.n_adapters):
            r = self._rows[i]
            if r.refs == 0 and (victim is None or r.tick < self._rows[victim].tick):
                victim = i
        if victim is None:
            raise AdapterPoolFull(
                f"all {self.capacity} adapter rows are referenced by "
                "in-flight requests; cannot evict"
            )
        self._by_name.pop(self._rows[victim].name, None)
        self._rows[victim] = _Row()
        self.evictions += 1
        return victim

    def register(self, name: str, factors: Any) -> int:
        """Install (or refresh) adapter ``name``'s factors; returns its
        pool row.  A new name takes a free row or LRU-evicts an idle one;
        raises :class:`AdapterPoolFull` when every row is in use."""
        name = str(name)
        if not name:
            raise ValueError("adapter name must be non-empty")
        with self._lock:
            self._tick += 1
            idx = self._by_name.get(name)
            if idx is None:
                idx = self._find_row()
                self._by_name[name] = idx
                self._rows[idx].name = name
            self._rows[idx].loads += 1
            self._rows[idx].tick = self._tick
            self.loads += 1
            # write under the lock: a concurrent register must not race the
            # row assignment (the device write itself is ordered by the
            # model lock and the stream)
            self._writer(idx, factors)
            return idx

    # ---------------------------------------------------------- admission

    def acquire(self, name: str) -> int:
        """Resolve ``name`` for one generation slot (refcount++); raises
        :class:`UnknownAdapter` on a miss — the caller maps it to a client
        error (or, on a disagg decode pool, a handoff rejection)."""
        with self._lock:
            idx = self._by_name.get(str(name))
            if idx is None:
                raise UnknownAdapter(
                    f"adapter {name!r} is not resident "
                    f"(have {sorted(self._by_name)})"
                )
            self._tick += 1
            row = self._rows[idx]
            row.refs += 1
            row.tick = self._tick
            return idx

    def release_ref(self, idx: int) -> None:
        idx = int(idx)
        if idx <= 0 or idx >= self.n_adapters:
            return
        with self._lock:
            row = self._rows[idx]
            if row.refs > 0:
                row.refs -= 1

    def note_tokens_name(self, name: str, n: int) -> bool:
        """Tokens-served tick by adapter NAME (delivery runs after a
        completed request already dropped its slot binding).  Returns
        whether the adapter is still resident (an evicted adapter's tail
        tokens are simply not attributed)."""
        if n <= 0:
            return False
        with self._lock:
            idx = self._by_name.get(str(name))
            if idx is None:
                return False
            self._rows[idx].tokens += int(n)
            return True

    def name_of(self, idx: int) -> str | None:
        idx = int(idx)
        if idx <= 0 or idx >= self.n_adapters:
            return None
        with self._lock:
            return self._rows[idx].name

    # ------------------------------------------------------------- ledger

    def snapshot(self) -> dict:
        """Per-adapter serving ledger: resident/evicted counts plus per-adapter row, slot occupancy
        (refs), tokens served, and load count."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "resident": len(self._by_name),
                "rank": self.rank,
                "evictions": self.evictions,
                "loads": self.loads,
                "adapters": {
                    r.name: {
                        "id": i,
                        "slots": r.refs,
                        "tokens": r.tokens,
                        "loads": r.loads,
                    }
                    for i, r in enumerate(self._rows)
                    if r.name is not None
                },
            }
