"""Host-DRAM stores: the tiered prefix KV store under the radix index
(:class:`HostPrefixStore`) and the suspend store of preempted or drained
generations (:class:`SuspendStore`).

The port's copy of the JAX package's ``cache/tiers.py``.  A :class:`~seldon_core_tpu_torch.cache.prefix.
PrefixIndex` eviction under pool pressure drops blocks that cost a
prefill to rebuild; with the tier on (``prefix_dram_gb``) the evicted
chain levels are fetched to the host once (at an admission sync point,
never inside a decode block) and kept here in the pool's own storage
representation (int8 blocks and scales on an int8 pool), the same bytes a
handoff frame carries, so promoting them back is bit-exact.  A radix match
that runs past the index into a demoted chain promotes the levels with
one indexed copy into the pool instead of a prefill.

Keys are the index's: ``(adapter salt, raw int32 bytes of
tokens[:k * block_size])`` per chain level, so the routing digests match.
Under its byte bound the store evicts the chains cheapest to rebuild
first (depth x block count), and never drops a deeper chain to make room
for a shallower one.  Entries hold torch CPU tensors (or numpy arrays):
anything with ``nbytes``.

The suspend store holds whole-slot suspend records, each one handoff
frame, under a byte bound it never evicts to meet: an over-budget put is
refused and the slot keeps running.
"""

from __future__ import annotations

import threading

import numpy as np

from seldon_core_tpu_torch.cache.prefix import chain_hash


class _HostEntry:
    __slots__ = ("depth", "k", "v", "k_scale", "v_scale", "nbytes", "tick")

    def __init__(self, depth, k, v, k_scale, v_scale, tick):
        self.depth = int(depth)
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.nbytes = int(
            k.nbytes + v.nbytes
            + (k_scale.nbytes if k_scale is not None else 0)
            + (v_scale.nbytes if v_scale is not None else 0)
        )
        self.tick = tick

    @property
    def cost(self) -> int:
        # rebuild cost: chain depth x block count (1 block per entry)
        return self.depth


class HostPrefixStore:
    """Byte-bounded host-DRAM tier for demoted prefix-chain KV blocks.

    Thread-safe: demotion and promotion run on the scheduler's admission
    thread while peer-pull exports read from the engine's request
    handlers.  ``on_bytes`` (when given) is called with the store's live
    byte total after every mutation."""

    def __init__(
        self,
        block_size: int,
        budget_bytes: int,
        on_bytes=None,
    ):
        self.block_size = int(block_size)
        self.budget_bytes = max(0, int(budget_bytes))
        self._entries: dict[tuple, _HostEntry] = {}
        self._lock = threading.Lock()
        self._tick = 0
        self._on_bytes = on_bytes
        self.bytes = 0
        # per-tier telemetry (the model's prefix_snapshot()["tiers"]["dram"])
        self.hits = 0  # matches that found >=1 demoted level
        self.misses = 0  # lookups that found nothing to promote
        self.promotions = 0  # levels promoted back to HBM
        self.demotions = 0  # levels absorbed from HBM evictions
        self.evictions = 0  # levels dropped under the byte bound
        self.rejected = 0  # demotions refused (would evict deeper chains)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _note_bytes(self) -> None:
        if self._on_bytes is not None:
            self._on_bytes(self.bytes)

    @staticmethod
    def level_key(tokens: np.ndarray, k: int, block_size: int, salt: bytes) -> tuple:
        return (
            salt,
            np.ascontiguousarray(
                np.asarray(tokens, np.int32).ravel()[: k * block_size]
            ).tobytes(),
        )

    # -- demotion (HBM -> DRAM) ------------------------------------------

    def put(
        self,
        key: tuple,
        depth: int,
        k: np.ndarray,
        v: np.ndarray,
        k_scale: "np.ndarray | None" = None,
        v_scale: "np.ndarray | None" = None,
    ) -> bool:
        """Absorb one evicted chain level.  Returns False when the entry
        cannot fit: bigger than the whole budget, or room could only be
        made by evicting chains MORE expensive to rebuild (a shallow
        chain never displaces a deep one)."""
        entry = _HostEntry(depth, k, v, k_scale, v_scale, 0)
        with self._lock:
            self._tick += 1
            entry.tick = self._tick
            if entry.nbytes > self.budget_bytes:
                self.rejected += 1
                return False
            prior = self._entries.pop(key, None)
            if prior is not None:
                self.bytes -= prior.nbytes
            need = self.bytes + entry.nbytes - self.budget_bytes
            if need > 0 and not self._evict_locked(need, max_cost=entry.cost):
                self.rejected += 1
                if prior is not None:  # keep what we had
                    self._entries[key] = prior
                    self.bytes += prior.nbytes
                return False
            self._entries[key] = entry
            self.bytes += entry.nbytes
            self.demotions += 1
            self._note_bytes()
            return True

    def _evict_locked(self, need_bytes: int, max_cost: "int | None" = None) -> bool:
        """Free ``need_bytes`` by dropping the cheapest-to-rebuild CHAINS
        first.  A candidate's score is the rebuild cost of everything its
        eviction dooms — chain depth x block count over the entry plus
        every level that EXTENDS it (so a chain never strands an
        unreachable tail, and a cheap root never smuggles out an
        expensive chain: the tail's cost is in the score).  With
        ``max_cost``, victim sets scoring above it are untouchable;
        returns False (nothing evicted) when the need cannot be covered
        without them."""
        if need_bytes <= 0:
            return True
        scored = []
        for key, e in self._entries.items():
            exts = [
                kk for kk in self._entries
                if kk != key and kk[0] == key[0] and kk[1].startswith(key[1])
            ]
            chain_depth = max(
                [e.depth] + [self._entries[kk].depth for kk in exts]
            )
            scored.append((chain_depth * (1 + len(exts)), e.tick, key, exts))
        doomed: list[tuple] = []
        covered = 0
        seen: set = set()
        for cost, _tick, key, exts in sorted(
            scored, key=lambda s: (s[0], s[1], s[2])
        ):
            if covered >= need_bytes:
                break
            if max_cost is not None and cost > max_cost:
                break
            if key in seen:
                continue
            for kk in (key, *exts):
                if kk in seen:
                    continue
                seen.add(kk)
                doomed.append(kk)
                covered += self._entries[kk].nbytes
        if covered < need_bytes:
            return False
        for kk in doomed:
            self.bytes -= self._entries.pop(kk).nbytes
        self.evictions += len(doomed)
        self._note_bytes()
        return True

    # -- lookup / promotion (DRAM -> HBM) --------------------------------

    def match(
        self,
        tokens: np.ndarray,
        start_level: int,
        stop_level: int,
        salt: bytes = b"",
    ) -> list[tuple]:
        """Contiguous demoted chain levels ``start_level..stop_level`` for
        ``tokens`` — ``[(key, depth, k, v, k_scale, v_scale), ...]``.
        Entries are NOT removed (call :meth:`drop` once the promotion
        scatter lands); the arrays are the stored ones, safe to read
        because entries are immutable once put."""
        tokens = np.asarray(tokens, np.int32).ravel()
        out: list[tuple] = []
        with self._lock:
            self._tick += 1
            for lvl in range(int(start_level), int(stop_level) + 1):
                e = self._entries.get(
                    self.level_key(tokens, lvl, self.block_size, salt)
                )
                if e is None:
                    break
                e.tick = self._tick
                out.append(
                    (
                        self.level_key(tokens, lvl, self.block_size, salt),
                        e.depth, e.k, e.v, e.k_scale, e.v_scale,
                    )
                )
            if out:
                self.hits += 1
            else:
                self.misses += 1
        return out

    def peek_depth(
        self,
        tokens: np.ndarray,
        start_level: int,
        stop_level: int,
        salt: bytes = b"",
    ) -> int:
        """Deepest contiguous demoted level in ``start_level..stop_level``
        (0 when ``start_level`` itself is absent).  A pure probe — no
        hit/miss counters, no LRU ticks — used by the peer-pull client to
        decide whether a pull would gain anything."""
        tokens = np.asarray(tokens, np.int32).ravel()
        depth = int(start_level) - 1
        with self._lock:
            for lvl in range(int(start_level), int(stop_level) + 1):
                if (
                    self.level_key(tokens, lvl, self.block_size, salt)
                    not in self._entries
                ):
                    break
                depth = lvl
        return max(0, depth) if depth >= int(start_level) else 0

    def drop(self, keys) -> None:
        """Remove promoted levels (their KV now lives in HBM again)."""
        with self._lock:
            n = 0
            for key in keys:
                e = self._entries.pop(key, None)
                if e is not None:
                    self.bytes -= e.nbytes
                    n += 1
            self.promotions += n
            if n:
                self._note_bytes()

    def flush(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes = 0
            self._note_bytes()

    # -- gossip / telemetry ----------------------------------------------

    def digest(self, max_entries: int = 4096) -> dict:
        """Routing digest of the DRAM-held chains — same hash scheme as
        ``PrefixIndex.digest`` so the gateway's ``RouterPoller`` merges
        both tiers into one per-replica chain set (a replica holding a
        chain in DRAM can still serve it warm via one promotion
        scatter)."""
        with self._lock:
            items = sorted(
                self._entries.items(), key=lambda kv: -kv[1].depth
            )[: max(0, int(max_entries))]
            return {
                "block_size": self.block_size,
                "entries": len(self._entries),
                "truncated": len(self._entries) > len(items),
                "hashes": [chain_hash(k[0] + k[1]) for k, _ in items],
                "depths": [e.depth for _, e in items],
            }

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "evictions": self.evictions,
                "rejected": self.rejected,
            }


class SuspendStore:
    """Byte-bounded host-DRAM store of whole-slot suspend records: the
    prefix tier's machinery generalized from chain levels to whole
    preempted generations.

    Each record is ONE encoded handoff frame (codec v4: prompt and emitted
    tokens, the carry token, the generation options and the slot's paged-
    KV blocks, int8 blocks and scales verbatim on a quantized pool), so a
    resume rides the import path and is bit-exact by construction.

    The store NEVER evicts: a record is a live generation's only copy of
    its KV.  An over-budget ``put``, or one under a key already held, is
    refused and the caller leaves that slot resident.  ``on_bytes`` is
    called with the live byte total after every change (the generative
    model wires it to the host ledger's ``suspend_dram`` class)."""

    def __init__(self, budget_bytes: int, on_bytes=None):
        self.budget_bytes = max(0, int(budget_bytes))
        self._frames: dict = {}
        self._lock = threading.Lock()
        self._on_bytes = on_bytes
        self.bytes = 0
        self.puts = 0
        self.takes = 0
        self.rejected = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)

    def _note_bytes(self) -> None:
        if self._on_bytes is not None:
            self._on_bytes(self.bytes)

    def put(self, key, frame: bytes) -> bool:
        """Park one suspend record; False when it cannot fit or ``key`` is
        taken (the caller keeps that slot running)."""
        n = len(frame)
        with self._lock:
            if self.bytes + n > self.budget_bytes or key in self._frames:
                self.rejected += 1
                return False
            self._frames[key] = frame
            self.bytes += n
            self.puts += 1
            self._note_bytes()
            return True

    def take(self, key) -> "bytes | None":
        """Pop one record (for a resume, a migration, or discarding a
        request that ended while it was parked)."""
        with self._lock:
            frame = self._frames.pop(key, None)
            if frame is not None:
                self.bytes -= len(frame)
                self.takes += 1
                self._note_bytes()
            return frame

    def flush(self) -> None:
        with self._lock:
            self._frames.clear()
            self.bytes = 0
            self._note_bytes()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "records": len(self._frames),
                "bytes": self.bytes,
                "budget_bytes": self.budget_bytes,
                "puts": self.puts,
                "takes": self.takes,
                "rejected": self.rejected,
            }
