"""KV prefix reuse index: token-id prefixes -> paged KV blocks.

The port's copy of the JAX package's ``cache/prefix.py`` (numpy and
hashlib only), with the same keys byte for byte, so both packages index a
prompt alike and publish the same routing digests.

RadixAttention-style sharing (SGLang) on top of the paged KV pool
(``executor/generation.py``): prompts that share a prefix (the shared
system prompt of a chat deployment, few-shot preambles) reuse the KV
blocks the prefix already produced instead of prefilling them again, so
prefill device time scales with the novel suffix only.

Design constraints that keep it exact:

* only FULL blocks are shared (prefix length rounded down to the block
  size): K/V at position ``i`` depends causally on tokens ``<= i`` alone,
  so a full block of identical leading tokens holds the same K/V no
  matter what follows;
* shared blocks are IMMUTABLE by construction: decode writes at
  positions >= the full prompt length, which always land in the slot's
  own (non-shared) blocks, so "copy-on-write on divergence" degenerates
  to "diverging requests simply never share the diverging block";
* entries are ref-counted while a slot uses them and evicted only at
  zero refs, cheapest-to-rebuild chain first (rebuild cost = chain depth
  x block count, LRU tick breaking ties) and always with every extension
  of the victim so a chain never orphans its tail.

The index is host-side state of the model; the physical block ids it
hands out go into the slot's table row.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np


def chain_hash(key: bytes) -> str:
    """Stable 64-bit-hex digest of one prefix-chain key (the raw int32
    bytes of ``tokens[:k*block_size]``, optionally prefixed by an adapter
    salt).  The JAX package's gateway router hashes a request's leading
    blocks the same way and matches them against the digests each replica
    publishes, without ever shipping raw token ids off-engine."""
    return hashlib.sha256(key).hexdigest()[:16]


def adapter_salt(adapter: "str | None") -> bytes:
    """Chain-key salt for one LoRA adapter.

    LoRA on the attention projections changes K/V, so a prefix block
    produced under adapter A must never serve adapter B, or the base
    model.  Folding the adapter NAME into every chain key partitions the
    index per adapter; no adapter (the base model) keeps the unsalted
    keys, ``b""``."""
    return (str(adapter).encode("utf-8") + b"\x00") if adapter else b""


class _PrefixEntry:
    __slots__ = ("block", "refs", "tick", "depth")

    def __init__(self, block: int, tick: int, depth: int):
        self.block = int(block)
        self.refs = 0
        self.tick = tick
        self.depth = depth  # chain level (1-based block count)


class PrefixIndex:
    """token-prefix chain -> physical KV block ids, ref-counted.

    Keys are the raw bytes of ``tokens[:k * block_size]`` for each chain
    level ``k`` — a flattened radix trie: the longest match is the largest
    ``k`` whose key is present (levels are only ever inserted bottom-up
    and evicted top-down, so presence of level ``k`` implies 1..k-1)."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._entries: dict[bytes, _PrefixEntry] = {}
        self._lock = threading.Lock()
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.inserted = 0
        self.evicted = 0
        self.tokens_reused = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def blocks_held(self) -> int:
        """Blocks owned by the index (evictable when refs drop to 0)."""
        return len(self._entries)

    def _key(self, tokens: np.ndarray, k: int, salt: bytes = b"") -> tuple:
        # (salt, token bytes) as a TUPLE: concatenating could make one
        # adapter's key a byte-prefix of another's (or of an unsalted
        # chain), which would confuse the eviction extension scan
        return (
            salt,
            np.ascontiguousarray(
                tokens[: k * self.block_size], np.int32
            ).tobytes(),
        )

    # -- lookup --------------------------------------------------------------

    def match(
        self, tokens: np.ndarray, max_blocks: int, salt: bytes = b""
    ) -> list[int]:
        """Longest chain of full prefix blocks for ``tokens`` (capped at
        ``max_blocks``); ref-counts every matched entry.  Pair each call
        with exactly one :meth:`release` for the same tokens/length.
        ``salt`` partitions chains per LoRA adapter (:func:`adapter_salt`):
        adapter-tagged chains never match across adapters."""
        tokens = np.asarray(tokens, np.int32).ravel()
        blocks: list[int] = []
        with self._lock:
            self._tick += 1
            for k in range(1, max_blocks + 1):
                e = self._entries.get(self._key(tokens, k, salt))
                if e is None:
                    break
                blocks.append(e.block)
            for k in range(1, len(blocks) + 1):
                e = self._entries[self._key(tokens, k, salt)]
                e.refs += 1
                e.tick = self._tick
            if blocks:
                self.hits += 1
                self.tokens_reused += len(blocks) * self.block_size
            else:
                self.misses += 1
        return blocks

    def acquire(
        self, tokens: np.ndarray, max_blocks: int, salt: bytes = b""
    ) -> list[tuple]:
        """Like :meth:`match` but for an EXPORT pin, not an admission:
        refs the longest chain without touching the hit/miss counters or
        the LRU ticks, and returns ``[(key, depth, block), ...]`` so the
        caller can fetch the pinned blocks.  Pair with one
        :meth:`release` for ``len(result)`` levels — while the pin is
        held, eviction cannot free (or demote) the chain out from under
        a concurrent peer-pull export."""
        tokens = np.asarray(tokens, np.int32).ravel()
        out: list[tuple] = []
        with self._lock:
            for k in range(1, max_blocks + 1):
                key = self._key(tokens, k, salt)
                e = self._entries.get(key)
                if e is None:
                    break
                out.append((key, k, e.block))
            for key, _k, _b in out:
                self._entries[key].refs += 1
        return out

    def peek_depth(
        self, tokens: np.ndarray, max_blocks: int, salt: bytes = b""
    ) -> int:
        """Longest-match depth WITHOUT taking refs or counting a hit —
        the peer-pull client uses this to decide whether a pull would
        beat what is already resident."""
        tokens = np.asarray(tokens, np.int32).ravel()
        with self._lock:
            depth = 0
            for k in range(1, max_blocks + 1):
                if self._key(tokens, k, salt) not in self._entries:
                    break
                depth = k
        return depth

    def release(
        self, tokens: np.ndarray, n_blocks: int, salt: bytes = b""
    ) -> None:
        """Drop the refs :meth:`match` took (entries stay, evictable)."""
        tokens = np.asarray(tokens, np.int32).ravel()
        with self._lock:
            for k in range(1, n_blocks + 1):
                e = self._entries.get(self._key(tokens, k, salt))
                if e is not None and e.refs > 0:
                    e.refs -= 1

    def ref_range(
        self,
        tokens: np.ndarray,
        start_level: int,
        end_level: int,
        salt: bytes = b"",
    ) -> None:
        """Take refs on levels ``start_level+1 .. end_level`` — the
        promotion path refs freshly-inserted levels so one
        ``release(tokens, end_level)`` at slot teardown covers matched
        and promoted levels alike."""
        tokens = np.asarray(tokens, np.int32).ravel()
        with self._lock:
            for k in range(int(start_level) + 1, int(end_level) + 1):
                e = self._entries.get(self._key(tokens, k, salt))
                if e is not None:
                    e.refs += 1

    # -- insertion -----------------------------------------------------------

    def insert(
        self,
        tokens: np.ndarray,
        blocks: list[int],
        start_level: int,
        salt: bytes = b"",
    ) -> list[int]:
        """Register chain levels ``start_level+1 .. start_level+len(blocks)``
        (0-based ``start_level`` = blocks already in the index) with the
        given physical blocks.  Returns the blocks the index did NOT absorb
        (level already present from a concurrent identical prompt) — the
        caller returns those duplicates to the free pool."""
        tokens = np.asarray(tokens, np.int32).ravel()
        rejected: list[int] = []
        with self._lock:
            self._tick += 1
            level = start_level
            for block in blocks:
                level += 1
                key = self._key(tokens, level, salt)
                if key in self._entries:
                    rejected.append(int(block))
                    continue
                # a gap below this level (concurrent eviction) would orphan
                # the entry — only chain onto a present parent
                if level > 1 and self._key(
                    tokens, level - 1, salt
                ) not in self._entries:
                    rejected.append(int(block))
                    continue
                self._entries[key] = _PrefixEntry(block, self._tick, level)
                self.inserted += 1
        return rejected

    # -- eviction ------------------------------------------------------------

    def evict(self, need: int) -> list[int]:
        """Free up to ``need`` blocks from zero-ref entries; see
        :meth:`evict_entries` for the ordering."""
        return [block for _key, _depth, block in self.evict_entries(need)]

    def evict_entries(self, need: int) -> list[tuple]:
        """Free up to ``need`` blocks from zero-ref entries and return
        ``[(key, depth, block), ...]`` for every victim, so a host-DRAM
        tier can absorb the evicted chain levels before
        their physical blocks are recycled.

        Victims are picked cheapest-to-rebuild chain first: each
        candidate is scored by chain depth x block count (its own depth
        times the levels that would go down with it — extensions of a
        zero-ref entry are provably zero-ref themselves: a slot holding
        level k holds refs on 1..k), LRU tick breaking ties.  A one-block
        throwaway prompt is evicted long before the 40-block system
        prompt that costs a 640-token prefill to rebuild.  Evicting an
        entry also evicts every entry that EXTENDS it, so a chain never
        orphans its tail."""
        victims: list[tuple] = []
        with self._lock:
            if need <= 0 or not self._entries:
                return victims
            zero_ref = [
                (key, e) for key, e in self._entries.items() if e.refs == 0
            ]
            scored = []
            for key, e in zero_ref:
                n_ext = sum(
                    1 for k in self._entries
                    if k != key and k[0] == key[0] and k[1].startswith(key[1])
                )
                # rebuild cost of the chain rooted here: depth x blocks
                scored.append((e.depth * (1 + n_ext), e.tick, key))
            doomed: set = set()
            for _cost, _tick, key in sorted(scored):
                if len(victims) >= need:
                    break
                if key in doomed:
                    continue
                exts = [
                    k for k in self._entries
                    if k != key and k[0] == key[0] and k[1].startswith(key[1])
                ]
                for k in (*exts, key):
                    if k in doomed:
                        continue
                    doomed.add(k)
                    e = self._entries[k]
                    victims.append((k, e.depth, e.block))
            for k in doomed:
                del self._entries[k]
            self.evicted += len(doomed)
        return victims

    def flush(self) -> list[int]:
        """Drop every ZERO-REF entry (model reset / manual flush); returns
        the freed blocks.  Referenced entries stay — their slots still
        read them."""
        with self._lock:
            doomed = [k for k, e in self._entries.items() if e.refs == 0]
            freed = [self._entries.pop(k).block for k in doomed]
            self.evicted += len(doomed)
            return freed

    def digest(self, max_entries: int = 4096) -> dict:
        """Compact routing digest: chain hashes + depths of the entries this
        index holds (``GET /stats/cache``).  The gateway's prefix-aware
        router matches request prompts against these; the hash (not the
        tokens) crosses the wire, and ``max_entries`` bounds the payload —
        deepest chains first, since those are the matches worth routing
        for."""
        with self._lock:
            items = sorted(
                self._entries.items(), key=lambda kv: -kv[1].depth
            )[: max(0, int(max_entries))]
            return {
                "block_size": self.block_size,
                "entries": len(self._entries),
                "truncated": len(self._entries) > len(items),
                # hash of salt + raw bytes: exactly what the gateway's
                # prompt_chain_hashes computes for (adapter, tokens)
                "hashes": [chain_hash(k[0] + k[1]) for k, _ in items],
                "depths": [e.depth for _, e in items],
            }

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "block_size": self.block_size,
                "entries": len(self._entries),
                "referenced": sum(1 for e in self._entries.values() if e.refs),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "inserted": self.inserted,
                "evicted": self.evicted,
                "tokens_reused": self.tokens_reused,
            }
