"""The content-addressed response cache: LRU, TTL and a byte bound.  The
port's copy of the JAX package's ``cache/content.py``; its key functions
give the JAX package's digests byte for byte.

A key is a SHA-256 over (route, the deployment's spec hash, the canonical
request payload): the same request is the same key, and a changed spec
changes every key, so a rolling update cannot hit the old entries.
Entries are namespaced per deployment (or graph node) so one namespace
flushes alone.  Every operation is O(1) under one lock (the node tier
runs on the walker's thread pool), and the cache is bounded by an entry
count and a byte budget.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np

from seldon_core_tpu_torch.obs.metering import METER
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS

# -- keying ------------------------------------------------------------------


def spec_hash(spec: Any) -> str:
    """Short deterministic hash of a predictor spec (a dict or the port's
    spec dataclasses): the JAX package's hash of the same spec, since the
    dataclasses dump every field the pydantic model dumps."""
    if dataclasses.is_dataclass(spec) and not isinstance(spec, type):
        spec = dataclasses.asdict(spec)  # str enums serialize as their values
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def request_key(route: str, spec_hash_: str, body: bytes) -> str:
    """Content address of one request: route + spec hash + payload bytes."""
    h = hashlib.sha256()
    h.update(route.encode())
    h.update(b"\x00")
    h.update(spec_hash_.encode())
    h.update(b"\x00")
    h.update(body)
    return h.hexdigest()


def canonical_body(body: Any) -> bytes:
    """Canonical JSON bytes of a parsed body: key order and whitespace do
    not change the address."""
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def payload_cache_key(p: Any) -> str | None:
    """Content address of a graph Payload (the walker's node tier): array
    bytes, shape, dtype and names for numeric kinds, the raw data for
    string and bytes kinds; None when nothing in it is hashable."""
    h = hashlib.sha256()
    kind = getattr(p, "kind", None)
    if kind is not None:
        h.update(str(kind).encode())
        h.update(b"\x00")
    data = getattr(p, "data", None)
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    elif isinstance(data, (bytes, bytearray)):
        h.update(bytes(data))
    elif isinstance(data, str):
        h.update(data.encode())
    else:
        return None
    for n in getattr(p, "names", []) or []:
        h.update(b"\x00")
        h.update(str(n).encode())
    return h.hexdigest()


# -- the cache ---------------------------------------------------------------


class _Entry:
    __slots__ = ("value", "nbytes", "expires", "status")

    def __init__(self, value: Any, nbytes: int, expires: float, status: int):
        self.value = value
        self.nbytes = nbytes
        self.expires = expires
        self.status = status


class ResponseCache:
    """Namespaced LRU with a TTL and a byte budget.  ``tier`` names it
    ("engine" / "node"); the namespace is the deployment or node an entry
    belongs to, so :meth:`flush` drops one without touching the others."""

    def __init__(self, tier: str, max_entries: int = 4096, max_bytes: int = 64 * 1024 * 1024,
                 ttl_s: float = 60.0):
        self.tier = tier
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple[str, str], _Entry]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.flushes = 0
        self.flushes_by_ns: dict[str, int] = {}

    def get(self, namespace: str, key: str) -> _Entry | None:
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get((namespace, key))
            if entry is not None and now >= entry.expires:
                del self._entries[(namespace, key)]
                self.bytes -= entry.nbytes
                self.expirations += 1
                entry = None
            if entry is None:
                self.misses += 1
                DEFAULT_METRICS.cache_misses.labels(self.tier, namespace).inc()
                return None
            self._entries.move_to_end((namespace, key))
            self.hits += 1
            DEFAULT_METRICS.cache_hits.labels(self.tier, namespace).inc()
        # a hit is a request its tenant got for free: metered per namespace
        METER.add(namespace, requests_cached=1)
        return entry

    def put(self, namespace: str, key: str, value: Any, nbytes: int | None = None,
            status: int = 200) -> None:
        if nbytes is None:
            nbytes = len(value) if isinstance(value, (bytes, bytearray)) else 0
        if nbytes > self.max_bytes:
            return  # larger than the whole budget: not cacheable
        entry = _Entry(value, int(nbytes), time.monotonic() + self.ttl_s, status)
        with self._lock:
            old = self._entries.pop((namespace, key), None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[(namespace, key)] = entry
            self.bytes += entry.nbytes
            while self._entries and (len(self._entries) > self.max_entries
                                     or self.bytes > self.max_bytes):
                _, evicted = self._entries.popitem(last=False)
                self.bytes -= evicted.nbytes
                self.evictions += 1
            self._set_gauges()

    def flush(self, namespace: str | None = None) -> int:
        """Drop one namespace's entries, or every entry when ``namespace``
        is None; returns how many went."""
        with self._lock:
            n = _flush_locked(self, namespace)
            self._set_gauges()
            return n

    def _set_gauges(self) -> None:
        DEFAULT_METRICS.cache_entries.labels(self.tier).set(len(self._entries))
        DEFAULT_METRICS.cache_bytes.labels(self.tier).set(self.bytes)

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "tier": self.tier,
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "evictions": self.evictions,
                "expirations": self.expirations,
                "flushes": self.flushes,
                "flushes_by_namespace": dict(self.flushes_by_ns),
            }


def _flush_locked(cache, namespace: str | None) -> int:
    """A namespace flush of a cache whose entries are keyed by
    ``(namespace, ...)`` (both response tiers); the cache's lock is held."""
    entries = cache._entries
    if namespace is None:
        flushed_ns = {k[0] for k in entries}
        n = len(entries)
        entries.clear()
        cache.bytes = 0
    else:
        doomed = [k for k in entries if k[0] == namespace]
        flushed_ns = {namespace} if doomed else set()
        n = len(doomed)
        for k in doomed:
            cache.bytes -= entries.pop(k).nbytes
    if n:
        cache.flushes += 1
        for ns in flushed_ns:
            cache.flushes_by_ns[ns] = cache.flushes_by_ns.get(ns, 0) + 1
    return n


# -- env config --------------------------------------------------------------


def cache_enabled(environ: dict | None = None) -> bool:
    env = environ if environ is not None else os.environ
    return env.get("SCT_CACHE", "0") == "1"


def cache_deployments(environ: dict | None = None) -> frozenset[str] | None:
    """``SCT_CACHE_DEPLOYMENTS``: the comma-separated deployments the cache
    applies to; unset or empty means every deployment."""
    env = environ if environ is not None else os.environ
    raw = env.get("SCT_CACHE_DEPLOYMENTS", "").strip()
    if not raw:
        return None
    return frozenset(s.strip() for s in raw.split(",") if s.strip())


def response_cache_from_env(tier: str, environ: dict | None = None) -> ResponseCache | None:
    """A configured cache, or None with ``SCT_CACHE`` unset.  Knobs:
    ``SCT_CACHE_TTL_S`` (60), ``SCT_CACHE_MAX_BYTES`` (64 MiB),
    ``SCT_CACHE_MAX_ENTRIES`` (4096)."""
    env = environ if environ is not None else os.environ
    if not cache_enabled(env):
        return None
    return ResponseCache(
        tier,
        max_entries=int(env.get("SCT_CACHE_MAX_ENTRIES", "4096")),
        max_bytes=int(env.get("SCT_CACHE_MAX_BYTES", str(64 * 1024 * 1024))),
        ttl_s=float(env.get("SCT_CACHE_TTL_S", "60")),
    )
