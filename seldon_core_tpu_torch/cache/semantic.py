"""The semantic response tier: hits on paraphrases, not only on bytes.  The
port's copy of the JAX package's ``cache/semantic.py``, with one repair.

The tier indexes normalized embedding vectors of the prompt, made by the
deployment's own pooled-embedding path (the model that will answer), and
serves a cached reply when the best match's cosine similarity clears
``SCT_SEMCACHE_SIM``.  Every entry carries the ``tag`` it was stored under;
a lookup matches only entries with the caller's tag, and :meth:`flush`
drops a namespace (a deployment) as the exact tier's flush does.

The repair (ROADMAP C7): the JAX engine tags an entry with the spec hash
alone, so a request that differs from a cached one only in
``max_new_tokens``, ``temperature`` or ``adapter`` is served the cached
reply.  :func:`semantic_tag` adds the canonical bytes of every body field
but the prompt's ``tokens``: a request hits only a reply made with the same
options.

A lookup is a brute-force dot product over the namespace's float32
vectors under one lock; the tier is bounded by an entry count and a byte
budget (vectors plus replies), oldest first.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any

import numpy as np

from seldon_core_tpu_torch.cache.content import _flush_locked, canonical_body
from seldon_core_tpu_torch.obs.metering import METER
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS


def semantic_tag(spec_hash_: str, body: dict, inner: dict) -> str:
    """The tag of a generative request's entry: the spec hash, then the
    canonical bytes of the request ``body`` with its ``strData`` replaced by
    the parsed ``inner`` body less its ``tokens``."""
    rest = dict(body)
    rest["strData"] = {k: v for k, v in inner.items() if k != "tokens"}
    return spec_hash_ + "|" + canonical_body(rest).decode()


class _Entry:
    __slots__ = ("vec", "value", "nbytes", "expires", "tag", "status")

    def __init__(self, vec, value, nbytes, expires, tag, status):
        self.vec = vec
        self.value = value
        self.nbytes = nbytes
        self.expires = expires
        self.tag = tag
        self.status = status


class SemanticCache:
    """Namespaced cosine-similarity cache over normalized prompt vectors:
    ``namespace`` is the flush granularity, ``tag`` the staleness one."""

    def __init__(self, sim_threshold: float = 0.95, max_entries: int = 2048,
                 max_bytes: int = 32 * 1024 * 1024, ttl_s: float = 300.0):
        self.sim_threshold = float(sim_threshold)
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple[str, int], _Entry]" = OrderedDict()
        self._next_id = 0
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0
        self.flushes = 0
        self.flushes_by_ns: dict[str, int] = {}
        self.last_sim: float | None = None

    @staticmethod
    def _normalize(vec: np.ndarray) -> np.ndarray:
        vec = np.asarray(vec, np.float32).ravel()
        norm = float(np.linalg.norm(vec))
        if norm <= 0.0 or not np.isfinite(norm):
            return vec
        return vec / norm

    def lookup(self, namespace: str, vec: np.ndarray, tag: str) -> Any | None:
        """The best same-tag entry of ``namespace`` with cosine >= the
        threshold, or None; ``vec`` need not be normalized."""
        q = self._normalize(vec)
        now = time.monotonic()
        with self._lock:
            best: tuple[float, tuple[str, int], _Entry] | None = None
            doomed: list[tuple[str, int]] = []
            for key, e in self._entries.items():
                if key[0] != namespace:
                    continue
                if now >= e.expires:
                    doomed.append(key)
                    continue
                if e.tag != tag or e.vec.shape != q.shape:
                    continue  # another spec or other options: never a match
                sim = float(e.vec @ q)
                if sim >= self.sim_threshold and (best is None or sim > best[0]):
                    best = (sim, key, e)
            for key in doomed:
                self.bytes -= self._entries.pop(key).nbytes
                self.expirations += 1
            if best is None:
                self.misses += 1
                self.last_sim = None
                DEFAULT_METRICS.semcache_misses.labels(namespace).inc()
                return None
            sim, key, entry = best
            self._entries.move_to_end(key)
            self.hits += 1
            self.last_sim = sim
            DEFAULT_METRICS.semcache_hits.labels(namespace).inc()
        METER.add(namespace, requests_cached=1)
        return entry.value

    def put(self, namespace: str, vec: np.ndarray, value: Any, tag: str,
            nbytes: int | None = None, status: int = 200) -> None:
        q = self._normalize(vec)
        if nbytes is None:
            nbytes = len(value) if isinstance(value, (bytes, bytearray)) else 0
        nbytes = int(nbytes) + int(q.nbytes)
        if nbytes > self.max_bytes:
            return  # larger than the whole budget: not cacheable
        entry = _Entry(q, value, nbytes, time.monotonic() + self.ttl_s, tag, status)
        with self._lock:
            self._entries[(namespace, self._next_id)] = entry
            self._next_id += 1
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
        DEFAULT_METRICS.semcache_entries.set(len(self._entries))
        DEFAULT_METRICS.semcache_bytes.set(self.bytes)

    def snapshot(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "tier": "semantic",
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "sim_threshold": self.sim_threshold,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else None,
                "last_similarity": round(self.last_sim, 4) if self.last_sim is not None else None,
                "evictions": self.evictions,
                "expirations": self.expirations,
                "flushes": self.flushes,
                "flushes_by_namespace": dict(self.flushes_by_ns),
            }


def semcache_enabled(environ: dict | None = None) -> bool:
    env = environ if environ is not None else os.environ
    return env.get("SCT_SEMCACHE", "0") == "1"


def semantic_cache_from_env(environ: dict | None = None) -> SemanticCache | None:
    """A configured tier, or None with ``SCT_SEMCACHE`` unset.  Knobs:
    ``SCT_SEMCACHE_SIM`` (0.95), ``SCT_SEMCACHE_MAX_ENTRIES`` (2048),
    ``SCT_SEMCACHE_MAX_BYTES`` (32 MiB), ``SCT_SEMCACHE_TTL_S`` (300)."""
    env = environ if environ is not None else os.environ
    if not semcache_enabled(env):
        return None
    return SemanticCache(
        sim_threshold=float(env.get("SCT_SEMCACHE_SIM", "0.95")),
        max_entries=int(env.get("SCT_SEMCACHE_MAX_ENTRIES", "2048")),
        max_bytes=int(env.get("SCT_SEMCACHE_MAX_BYTES", str(32 * 1024 * 1024))),
        ttl_s=float(env.get("SCT_SEMCACHE_TTL_S", "300")),
    )
