"""Prefix-aware + load-aware replica routing for multi-upstream deployments:
the port's copy of the JAX package's ``disagg/router.py``, polling over the
port's pooled stdlib client (``wire/h1client.py``) in place of aiohttp.

Policy (docs/DISAGGREGATION.md):

1. **Prefix-aware** — each engine replica publishes a compact digest of its
   KV prefix-reuse index on ``GET /stats/cache`` (block-chain hashes +
   depths, cache/prefix.py ``PrefixIndex.digest``).  The gateway hashes the
   request's leading token blocks the same way and routes to the replica
   whose digest matches the LONGEST chain — a request sharing a 160-token
   system prompt lands on the replica that already holds those KV blocks
   and prefills only its novel suffix.
2. **Load-aware fallback** — no token prefix, no digests, or a tie: pick
   power-of-two-choices on ``(inflight, queue-wait EWMA, picks)``, the
   queue-wait signal polled from each replica's ``GET /stats/qos``.

State lives on the gateway; the :class:`RouterPoller` refreshes it on a
period (``SCT_GW_ROUTE_POLL_S``).  Everything degrades safely: a replica
with no polled state is still pickable (score zero) and a single-upstream
record bypasses the router entirely.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import threading
import time
from typing import Any, Iterable, Sequence

import numpy as np

from seldon_core_tpu_torch.cache.prefix import chain_hash
from seldon_core_tpu_torch.runtime import settings as _settings

log = logging.getLogger(__name__)


def extract_prompt_tokens(raw: bytes) -> "np.ndarray | None":
    """Best-effort prompt extraction from a generative request body — the
    strData contract (``{"strData": "{\\"tokens\\": [...]}"}``) or a direct
    ``{"tokens": [...]}``.  ``None`` for anything else: non-generative
    payloads route load-aware, and the fronts only call this when a
    replica has published digests (ReplicaRouter.has_digests)."""
    return extract_prompt_request(raw)[0]


def extract_prompt_request(
    raw: bytes,
) -> "tuple[np.ndarray | None, str | None]":
    """Like :func:`extract_prompt_tokens` but also surfaces the request's
    LoRA ``adapter`` name (docs/MULTITENANT.md) — adapter-tagged prefix
    chains hash differently, so the router must fold it in to find the
    replica that actually holds those blocks."""
    import json

    try:
        body = json.loads(raw)
        if not isinstance(body, dict):
            return None, None
        if "strData" in body:
            body = json.loads(body["strData"])
            if not isinstance(body, dict):
                return None, None
        adapter = body.get("adapter")
        adapter = str(adapter) if isinstance(adapter, str) and adapter else None
        toks = body.get("tokens")
        if (
            isinstance(toks, (list, tuple))
            and toks
            and all(isinstance(t, int) and not isinstance(t, bool) for t in toks)
        ):
            return np.asarray(toks, np.int32), adapter
        return None, adapter
    except (ValueError, TypeError, KeyError):
        return None, None


def prompt_chain_hashes(
    tokens: np.ndarray,
    block_size: int,
    max_blocks: int = 64,
    adapter: "str | None" = None,
) -> list[str]:
    """Chain hashes of the request's leading FULL token blocks — the same
    key bytes + hash the engine-side ``PrefixIndex.digest`` publishes, so
    membership at depth k means the replica holds KV for tokens[:k*bs].
    ``adapter`` folds the request's LoRA adapter into the key exactly like
    the engine's salted index (cache/prefix.py ``adapter_salt``)."""
    from seldon_core_tpu_torch.cache.prefix import adapter_salt

    tokens = np.asarray(tokens, np.int32).ravel()
    bs = int(block_size)
    if bs < 1:
        return []
    salt = adapter_salt(adapter)
    n = min(tokens.size // bs, max_blocks)
    return [
        chain_hash(
            salt + np.ascontiguousarray(tokens[: k * bs], np.int32).tobytes()
        )
        for k in range(1, n + 1)
    ]


class _Breaker:
    """Per-replica circuit breaker (docs/RESILIENCE.md).  Consecutive
    forward failures ``open`` the circuit: the replica is ejected from
    routing for the ejection window instead of letting p2c keep
    re-picking a corpse.  After the window, exactly ONE request is
    elected as the half-open probe; its success ``close``s the circuit,
    its failure re-opens a fresh window.  All transitions run under the
    router lock."""

    __slots__ = ("fails", "until", "probing", "opens", "closes")

    def __init__(self) -> None:
        self.fails = 0          # consecutive forward failures
        self.until = 0.0        # monotonic deadline of the ejection window
        self.probing = False    # a half-open probe request is in flight
        self.opens = 0
        self.closes = 0

    @property
    def is_open(self) -> bool:
        return self.until > 0.0

    def open(self, until: float) -> None:
        self.until = until
        self.probing = False
        self.opens += 1

    def close(self) -> None:
        self.fails = 0
        self.until = 0.0
        self.probing = False
        self.closes += 1

    def probe_open(self) -> None:
        self.probing = True

    def probe_close(self) -> None:
        self.probing = False


class _ReplicaState:
    __slots__ = (
        "hashes", "block_size", "queue_wait_ms", "inflight", "picked",
        "updated", "breaker",
    )

    def __init__(self) -> None:
        self.hashes: set[str] = set()
        self.block_size: int = 0
        self.queue_wait_ms: float = 0.0
        self.inflight: int = 0
        self.picked: int = 0
        self.updated: float = 0.0
        self.breaker = _Breaker()


def endpoint_key(ep: Any) -> str:
    return f"{ep.host}:{ep.rest_port}"


class ReplicaRouter:
    """Per-deployment replica picker.  Thread-safe: the h1 splice callbacks,
    the fallback cores and the poller all touch it."""

    def __init__(self, rng: random.Random | None = None):
        self._lock = threading.Lock()
        self._deployments: dict[str, dict[str, _ReplicaState]] = {}
        self._rng = rng or random.Random()
        self.prefix_picks = 0
        self.p2c_picks = 0
        self.single_picks = 0
        # peer tier of the tiered prefix store (docs/CACHING.md): when
        # SCT_PREFIX_PEER_PULL=1, prefix affinity may YIELD to load — the
        # router sends the request to a lighter replica and stamps the
        # advertising replica as a pull hint, because the chain can move
        # (one /disagg/prefix/pull) while queue depth cannot.  The yield
        # threshold is the inflight gap that justifies a pull's network
        # cost (SCT_GW_PEER_YIELD, in requests).
        self.peer_pull = os.environ.get("SCT_PREFIX_PEER_PULL", "0") == "1"
        self.peer_yield = _settings.get_int("SCT_GW_PEER_YIELD")
        self.peer_hints = 0
        self.peer_yield_picks = 0
        # circuit breaker (docs/RESILIENCE.md): SCT_GW_CB_FAILS consecutive
        # forward failures eject a replica for SCT_GW_CB_EJECT_S, then one
        # half-open probe re-admits it; 0 disables the breaker entirely
        self.cb_fails = _settings.get_int("SCT_GW_CB_FAILS")
        self.cb_eject_s = _settings.get_float("SCT_GW_CB_EJECT_S")
        self.cb_opens = 0
        self.cb_closes = 0
        self.cb_probes = 0
        self.cb_skipped_picks = 0

    # -- state feeds ---------------------------------------------------------

    def _state(self, dep: str, ep_key: str) -> _ReplicaState:
        reps = self._deployments.setdefault(dep, {})
        st = reps.get(ep_key)
        if st is None:
            st = reps[ep_key] = _ReplicaState()
        return st

    def update_replica(
        self,
        dep: str,
        ep_key: str,
        *,
        hashes: Iterable[str] | None = None,
        block_size: int | None = None,
        queue_wait_ms: float | None = None,
    ) -> None:
        with self._lock:
            st = self._state(dep, ep_key)
            if hashes is not None:
                st.hashes = set(hashes)
            if block_size is not None:
                st.block_size = int(block_size)
            if queue_wait_ms is not None:
                st.queue_wait_ms = float(queue_wait_ms)
            st.updated = time.monotonic()

    def forget(self, dep: str) -> None:
        with self._lock:
            self._deployments.pop(dep, None)

    def forget_replica(self, dep: str, ep_key: str) -> None:
        """Drop ONE replica's routing state (digests, load EWMA, breaker).
        Autoscale shrink removes exactly the drained replica; survivors
        keep their prefix digests and breaker windows, so routing quality
        does not reset to cold on every scale event."""
        with self._lock:
            reps = self._deployments.get(dep)
            if reps is not None:
                reps.pop(ep_key, None)
                if not reps:
                    self._deployments.pop(dep, None)

    def note_start(self, dep: str, ep_key: str) -> None:
        with self._lock:
            self._state(dep, ep_key).inflight += 1

    def note_done(self, dep: str, ep_key: str) -> None:
        with self._lock:
            st = self._state(dep, ep_key)
            if st.inflight > 0:
                st.inflight -= 1

    def note_failure(self, dep: str, ep_key: str) -> None:
        """One forward attempt against this replica failed (connect error,
        timeout, or retryable 5xx).  Consecutive failures open the
        breaker; a failed half-open probe re-opens a fresh window."""
        if not self.cb_fails:
            return
        with self._lock:
            breaker = self._state(dep, ep_key).breaker
            was_probe = breaker.probing
            breaker.probe_close()
            breaker.fails += 1
            if was_probe or breaker.fails >= self.cb_fails:
                # a state machine: note_success closes the
                # breaker when the replica's half-open probe succeeds
                breaker.open(time.monotonic() + self.cb_eject_s)
                self.cb_opens += 1

    def note_success(self, dep: str, ep_key: str) -> None:
        """A forward against this replica completed: reset the failure
        streak and close an open circuit (successful half-open probe)."""
        if not self.cb_fails:
            return
        with self._lock:
            breaker = self._state(dep, ep_key).breaker
            if breaker.is_open or breaker.probing or breaker.fails:
                breaker.close()
                self.cb_closes += 1

    def _admissible(self, reps: dict, endpoints: Sequence[Any]) -> list:
        """Endpoints the breaker lets this pick consider.  Expired-window
        replicas elect the pick as their half-open probe (routed ahead of
        prefix/p2c so exactly one request tests the replica); when every
        endpoint is ejected the breaker fails static and routing proceeds
        over all of them (shedding everything would turn a replica brownout
        into a total outage)."""
        now = time.monotonic()
        usable: list[Any] = []
        probe = None
        for ep in endpoints:
            st = reps.get(endpoint_key(ep))
            breaker = st.breaker if st is not None else None
            if breaker is None or not breaker.is_open:
                usable.append(ep)
            elif probe is None and now >= breaker.until and not breaker.probing:
                probe = ep
        if probe is not None:
            st = reps.get(endpoint_key(probe))
            # ownership transfer: note_success/note_failure close the probe
            # when the gateway reports the attempt's outcome
            st.breaker.probe_open()  # the outcome closes it
            self.cb_probes += 1
            return [probe]
        if not usable:
            return list(endpoints)
        if len(usable) < len(endpoints):
            self.cb_skipped_picks += 1
        return usable

    def has_digests(self, dep: str) -> bool:
        """Cheap guard: is prompt extraction worth doing for this
        deployment?  (Parsing every body for a digest-less pool would tax
        the hot path for nothing.)"""
        with self._lock:
            reps = self._deployments.get(dep)
            return bool(reps) and any(st.hashes for st in reps.values())

    # -- the pick ------------------------------------------------------------

    def _score(self, st: _ReplicaState | None) -> tuple:
        if st is None:
            return (0, 0.0, 0)
        return (st.inflight, round(st.queue_wait_ms, 1), st.picked)

    def pick(
        self,
        dep: str,
        endpoints: Sequence[Any],
        prompt_tokens: np.ndarray | None = None,
        adapter: "str | None" = None,
    ) -> Any:
        """Choose a replica for one request.  Counts the pick so the p2c
        tiebreak stays balanced even before any state is polled."""
        return self.pick_with_peer(dep, endpoints, prompt_tokens, adapter)[0]

    def pick_with_peer(
        self,
        dep: str,
        endpoints: Sequence[Any],
        prompt_tokens: np.ndarray | None = None,
        adapter: "str | None" = None,
    ) -> "tuple[Any, tuple[str, int] | None]":
        """Like :meth:`pick`, plus a peer-pull hint ``(replica_key, depth)``
        when the chosen replica should fetch the prompt's chain from an
        advertising peer (``POST /disagg/prefix/pull``) instead of
        re-prefilling it.  The hint fires when peer pull is enabled and
        EITHER the prefix-holding replica is ``peer_yield`` inflight
        requests hotter than the lightest alternative (the pick yields to
        load and ships the chain after it), or the chosen replica simply
        advertises a shallower chain than another.  With peer pull off the
        hint is always ``None`` and the pick is byte-identical to the
        legacy policy."""
        if len(endpoints) == 1:
            self.single_picks += 1
            return endpoints[0], None
        with self._lock:
            reps = self._deployments.get(dep, {})
            if self.cb_fails:
                endpoints = self._admissible(reps, endpoints)
                if len(endpoints) == 1:
                    # sole survivor (or the elected half-open probe):
                    # nothing to score against
                    chosen = endpoints[0]
                    self._state(dep, endpoint_key(chosen)).picked += 1
                    return chosen, None
            chosen = None
            hint: "tuple[str, int] | None" = None
            best_depth = 0
            best: list[Any] = []
            if prompt_tokens is not None and reps:
                # longest-prefix match, hashes computed once per distinct
                # block size across the replica set
                by_bs: dict[int, list[str]] = {}
                for ep in endpoints:
                    st = reps.get(endpoint_key(ep))
                    if st is None or not st.hashes or st.block_size < 1:
                        continue
                    hs = by_bs.get(st.block_size)
                    if hs is None:
                        hs = by_bs[st.block_size] = prompt_chain_hashes(
                            prompt_tokens, st.block_size, adapter=adapter
                        )
                    depth = 0
                    for h in hs:
                        if h not in st.hashes:
                            break
                        depth += 1
                    if depth > best_depth:
                        best_depth, best = depth, [ep]
                    elif depth and depth == best_depth:
                        best.append(ep)
            if best:
                affine = min(
                    best, key=lambda ep: self._score(reps.get(endpoint_key(ep)))
                )
                if self.peer_pull:
                    others = [ep for ep in endpoints if ep not in best]
                    if others:
                        light = min(
                            others,
                            key=lambda ep: self._score(reps.get(endpoint_key(ep))),
                        )
                        gap = (
                            self._score(reps.get(endpoint_key(affine)))[0]
                            - self._score(reps.get(endpoint_key(light)))[0]
                        )
                        if gap >= self.peer_yield:
                            chosen = light
                            hint = (endpoint_key(affine), best_depth)
                            self.peer_hints += 1
                            self.peer_yield_picks += 1
                if chosen is None:
                    chosen = affine
                    self.prefix_picks += 1
            if chosen is None:
                # power-of-two-choices on (inflight, queue-wait EWMA, picks)
                a, b = self._rng.sample(range(len(endpoints)), 2)
                ea, eb = endpoints[a], endpoints[b]
                sa = self._score(reps.get(endpoint_key(ea)))
                sb = self._score(reps.get(endpoint_key(eb)))
                chosen = ea if sa <= sb else eb
                self.p2c_picks += 1
            if (
                hint is None
                and self.peer_pull
                and best_depth
                and chosen not in best
            ):
                # stale-digest / p2c case: someone else holds a chain the
                # chosen replica lacks — still worth pulling
                hint = (
                    endpoint_key(
                        min(
                            best,
                            key=lambda ep: self._score(
                                reps.get(endpoint_key(ep))
                            ),
                        )
                    ),
                    best_depth,
                )
                self.peer_hints += 1
            self._state(dep, endpoint_key(chosen)).picked += 1
            return chosen, hint

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "prefix_picks": self.prefix_picks,
                "p2c_picks": self.p2c_picks,
                "single_picks": self.single_picks,
                "peer_pull": self.peer_pull,
                "peer_hints": self.peer_hints,
                "peer_yield_picks": self.peer_yield_picks,
                "cb_fails": self.cb_fails,
                "cb_opens": self.cb_opens,
                "cb_closes": self.cb_closes,
                "cb_probes": self.cb_probes,
                "cb_skipped_picks": self.cb_skipped_picks,
                "deployments": {
                    dep: {
                        ep: {
                            "digest_entries": len(st.hashes),
                            "block_size": st.block_size or None,
                            "queue_wait_ms": round(st.queue_wait_ms, 3),
                            "inflight": st.inflight,
                            "picked": st.picked,
                            "breaker": {
                                "open": st.breaker.is_open,
                                "probing": st.breaker.probing,
                                "fails": st.breaker.fails,
                                "opens": st.breaker.opens,
                                "closes": st.breaker.closes,
                            },
                        }
                        for ep, st in reps.items()
                    }
                    for dep, reps in self._deployments.items()
                },
            }


class RouterPoller:
    """Background refresh of per-replica routing state.

    Polls every multi-upstream deployment's replicas: ``GET /stats/cache``
    for the prefix digest, ``GET /stats/qos`` for the queue-wait EWMA.
    Single-upstream records are skipped (nothing to choose).  Poll failures
    never raise; ``SCT_GW_POLL_FAILS`` CONSECUTIVE failures clear the
    replica's digest — a dead or restarted replica must stop attracting
    prefix traffic, but one dropped poll (a GC pause, a blipped connection)
    must not destroy its prefix affinity.
    """

    def __init__(
        self,
        store: Any,
        router: ReplicaRouter,
        *,
        interval_s: float | None = None,
        timeout_s: float = 2.0,
    ):
        self.store = store
        self.router = router
        self.interval_s = (
            _settings.get_float("SCT_GW_ROUTE_POLL_S")
            if interval_s is None
            else float(interval_s)
        )
        # SCT_GW_ROUTE_PREFIX=0 turns prefix digests off entirely: every
        # pick degrades to the p2c load fallback (the acceptance bar's
        # "digests disabled" mode)
        self.poll_prefix = _settings.get_raw("SCT_GW_ROUTE_PREFIX") != "0"
        self.timeout_s = float(timeout_s)
        self.poll_fails = max(1, _settings.get_int("SCT_GW_POLL_FAILS"))
        self._fail_streaks: dict[tuple[str, str], int] = {}
        self._task: asyncio.Task | None = None
        # one keep-alive pool per replica (host, port)
        self._pools: dict[tuple[str, int], Any] = {}
        self.polls = 0
        self.errors = 0
        self.digest_clears = 0

    def _pool(self, ep: Any):
        from seldon_core_tpu_torch.wire.h1client import H1Pool

        key = (ep.host, int(ep.rest_port))
        pool = self._pools.get(key)
        if pool is None:
            pool = self._pools[key] = H1Pool(ep.host, int(ep.rest_port), limit=2)
        return pool

    async def _get_json(self, pool, path: str) -> "dict | None":
        """GET ``path`` within the poll's timeout: the JSON body of a 200,
        None for another status."""
        import json

        resp = await pool.get(path, timeout=self.timeout_s)
        if resp.status != 200:
            return None
        return json.loads(resp.body)

    async def poll_once(self) -> int:
        """One sweep over every multi-upstream record; returns replicas
        polled (exposed for tests and for a forced refresh)."""
        polled = 0
        live: set[tuple[str, int]] = set()
        for rec in self.store.list():
            endpoints = rec.replica_endpoints
            if len(endpoints) < 2:
                continue
            for ep in endpoints:
                live.add((ep.host, int(ep.rest_port)))
                await self._poll_replica(rec, ep)
                polled += 1
        # a replica no record lists any more keeps no pool (nor its sockets)
        for key in [k for k in self._pools if k not in live]:
            await self._pools.pop(key).close()
        self.polls += 1
        return polled

    async def _poll_replica(self, rec: Any, ep: Any) -> None:
        key = endpoint_key(ep)
        pool = self._pool(ep)
        try:
            cache = {}
            if self.poll_prefix:
                body = await self._get_json(pool, "/stats/cache")
                if body is not None:
                    cache = body.get("cache", {})
            queue_wait_ms = None
            body = await self._get_json(pool, "/stats/qos")
            if body is not None:
                qos_snap = body.get("qos", {})
                qw = qos_snap.get("queue_wait_ewma_ms")
                if isinstance(qw, (int, float)):
                    queue_wait_ms = float(qw)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.errors += 1
            # unreachable replica: after SCT_GW_POLL_FAILS consecutive
            # misses, drop its digest so prefix routing stops steering
            # traffic at it; p2c still may (connect errors there surface
            # as retries/503s with their own handling).  A single dropped
            # poll keeps the digest — re-prefilling a warm working set
            # costs far more than one optimistic route.
            streak = self._fail_streaks.get((rec.oauth_key, key), 0) + 1
            self._fail_streaks[(rec.oauth_key, key)] = streak
            if streak >= self.poll_fails:
                self.router.update_replica(rec.oauth_key, key, hashes=())
                self.digest_clears += 1
            return
        self._fail_streaks.pop((rec.oauth_key, key), None)
        hashes: set[str] = set()
        block_size = 0
        for snap in (cache.get("prefix") or {}).values():
            digest = (snap or {}).get("digest") or {}
            hashes.update(digest.get("hashes") or ())
            block_size = block_size or int(digest.get("block_size") or 0)
            # tiered prefix store (docs/CACHING.md): a chain demoted to the
            # replica's host-DRAM tier is still ONE promotion scatter from
            # warm — merge the DRAM digest so prefix routing (and the peer
            # pull hint) treats both tiers as "this replica holds it"
            dram = ((snap or {}).get("tiers") or {}).get("dram") or {}
            dram_digest = dram.get("digest") or {}
            hashes.update(dram_digest.get("hashes") or ())
            block_size = block_size or int(dram_digest.get("block_size") or 0)
        self.router.update_replica(
            rec.oauth_key,
            key,
            hashes=hashes,
            block_size=block_size or None,
            queue_wait_ms=queue_wait_ms,
        )

    async def _run(self) -> None:
        while True:
            try:
                await self.poll_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.errors += 1
                log.exception("router poll sweep failed")
            await asyncio.sleep(self.interval_s)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            await pool.close()

    def snapshot(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "polls": self.polls,
            "errors": self.errors,
            "poll_fails": self.poll_fails,
            "digest_clears": self.digest_clears,
            "running": self._task is not None and not self._task.done(),
        }
