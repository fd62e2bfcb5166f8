"""Gateway ingress service: the port's copy of the JAX package's
``gateway/app.py``, on the stdlib alone.

Endpoint-for-endpoint with the reference apife (reference:
api-frontend/.../api/rest/RestClientController.java:126-198): OAuth token
issuance, authenticated prediction/feedback proxying to the target
deployment's engine replicas, request/response tap, reward counters,
ingress metrics, and the pause/drain dance.

Like the reference, the gateway *validates* the payload parses but forwards
the raw JSON body untouched: the engine owns canonicalization.

:class:`GatewayApp` holds the transport-independent cores (``issue_token``,
``ingress_core``, ``_forward`` with its retry budget and replica pick, every
``/stats/*`` snapshot); the REST front is the h1 splice front
(``gateway/h1gateway.py``), which falls back to these cores for everything
it does not splice.  ``python -m seldon_core_tpu_torch.gateway.app --port
8080 --deployments deps.json`` serves it.

Options of the JAX gateway that the port does not serve raise by name:
``SCT_REST_IMPL=aiohttp`` (the card has no aiohttp; the splice front is the
default of both packages), ``--watch``/``GATEWAY_WATCH=1`` (the CR watch
needs the operator's kube client), ``SCT_GRPC_IMPL=grpcio`` (the card has
no grpcio; the h2 relay of ``gateway/grpc_gateway.py`` serves
``--grpc-port``/``GATEWAY_GRPC_PORT``, default 5000 as in the JAX gateway)
and an explicit ``SCT_SCALE`` (the embedded autoscaler of the operator
slice; ``/stats/autoscale`` answers as the JAX gateway with no
autoscaler).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import random
import time
from typing import Any

from seldon_core_tpu_torch import chaos, qos
from seldon_core_tpu_torch.contract import failure_status_dict
from seldon_core_tpu_torch.gateway.auth import AuthError, TokenStore, token_store_from_env, \
    verify_secret
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore, \
    EndpointDiff, load_store_from_env
from seldon_core_tpu_torch.gateway.tap import RequestResponseTap, tap_from_env
from seldon_core_tpu_torch.obs import (
    RECORDER,
    STAGE_GATEWAY_RELAY,
    WIRE,
    WIRE_GATEWAY_REST,
    current_span,
    set_engine_role,
)
from seldon_core_tpu_torch.obs.spans import outgoing_headers, set_traceparent
from seldon_core_tpu_torch.proto.grpc_defs import use_grpcio
from seldon_core_tpu_torch.runtime import settings as _settings
from seldon_core_tpu_torch.utils.loops import tune_server_loop
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS, MetricsRegistry
from seldon_core_tpu_torch.wire.h1client import H1ConnectError, H1Pool

log = logging.getLogger(__name__)

# the refusals by name of the JAX gateway's options the port does not serve
LATER_WATCH = ("--watch/GATEWAY_WATCH=1: the SeldonDeployment CR watch is not in the port yet; "
               "it comes with the operator slice (ROADMAP A16: watch.py and the kube client)")
LATER_AIOHTTP = ("SCT_REST_IMPL=aiohttp: the aiohttp REST front is not in the port (the card "
                 "has no aiohttp); the h1 splice front serves REST")
LATER_SCALE = ("SCT_SCALE: the embedded autoscaler is not in the port yet; it comes with the "
               "operator slice (ROADMAP A16: the operator and autoscale)")


def _error_bytes(status: int, reason: str) -> bytes:
    return json.dumps(failure_status_dict(status, reason)).encode()


class _UpstreamError(Exception):
    """A retryable upstream status, carried so the engine's real response
    can be returned verbatim if every attempt fails the same way."""

    def __init__(self, status: int, body: bytes):
        self.status = status
        self.body = body


class GatewayApp:
    def __init__(
        self,
        store: DeploymentStore,
        tokens: TokenStore | None = None,
        tap: RequestResponseTap | None = None,
        metrics: MetricsRegistry | None = None,
        timeout_s: float | None = None,
        stream_timeout_s: float | None = None,
    ):
        if timeout_s is None:
            timeout_s = float(os.environ.get("GATEWAY_TIMEOUT_S", "10"))
        self.store = store
        # the budget of relayed streams (token streaming runs far longer
        # than a unary call)
        self.stream_timeout_s = (
            stream_timeout_s
            if stream_timeout_s is not None
            else float(os.environ.get("GATEWAY_STREAM_TIMEOUT_S", "300"))
        )
        # env-selected shared store (GATEWAY_TOKEN_STORE) so N replicas
        # accept each other's tokens, like the reference's Redis token store
        self.tokens = tokens or token_store_from_env()
        self.tap = tap or tap_from_env()
        self.metrics = metrics or DEFAULT_METRICS
        self.timeout_s = timeout_s
        # HTTP/1.1 forward pools of the fallback cores, one per
        # (deployment, replica) endpoint
        self._pools: dict[tuple, H1Pool] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._paused = False
        # QoS plane: per-deployment admission (SCT_GW_QOS_* knobs; off
        # unless configured) + the deadline stamped on requests whose
        # client sent no x-sct-deadline-ms of their own
        self._qos: dict[str, qos.AdmissionController] = {}
        self.default_deadline_ms = _settings.get_float("SCT_DEFAULT_DEADLINE_MS")
        # caching & reuse plane: content-addressed response cache +
        # single-flight collapser, inert unless SCT_CACHE opts in; keys fold
        # in each record's spec_hash and the listener below flushes a
        # deployment's entries on update/removal
        from seldon_core_tpu_torch.cache import (
            SingleFlight,
            cache_deployments,
            response_cache_from_env,
            semantic_cache_from_env,
        )

        self.cache = response_cache_from_env("gateway")
        self.semcache = semantic_cache_from_env()
        self._cache_deployments = cache_deployments()
        self.collapse = SingleFlight()
        # multi-upstream replica routing: prefix-aware longest match
        # against polled per-replica digests, p2c on load otherwise;
        # single-upstream records bypass it
        from seldon_core_tpu_torch.disagg.router import ReplicaRouter, RouterPoller

        self.router = ReplicaRouter()
        self.poller = RouterPoller(store, self.router)
        # per-deployment retry budgets bound the retry amplification under
        # sustained upstream failure; the jittered exponential backoff
        # below replaces the transport default on the forward path
        self._retry_budgets: dict[str, Any] = {}
        self._retry_burst = _settings.get_float("SCT_GW_RETRY_BUDGET")
        self._retry_rate = _settings.get_float("SCT_GW_RETRY_RATE")
        self._retry_backoff_ms = _settings.get_float("SCT_GW_RETRY_BACKOFF_MS")
        self._retry_backoff_max_ms = _settings.get_float("SCT_GW_RETRY_BACKOFF_MAX_MS")
        # fleet telemetry plane: a collector over the SAME store, serving
        # /stats/fleet + /stats/slo; always constructed (the timeline
        # fan-out reuses its endpoint enumeration), polling only when
        # SCT_FLEET
        from seldon_core_tpu_torch.obs.fleet import FleetCollector

        self.fleet = FleetCollector(store, service="gateway")
        self._fleet_enabled = _settings.get_bool("SCT_FLEET")
        # the operator slice's autoscaler; None -> {"enabled": False}
        self.autoscaler = None
        # diff-based endpoint churn: the listener evicts only the replicas
        # an update removed, so survivors keep warm pools/digests/breakers
        self._ep_diff = EndpointDiff()
        self._ep_diff.seed(store.list())
        store.add_listener(self._on_deployment_event)

    def cache_enabled_for(self, rec: DeploymentRecord) -> bool:
        return self.cache is not None and (
            self._cache_deployments is None or rec.name in self._cache_deployments
        )

    def _on_deployment_event(self, event: str, rec: DeploymentRecord) -> None:
        gone = self._ep_diff.removed(event, rec)
        spec_rolled = self._ep_diff.spec_changed(event, rec)
        if event == "removed":
            self.tokens.revoke_for_key(rec.oauth_key)
            self._qos.pop(rec.oauth_key, None)
        if event in ("removed", "updated") and spec_rolled:
            # a rolling update or teardown flushes the deployment's
            # namespace in both tiers; endpoint-only churn keeps the hash
            # and keeps the cache
            if self.cache is not None:
                self.cache.flush(rec.oauth_key)
            if self.semcache is not None:
                self.semcache.flush(rec.oauth_key)
        if event in ("removed", "updated"):
            for k in [k for k in self._pools if k[0] == rec.oauth_key and k[1] in gone]:
                pool = self._pools.pop(k)
                # store events may fire on other threads; the pool's
                # streams belong to the serving loop
                if self._loop is not None:
                    self._loop.call_soon_threadsafe(
                        lambda p=pool: self._loop.create_task(p.close()))
            if event == "removed":
                self.router.forget(rec.oauth_key)
            else:
                for key in gone:
                    self.router.forget_replica(rec.oauth_key, key)

    def _pool(self, rec: DeploymentRecord, ep=None) -> H1Pool:
        """Forward pool for one replica (``ep``; default the primary)."""
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        if ep is None:
            ep = rec.replica_endpoints[0]
        key = (rec.oauth_key, ep.key)
        pool = self._pools.get(key)
        if pool is None:
            pool = H1Pool(ep.host, ep.rest_port)
            self._pools[key] = pool
        return pool

    def qos_for(self, rec: DeploymentRecord) -> qos.AdmissionController:
        """Per-deployment gateway admission controller (one isolated budget
        per deployment).  Inert unless SCT_GW_QOS / SCT_GW_QOS_* is set."""
        ctl = self._qos.get(rec.oauth_key)
        if ctl is None:
            ctl = qos.AdmissionController.from_env(
                rec.name, prefix="SCT_GW_QOS", default_enabled=False
            )
            self._qos[rec.oauth_key] = ctl
        return ctl

    def retry_budget_for(self, rec: DeploymentRecord):
        """Per-deployment retry budget: one tenant's failing upstream must
        not spend another tenant's retries."""
        from seldon_core_tpu_torch.engine.transport import RetryBudget

        budget = self._retry_budgets.get(rec.oauth_key)
        if budget is None:
            budget = RetryBudget(self._retry_burst, self._retry_rate)
            self._retry_budgets[rec.oauth_key] = budget
        return budget

    async def _retry_backoff(self, i: int) -> None:
        """Jittered exponential backoff between forward attempts, capped
        (SCT_GW_RETRY_BACKOFF_MS / _MAX_MS)."""
        delay_ms = min(
            self._retry_backoff_max_ms,
            self._retry_backoff_ms * (2 ** i) * (0.5 + random.random()),
        )
        await asyncio.sleep(delay_ms / 1e3)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Start the replica poller (multi-upstream records' digests and
        queue waits) and, with SCT_FLEET, the fleet collector.  The JAX
        gateway's h1 entry point never started its poller, so its prefix
        routing had no digests; the port's starts both."""
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        self.poller.start()
        if self._fleet_enabled:
            await self.fleet.start()

    async def close(self) -> None:
        await self.poller.stop()
        await self.fleet.stop()
        pools, self._pools = list(self._pools.values()), {}
        for pool in pools:
            await pool.close()
        await self.tap.close()

    # -- auth --------------------------------------------------------------

    def _principal_from_header(self, auth: str) -> DeploymentRecord:
        if not auth.startswith("Bearer "):
            raise AuthError("missing bearer token")
        key = self.tokens.principal(auth[7:])
        rec = self.store.get(key)
        if rec is None:
            raise AuthError("deployment no longer exists", 404)
        return rec

    def issue_token(self, client_id: str, client_secret: str) -> tuple[int, dict]:
        """client_credentials grant core."""
        rec = self.store.get(client_id)
        # a deployment without a secret is unreachable through the gateway:
        # empty==empty must not grant tokens
        if rec is None or not rec.oauth_secret or not verify_secret(
            rec.oauth_secret, client_secret
        ):
            return 401, failure_status_dict(401, "invalid client credentials")
        token, expires_in = self.tokens.issue(rec.oauth_key)
        return 200, {
            "access_token": token,
            "token_type": "bearer",
            "expires_in": int(expires_in),
        }

    # -- data plane --------------------------------------------------------

    async def _forward(self, rec: DeploymentRecord, path: str, raw: bytes) -> tuple[int, bytes]:
        """POST to the deployment's engine replica, with the bounded retry
        of the engine's own hops (engine/transport.py ``retry_loop``):
        connect failures always retry; sent-but-failed retries only the
        idempotent paths, never feedback (bandit reward counters).  A
        persistent 5xx is returned verbatim after the last attempt."""
        from seldon_core_tpu_torch.engine.transport import (
            RETRY_ATTEMPTS,
            RETRYABLE_HTTP,
            _RetryableConnect,
            _RetryableSent,
            retry_loop,
        )
        from seldon_core_tpu_torch.qos.context import outgoing_qos_headers

        idempotent = "feedback" not in path
        # multi-upstream replica pick: prefix-aware when any replica has
        # published digests, p2c on load otherwise
        endpoints = rec.replica_endpoints
        ep = None
        peer_hint = None
        if len(endpoints) > 1:
            from seldon_core_tpu_torch.disagg.router import extract_prompt_request

            tokens, adapter = (
                extract_prompt_request(raw)
                if self.router.has_digests(rec.oauth_key)
                else (None, None)
            )
            ep, peer_hint = self.router.pick_with_peer(rec.oauth_key, endpoints, tokens, adapter)
            self.router.note_start(rec.oauth_key, ep.key)
        pool = self._pool(rec, ep)
        wire = WIRE.counter(WIRE_GATEWAY_REST, rec.name)
        t_wire0 = time.perf_counter()
        # traceparent + the decremented deadline budget / priority class
        # cross the gateway->engine hop
        fwd_headers = {**outgoing_headers(), **outgoing_qos_headers()}
        if peer_hint is not None:
            # tell the chosen replica which peer advertises this prompt's
            # KV chain (and how deep) so it can pull instead of re-prefilling
            fwd_headers["x-sct-prefix-peer"] = peer_hint[0]
            fwd_headers["x-sct-prefix-depth"] = str(int(peer_hint[1]))
        fwd_headers = fwd_headers or None

        budget = self.retry_budget_for(rec)
        budget.earn()

        def _note(ok: bool) -> None:
            if ep is not None:
                (self.router.note_success if ok else self.router.note_failure)(
                    rec.oauth_key, ep.key
                )

        async def attempt(i: int) -> tuple[int, bytes]:
            try:
                if chaos.ENABLED:
                    await chaos.act("gw.forward")
                resp = await pool.post(path, raw, headers=fwd_headers, timeout=self.timeout_s)
                if (
                    resp.status in RETRYABLE_HTTP
                    and idempotent
                    # the last attempt returns the real response
                    and i < RETRY_ATTEMPTS - 1
                ):
                    _note(False)
                    raise _RetryableSent(_UpstreamError(resp.status, resp.body))
                _note(resp.status not in RETRYABLE_HTTP)
                return resp.status, resp.body
            except H1ConnectError as e:
                _note(False)
                raise _RetryableConnect(e) from e
            except (ConnectionError, asyncio.TimeoutError, OSError) as e:
                _note(False)
                raise _RetryableSent(e) from e

        try:
            status, body = await retry_loop(
                attempt, idempotent=idempotent, budget=budget, backoff=self._retry_backoff,
            )
        except _UpstreamError as e:
            status, body = e.status, e.body
        finally:
            if ep is not None:
                self.router.note_done(rec.oauth_key, ep.key)
        # the client body forwards verbatim and the engine reply returns
        # verbatim, so these lengths ARE the ingress payload bytes
        wire.record(bytes_in=len(raw), bytes_out=len(body),
                    duration_s=time.perf_counter() - t_wire0)
        return status, body

    async def ingress_core(
        self,
        auth_header: str,
        traceparent: str | None,
        raw: bytes,
        path: str,
        service: str,
        deadline_header: str | None = None,
        priority_header: str | None = None,
    ) -> tuple[int, bytes]:
        """Transport-independent ingress: auth, QoS admission, validate,
        forward, tap, metrics.  Returns (status, JSON body bytes).  A
        429/503 leaves a Retry-After hint in the qos context for the front
        to surface."""
        if self._paused:
            # drained traffic still counts in the ingress histogram
            self.metrics.ingress_requests.labels(
                "anonymous", "unknown", service, "POST", "503"
            ).observe(0.0)
            return 503, _error_bytes(503, "gateway is paused")
        start = time.perf_counter()
        # seed the hop's trace context; a trace-naive client gets a minted
        # root from the span below, so the engine's spans still stitch
        set_traceparent(traceparent)
        set_engine_role("gateway")
        budget_ms, priority = qos.seed_from_headers(deadline_header, priority_header)
        if budget_ms is None and self.default_deadline_ms:
            budget_ms = self.default_deadline_ms
            qos.set_budget_ms(budget_ms)
        with RECORDER.span("gateway.ingress", service=service, stage=STAGE_GATEWAY_RELAY) as sp:
            code, reply = await self._ingress_inner(
                auth_header, raw, path, service, start, priority=priority, budget_ms=budget_ms,
            )
            if sp is not None:
                sp.set_attr("code", code)
                if code >= 400:
                    sp.set_status("ERROR")
            return code, reply

    async def _ingress_inner(
        self,
        auth_header: str,
        raw: bytes,
        path: str,
        service: str,
        start: float,
        priority: str = qos.PRIO_INTERACTIVE,
        budget_ms: float | None = None,
    ) -> tuple[int, bytes]:
        principal = "anonymous"
        deployment_name = "unknown"
        code = 200
        ticket = None
        try:
            rec = self._principal_from_header(auth_header)
            principal = rec.oauth_key
            deployment_name = rec.name
            # content-addressed cache lookup BEFORE admission: a hit costs
            # no admission slot, no deadline budget, no engine hop
            cache_key = None
            if service == "predictions" and self.cache_enabled_for(rec):
                from seldon_core_tpu_torch.cache import request_key

                cache_key = request_key(path, rec.spec_hash, raw)
                entry = self.cache.get(rec.oauth_key, cache_key)
                sp = current_span()
                if entry is not None:
                    if sp is not None:
                        sp.event("cache.hit", tier="gateway")
                    code = entry.status
                    return entry.status, entry.value
                if sp is not None:
                    sp.event("cache.miss", tier="gateway")
            try:
                ticket = self.qos_for(rec).admit(
                    priority, budget_s=budget_ms / 1e3 if budget_ms else None
                )
            except qos.QosRejection as e:
                qos.set_retry_after(e.retry_after_header())
                code = e.status
                return e.status, _error_bytes(e.status, str(e))
            # the body is forwarded untouched, so a full json.loads is only
            # paid when something needs the object: the tap or the reward
            # counter; otherwise a shallow shape check (the engine
            # re-validates and its 400 returns verbatim)
            body: Any = None
            need_body = service == "feedback" or (service == "predictions" and self.tap.enabled)
            if need_body:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    code = 400
                    return 400, _error_bytes(400, f"invalid JSON: {e}")
                if not isinstance(body, dict):
                    code = 400
                    return 400, _error_bytes(400, "body must be a JSON object")
            elif raw.lstrip()[:1] != b"{":
                code = 400
                return 400, _error_bytes(400, "body must be a JSON object")
            try:
                if cache_key is not None:
                    # single-flight: a herd of identical requests costs ONE
                    # engine hop; followers share the leader's reply
                    code, reply = await self.collapse.do(
                        cache_key, lambda: self._forward(rec, path, raw)
                    )
                    if code == 200:
                        self.cache.put(rec.oauth_key, cache_key, reply)
                else:
                    code, reply = await self._forward(rec, path, raw)
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                code = 503
                return 503, _error_bytes(503, f"engine unreachable for {rec.name}: {e}")
            if service == "predictions":
                if self.tap.enabled:
                    await self._tap_pair(rec, body, reply)
            elif service == "feedback":
                self._record_reward(rec, body)
            return code, reply
        except AuthError as e:
            code = e.status
            return e.status, _error_bytes(e.status, str(e))
        finally:
            if ticket is not None:
                ticket.release()
            self.metrics.ingress_requests.labels(
                principal, deployment_name, service, "POST", str(code)
            ).observe(time.perf_counter() - start)

    async def _tap_pair(self, rec: DeploymentRecord, body: Any, reply: bytes) -> None:
        try:
            reply_obj = json.loads(reply)
        except json.JSONDecodeError:
            reply_obj = {"raw": reply.decode(errors="replace")}
        puid = ""
        if isinstance(reply_obj, dict):
            puid = (reply_obj.get("meta") or {}).get("puid", "")
        await self.tap.publish(rec.oauth_key, puid, body, reply_obj)

    def _record_reward(self, rec: DeploymentRecord, body: Any) -> None:
        """Reward counters at the gateway, like the reference's apife.
        Metrics must never fail a request the engine already processed."""
        try:
            reward = body.get("reward", 0.0) if isinstance(body, dict) else 0.0
            reward = float(reward) if isinstance(reward, (int, float)) else 0.0
            self.metrics.feedback.labels(rec.name, rec.name, "gateway").inc()
            if reward > 0:  # counters cannot decrease
                self.metrics.feedback_reward.labels(rec.name, rec.name, "gateway").inc(reward)
        except Exception:
            log.exception("reward metric recording failed")

    # -- ops snapshots (served by the h1 front's fallback routes) -----------

    def usage_snapshot(self) -> dict:
        """Process-local usage-meter rows: the gateway-side charges; the
        per-replica engine rows are fleet-merged under /stats/fleet."""
        from seldon_core_tpu_torch.obs.metering import METER

        return METER.snapshot()

    def qos_snapshot(self) -> dict:
        return {
            "default_deadline_ms": self.default_deadline_ms or None,
            "deployments": {key: ctl.snapshot() for key, ctl in self._qos.items()},
        }

    def cache_snapshot(self) -> dict:
        out: dict = {"enabled": self.cache is not None, "collapse": self.collapse.snapshot()}
        if self.cache is not None:
            out["response"] = self.cache.snapshot()
        if self.semcache is not None:
            out["semantic"] = self.semcache.snapshot()
        if self._cache_deployments is not None:
            out["deployments"] = sorted(self._cache_deployments)
        return out

    def route_snapshot(self) -> dict:
        """Replica-routing state: per-replica digest sizes, load signals,
        pick counters, breakers, and the poller's sweep ledger."""
        return {**self.router.snapshot(), "poller": self.poller.snapshot()}

    def fleet_snapshot(self) -> dict:
        return {"enabled": self._fleet_enabled, **self.fleet.fleet_snapshot()}

    def slo_snapshot(self) -> dict:
        return self.fleet.slo_snapshot()

    def autoscale_snapshot(self) -> dict:
        if self.autoscaler is None:
            return {"enabled": False}
        return self.autoscaler.snapshot()


def _refuse_later_options(args) -> None:
    use_grpcio()  # SCT_GRPC_IMPL=grpcio raises by name
    if args.rest_impl != "h1":
        raise NotImplementedError(LATER_AIOHTTP)
    if args.watch:
        raise NotImplementedError(LATER_WATCH)
    if os.environ.get("SCT_SCALE", "") != "" and _settings.get_bool("SCT_SCALE"):
        raise NotImplementedError(LATER_SCALE)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu API gateway on the stdlib")
    parser.add_argument("--port", type=int, default=int(os.environ.get("GATEWAY_PORT", "8080")))
    parser.add_argument("--host", default=None,
                        help="listen address (default: every IPv4 and IPv6 address)")
    parser.add_argument("--grpc-port", type=int,
                        default=int(os.environ.get("GATEWAY_GRPC_PORT", "5000")),
                        help="the Seldon gRPC relay's port (h2 data plane; "
                             "GATEWAY_GRPC_OPTIONAL=1 serves REST alone if it cannot bind)")
    parser.add_argument("--deployments", default="", help="JSON file of deployment records")
    parser.add_argument("--watch", action="store_true",
                        default=os.environ.get("GATEWAY_WATCH") == "1",
                        help="refused: the operator slice")
    parser.add_argument("--rest-impl", choices=("h1", "aiohttp"),
                        default=_settings.get_str("SCT_REST_IMPL"),
                        help="REST front: the splice data plane (aiohttp is refused)")
    args = parser.parse_args(argv)
    _refuse_later_options(args)
    logging.basicConfig(level=logging.INFO)

    store = DeploymentStore()
    load_store_from_env(store)
    if args.deployments:
        store.load_file(args.deployments)
    gateway = GatewayApp(store)
    asyncio.run(_run_h1(gateway, args))


async def _run_h1(gateway: GatewayApp, args) -> None:
    """Serve REST on the h1 splice front and gRPC on the h2 relay, with the
    replica poller and the fleet collector in the same loop, until SIGTERM
    or SIGINT."""
    import signal

    from seldon_core_tpu_torch.gateway.grpc_gateway import start_gateway_grpc
    from seldon_core_tpu_torch.gateway.h1gateway import H1SpliceFrontend

    tune_server_loop()
    frontend = H1SpliceFrontend(gateway)
    await frontend.start(args.port, host=args.host)
    log.info("gateway REST (h1 splice) on :%d", frontend.bound_port)
    grpc_server = None
    try:
        grpc_server = await start_gateway_grpc(gateway, args.grpc_port, host=args.host)
    except Exception as e:
        if os.environ.get("GATEWAY_GRPC_OPTIONAL") == "1":
            log.warning("gateway gRPC not started (optional): %s", e)
        else:
            log.error("gateway gRPC failed to start on :%d: %s", args.grpc_port, e)
            await frontend.stop()
            raise
    await gateway.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    try:
        await stop.wait()
    finally:
        if grpc_server is not None:
            await grpc_server.gateway_handler.close()
            await grpc_server.stop(grace=2.0)
        await frontend.stop()
        await gateway.close()


if __name__ == "__main__":
    main()
