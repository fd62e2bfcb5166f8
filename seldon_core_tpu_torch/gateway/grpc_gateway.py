"""The gateway's gRPC ingress, the external ``Seldon`` service relay: the
port's copy of the JAX package's ``gateway/grpc_gateway.py`` on the h2
data plane (``wire/h2grpc.py``).

As the reference's apife gRPC server, a call authenticates with its
``oauth_token`` metadata against the gateway's token store, resolves the
principal's deployment and goes to one of its engine replicas' gRPC
ports over a channel kept per (deployment, replica).  The relay forwards
raw bytes: the framed request goes to the engine verbatim and the framed
reply comes back verbatim, so the gateway decodes no proto per call.  A
failure answers as a SeldonMessage FAILURE whose code maps the engine's
grpc-status (``_GRPC_TO_HTTP``).  ``traceparent`` metadata crosses the hop
both ways (a trace-naive client gets a minted root); each unary relay's
bytes count on the ``gateway-grpc`` wire edge and its time on the
``gateway-relay`` stage.  A multi-replica record picks per call on load
alone (p2c): prefix affinity needs the prompt, which the relay never
decodes.

The grpcio transport (``SCT_GRPC_IMPL=grpcio``, the JAX ``GatewayGrpc``)
raises by name: the card has no grpcio.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import time

from seldon_core_tpu_torch.gateway.auth import AuthError
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, EndpointDiff
from seldon_core_tpu_torch.obs import (
    RECORDER,
    STAGE_GATEWAY_RELAY,
    WIRE,
    WIRE_GATEWAY_GRPC,
    set_engine_role,
)
from seldon_core_tpu_torch.obs.spans import (
    ensure_traceparent,
    new_traceparent,
    outgoing_headers,
    parse_traceparent,
    set_traceparent,
)
from seldon_core_tpu_torch.proto.grpc_defs import GRPCIO_REFUSED, failure_message, use_grpcio
from seldon_core_tpu_torch.wire import FastGrpcChannel, FastGrpcServer, GrpcCallError
from seldon_core_tpu_torch.wire.h2grpc import grpc_frame

log = logging.getLogger(__name__)

OAUTH_METADATA_KEY = "oauth_token"

# canonical grpc-status -> HTTP code (the SeldonMessage failure contract is
# HTTP-shaped; grpc-gateway's standard mapping)
_GRPC_TO_HTTP = {
    0: 200, 1: 499, 2: 500, 3: 400, 4: 504, 5: 404, 6: 409, 7: 403,
    8: 429, 9: 400, 10: 409, 11: 400, 12: 501, 13: 500, 14: 503,
    15: 500, 16: 401,
}

# the streaming call's token, seeded by the server's request-headers hook
# in the handler task's context
_request_token: contextvars.ContextVar[str] = contextvars.ContextVar(
    "sct_gateway_token", default=""
)


def _resolve_record(gateway, token: str) -> DeploymentRecord:
    """oauth token -> deployment record."""
    if not token:
        raise AuthError("missing oauth_token metadata")
    key = gateway.tokens.principal(token)
    rec = gateway.store.get(key)
    if rec is None:
        raise AuthError("deployment no longer exists", 404)
    return rec


def _failure_frame(reason: str, code: int) -> bytes:
    return grpc_frame(failure_message(reason, code).SerializeToString())


class _ChannelCacheBase:
    """Per-(deployment, replica) engine channels with store-event eviction.

    Store events may fire from other threads; a channel's close hops back
    to the serving loop.  Close tasks are referenced until done (a bare
    fire-and-forget task can be collected before it runs)."""

    def __init__(self, gateway, loop=None):
        self.gateway = gateway
        self._channels: dict[tuple, FastGrpcChannel] = {}
        self._loop = loop or asyncio.get_event_loop()
        self._close_tasks: set[asyncio.Task] = set()
        self._ep_diff = EndpointDiff()
        self._ep_diff.seed(gateway.store.list())
        gateway.store.add_listener(self._on_deployment_event)

    def _new_channel(self, rec: DeploymentRecord, ep):
        raise NotImplementedError

    def _channel(self, rec: DeploymentRecord):
        endpoints = rec.replica_endpoints
        ep = endpoints[0]
        if len(endpoints) > 1:
            ep = self.gateway.router.pick(rec.oauth_key, endpoints, None)
        key = (rec.oauth_key, ep.key)
        ch = self._channels.get(key)
        if ch is None:
            ch = self._channels[key] = self._new_channel(rec, ep)
        return ch

    def _on_deployment_event(self, event: str, rec: DeploymentRecord) -> None:
        gone = self._ep_diff.removed(event, rec)
        if event in ("removed", "updated"):
            # only the departed replicas' channels close: survivors keep
            # their warm HTTP/2 connections across an endpoint change
            for k in [k for k in self._channels if k[0] == rec.oauth_key and k[1] in gone]:
                ch = self._channels.pop(k)
                self._loop.call_soon_threadsafe(self._schedule_close, ch)

    def _schedule_close(self, ch) -> None:
        task = self._loop.create_task(ch.close())
        self._close_tasks.add(task)
        task.add_done_callback(self._close_tasks.discard)

    async def close(self) -> None:
        self.gateway.store.remove_listener(self._on_deployment_event)
        channels, self._channels = list(self._channels.values()), {}
        for ch in channels:
            await ch.close()


class FastGatewayGrpc(_ChannelCacheBase):
    """The Seldon relay on the h2 data plane.

    Unary calls ride the plane's inline relay: the downstream DATA payload
    (already a framed gRPC message) goes to the engine verbatim and the
    engine's framed reply is written straight back.  A request costs one
    header scan, one token lookup and two coalesced writes: no task, no
    future, no proto decode and no re-framing."""

    def _new_channel(self, rec: DeploymentRecord, ep):
        return FastGrpcChannel(f"{ep.host}:{ep.grpc_port}")

    def seed_metadata(self, headers: list) -> None:
        """The request-headers hook, in the handler task's context (the
        streaming calls; the unary relays scan their headers inline)."""
        token = ""
        traceparent = None
        for k, v in headers:
            if k == OAUTH_METADATA_KEY.encode():
                token = v.decode()
            elif k == b"traceparent":
                traceparent = v.decode()
        _request_token.set(token)
        set_traceparent(traceparent)
        ensure_traceparent()
        set_engine_role("gateway")

    # -- the inline unary relay ---------------------------------------------

    def make_relay(self, method: str):
        """-> sync ``fn(conn, stream_id, headers, framed_body)``, the plane's
        relay handler for ``/seldon.protos.Seldon/<method>``."""
        path = f"/seldon.protos.Seldon/{method}".encode()
        gateway = self.gateway

        def relay(conn, stream_id: int, headers: list, framed: bytes) -> None:
            token = b""
            tp: bytes | None = None
            for k, v in headers:
                if k == b"oauth_token":
                    token = v
                elif k == b"traceparent":
                    tp = v
            # a trace-naive client gets a minted root, as on the REST
            # fronts, so the engine hop always correlates
            minted = None
            tp_parsed = parse_traceparent(tp.decode() if tp else None)
            if tp_parsed is None:
                minted = new_traceparent(sampled=RECORDER.should_sample())
                tp_parsed = parse_traceparent(minted)
                metadata: tuple = ((b"traceparent", minted.encode()),)
            else:
                metadata = ((b"traceparent", tp),)
            trace_id, peer_span, flags = tp_parsed
            t0_wall, t0 = time.time(), time.perf_counter()
            try:
                rec = _resolve_record(gateway, token.decode())
            except AuthError as e:
                conn.write_unary_response(stream_id, _failure_frame(str(e), e.status))
                return

            def span(status: int, attrs: dict) -> float:
                dt = time.perf_counter() - t0
                RECORDER.record_stage(STAGE_GATEWAY_RELAY, dt)
                RECORDER.record_span(
                    f"gateway.grpc.{method}", trace_id=trace_id,
                    span_id=peer_span if minted is not None else None,
                    parent_id=None if minted is not None else peer_span,
                    start=t0_wall, duration_s=dt, service=rec.name,
                    status="OK" if status == 0 else "ERROR",
                    attrs={"grpc_status": status, "engine.role": "gateway", **attrs},
                    sampled=bool(flags & 0x01))
                return dt

            # the content-addressed response tier on the relay (predictions
            # only: feedback mutates bandit state): the framed request bytes
            # are the canonical payload and the framed reply replays verbatim
            cache_key = None
            if method == "Predict" and gateway.cache_enabled_for(rec):
                from seldon_core_tpu_torch.cache import request_key

                cache_key = request_key("grpc:Predict", rec.spec_hash, framed)
                entry = gateway.cache.get(rec.oauth_key, cache_key)
                if entry is not None:
                    span(0, {"cache": "hit"})
                    conn.write_unary_response(stream_id, entry.value)
                    return

            def done(status: int, message: str, body: bytes) -> None:
                conn.relay_cancels.pop(stream_id, None)
                dt = span(status, {})
                # the framed request and reply cross verbatim: these lengths
                # are the relay's exact payload bytes
                WIRE.counter(WIRE_GATEWAY_GRPC, rec.name).record(
                    bytes_in=len(framed), bytes_out=len(body), duration_s=dt)
                if status == 0:
                    if cache_key is not None and gateway.cache is not None:
                        gateway.cache.put(rec.oauth_key, cache_key, body)
                    conn.write_unary_response(stream_id, body)
                elif status == 14 and "unreachable" in message:
                    conn.write_unary_response(stream_id, _failure_frame(message, 503))
                else:
                    # the engine answered and chose this status (e.g.
                    # INVALID_ARGUMENT): propagate it, never "engine down"
                    conn.write_unary_response(
                        stream_id, _failure_frame(message, _GRPC_TO_HTTP.get(status, 500)))

            channel = self._channel(rec)
            cancel = channel.try_call_framed(
                path, framed, done, timeout=gateway.timeout_s, metadata=metadata)
            if cancel is not None:
                conn.relay_cancels[stream_id] = cancel
                return
            # cold path, no connection yet: a client reset during the connect
            # cancels the task (no call issued); once the call is issued the
            # provisional cancel becomes the stream's own, unless the client
            # already reset, which cancels the issued call at once.
            # Registered before create_task: an eager task can run through
            # on_cancelable before create_task returns.
            holder: dict = {"cancel": None}

            def provisional_cancel():
                if holder["cancel"] is not None:
                    holder["cancel"]()

            conn.relay_cancels[stream_id] = provisional_cancel

            def on_cancelable(cancel2, sid=stream_id):
                if sid in conn.relay_cancels:
                    conn.relay_cancels[sid] = cancel2
                else:
                    cancel2()  # the client reset while connecting

            task = self._loop.create_task(channel.call_framed_connecting(
                path, framed, done, timeout=gateway.timeout_s, metadata=metadata,
                on_cancelable=on_cancelable))
            self._close_tasks.add(task)
            task.add_done_callback(self._close_tasks.discard)
            holder["cancel"] = task.cancel

        return relay

    async def stream_predict_raw(self, payload: bytes):
        """Relay the engine's server-streaming StreamPredict: messages go on
        verbatim as the engine yields them.  A failure before the first
        message is the stream's grpc-status; the engine's mid-stream error
        arrives as its trailers and is raised here verbatim.  A client that
        leaves cancels this task, whose upstream stream is reset, so the
        engine frees the request's slot."""
        try:
            rec = _resolve_record(self.gateway, _request_token.get())
        except AuthError as e:
            raise GrpcCallError(16 if e.status == 401 else 5, str(e)) from e
        try:
            async for msg in self._channel(rec).call_stream(
                "/seldon.protos.Seldon/StreamPredict", payload,
                timeout=self.gateway.stream_timeout_s,
                metadata=tuple(outgoing_headers().items()),
            ):
                yield msg
        except (ConnectionError, asyncio.TimeoutError, OSError) as e:
            raise GrpcCallError(14, f"engine unreachable: {e}") from e


class GatewayGrpc:
    """The JAX package's grpcio relay (``SCT_GRPC_IMPL=grpcio``): not in the
    port, refused by name."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GatewayGrpc: {GRPCIO_REFUSED}")


async def start_gateway_grpc(gateway, port: int, host: str | None = None):
    """The gateway's gRPC ingress on the h2 data plane; returns the server
    (``bound_port``, and ``gateway_handler`` for its lifecycle)."""
    use_grpcio()  # raises by name when the grpcio transport is asked for
    handler = FastGatewayGrpc(gateway, loop=asyncio.get_running_loop())
    server = FastGrpcServer(
        {},
        on_request_headers=handler.seed_metadata,
        stream_handlers={"/seldon.protos.Seldon/StreamPredict": handler.stream_predict_raw},
        relay_handlers={
            "/seldon.protos.Seldon/Predict": handler.make_relay("Predict"),
            "/seldon.protos.Seldon/SendFeedback": handler.make_relay("SendFeedback"),
        },
    )
    try:
        server.bound_port = await server.start(port, host=host)
    except Exception:
        await handler.close()
        raise
    server.gateway_handler = handler
    log.info("gateway gRPC (Seldon raw relay, h2 data plane) on :%d", server.bound_port)
    return server
