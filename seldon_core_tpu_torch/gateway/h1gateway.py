"""HTTP/1.1 splice front end: the gateway's REST data plane, the port's
copy of the JAX package's ``gateway/h1gateway.py``.

The reference's apife forwards the raw JSON body untouched (reference:
api-frontend/.../rest/RestClientController.java:136-144) but still pays a
full servlet stack per request.  Here the observation is taken to its
conclusion: on the hot path (``POST /api/v0.1/predictions``) the bytes the
gateway RECEIVES are exactly the bytes it SENDS — so after parsing just the
request line, ``Authorization``, and ``Content-Length``, the raw request
block is spliced verbatim onto a pooled engine connection and the engine's
response bytes are spliced straight back (head parsed only for framing).
No request/response objects, no header re-serialization, no body copy
beyond the kernel's.

Upstream, requests MULTIPLEX over a few persistent pipelined connections
(the h1 analogue of what HTTP/2 gives the gRPC relay): concurrent
downstream requests ride one engine socket back-to-back, so one coalesced
write carries many requests and one read returns many responses —
kernel-side cost per request approaches the direct path's.  Responses
dequeue strictly in order per connection (RFC 9112 §9.3.2); an engine
connection that dies replays its un-responded (idempotent) requests on a
fresh one.

Everything that needs real parsing (oauth grants, feedback reward
counters, tap-enabled predictions, ``/api/v0.1/disagg/generate``, ops
endpoints) falls back to
:class:`~seldon_core_tpu_torch.gateway.app.GatewayApp`'s
transport-independent cores.  The JAX splice front answers
``/api/v0.1/disagg/generate`` 404 (only its aiohttp front serves it); the
port's front is the only REST front, so it serves it.

SSE streaming (``/api/v0.1/predictions/stream``) rides the same splice:
chunked response bodies forward incrementally as they arrive, which gives
REST clients authenticated token streaming through the gateway.

Four guards hold the shared pipelined upstream: header names that are not
RFC 7230 tokens, and obs-fold lines, are refused (``_is_token``); replays
of a request the engine answers by closing are capped (``_MAX_REPLAYS``);
a connect that lands on an evicted pool fails its jobs with a prompt 503;
and the splice applies backpressure in both directions (a pipelining
client's reads pause past ``SCT_GW_PIPELINE_BUF``; a slow client pauses the
engine connection's reads).

Beyond the JAX front, for a record with several replicas the splice feeds
the router's circuit breaker with each request's outcome, and a request
whose replica refuses the connect (it was never sent) moves to another
replica instead of answering 503: a lost replica costs its clients no
error while the breaker ejects it.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import os
import time
import urllib.parse
from typing import Optional

from seldon_core_tpu_torch import chaos, qos
from seldon_core_tpu_torch.contract import failure_status_dict
from seldon_core_tpu_torch.gateway.auth import AuthError
from seldon_core_tpu_torch.obs import (
    LOOP_LAG,
    RECORDER,
    STAGE_GATEWAY_RELAY,
    WIRE,
    WIRE_GATEWAY_H1,
    close_exporters,
    configure_exporters_from_env,
    wire_stats_payload,
)
from seldon_core_tpu_torch.obs.spans import (
    TRACE_RESPONSE_HEADER,
    get_traceparent,
    new_traceparent,
    parse_traceparent,
)
from seldon_core_tpu_torch.runtime import settings as _settings
from seldon_core_tpu_torch.wire.iobuf import WriteCoalescer

log = logging.getLogger(__name__)

_REASONS = {
    200: b"OK", 400: b"Bad Request", 401: b"Unauthorized", 404: b"Not Found",
    405: b"Method Not Allowed", 411: b"Length Required",
    429: b"Too Many Requests", 502: b"Bad Gateway",
    503: b"Service Unavailable", 504: b"Gateway Timeout",
}

# POST paths spliced raw to the engine; value is the metrics service label
_SPLICE_PATHS = {
    b"/api/v0.1/predictions": "predictions",
    b"/api/v0.1/predictions/stream": "predictions_stream",
}

# persistent pipelined engine connections per replica: few enough that
# writes coalesce, enough that pipelining depth stays shallow
_MAX_UPSTREAM_CONNS = _settings.get_int("SCT_GW_UPSTREAM_CONNS")

# request body ceiling (the JAX aiohttp front's client_max_size)
_MAX_BODY = int(os.environ.get("GATEWAY_MAX_BODY", str(256 * 1024 * 1024)))

# downstream read-ahead cap while a response is in flight: a client
# pipelining (or flooding) past this parks in the KERNEL buffer via
# pause_reading instead of growing our bytearray unboundedly
_PIPELINE_BUF = _settings.get_int("SCT_GW_PIPELINE_BUF")


def _dual_stack_socket(port: int, reuse_port: bool):
    """A listening TCP socket on every IPv6 and IPv4 address (IPv4 alone on
    an IPv6-less host): the port's copy of the JAX package's helper in
    ``wire/h2grpc.py``."""
    import socket

    # proto must be IPPROTO_TCP (not 0): asyncio's transport layer only
    # applies TCP_NODELAY when sock.proto == IPPROTO_TCP, and sockets
    # accepted from this listener inherit its proto
    try:
        sock = socket.socket(socket.AF_INET6, socket.SOCK_STREAM, socket.IPPROTO_TCP)
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
        addr = ("::", port)
    except OSError:  # IPv6-less host
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM, socket.IPPROTO_TCP)
        addr = ("0.0.0.0", port)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if reuse_port:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    try:
        sock.bind(addr)
    except BaseException:
        sock.close()
        raise
    return sock

# hop-by-hop headers an intermediary must not forward (RFC 9112 §7.6.1)
_HOP_BY_HOP = (b"connection", b"keep-alive", b"proxy-connection", b"upgrade")

# RFC 7230 token characters — the only bytes legal in a header field NAME.
# The raw head splices onto a SHARED pipelined engine connection, so a name
# like "Transfer-Encoding : chunked" (whitespace before the colon) that this
# parser skips but a tolerant upstream honors would desync the pipeline:
# request smuggling.  Reject anything else before splicing.
_TOKEN_CHARS = frozenset(b"!#$%&'*+-.^_`|~0123456789"
                         b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"
                         b"abcdefghijklmnopqrstuvwxyz")


def _is_token(name: bytes) -> bool:
    return bool(name) and all(c in _TOKEN_CHARS for c in name)


# preassembled response-head fragments: the splice hot path appends the
# trace echo to every forwarded head, and encoding the header NAME per
# request is pure waste — it never changes
_TRACE_ECHO = TRACE_RESPONSE_HEADER.encode() + b": "
_CONTINUE_100 = b"HTTP/1.1 100 Continue\r\n\r\n"
_TRACEPARENT_INJECT = b"traceparent: "
_DEADLINE_INJECT = b"x-sct-deadline-ms: "


def _response(
    status: int,
    body: bytes,
    content_type: bytes = b"application/json",
    extra_headers: bytes = b"",
) -> bytes:
    return (
        b"HTTP/1.1 %d %s\r\ncontent-type: %s\r\ncontent-length: %d\r\n%s\r\n"
        % (status, _REASONS.get(status, b""), content_type, len(body), extra_headers)
        + body
    )


def _error_response(status: int, reason: str, retry_after: str | None = None) -> bytes:
    # QoS 429s and the paused 503 tell the client when to come back
    extra = b"retry-after: %s\r\n" % retry_after.encode() if retry_after else b""
    return _response(
        status,
        json.dumps(failure_status_dict(status, reason)).encode(),
        extra_headers=extra,
    )


# upstream replay budget: a request the engine answers by closing the
# connection gets this many fresh-connection retries before a 502 — without
# the cap a poisoned request connect/close-loops until the deadline reaper
_MAX_REPLAYS = 2


class _Job:
    """One spliced request in an upstream FIFO."""

    __slots__ = ("down", "raw", "streaming", "replays", "up", "route")

    def __init__(self, down: "_DownConn", raw: bytes, streaming: bool):
        self.down: "_DownConn | None" = down  # None once abandoned/failed
        self.raw: bytes = raw  # retained until its response starts (replay)
        self.streaming = streaming
        self.replays = 0  # connection-loss replays consumed so far
        self.up: "_UpConn | None" = None  # the conn carrying this job
        # multi-upstream records: (deployment key, replica key, replicas
        # whose connect failed for this job); None for a single upstream
        self.route: "tuple[str, str, frozenset] | None" = None


# ---------------------------------------------------------------------------
# Upstream (engine) side: pipelined multiplexing
# ---------------------------------------------------------------------------

class _UpConn(WriteCoalescer, asyncio.Protocol):
    """One persistent engine connection carrying pipelined requests;
    responses forward to the FIFO head's downstream as bytes arrive."""

    def __init__(self, pool: "_UpstreamPool"):
        self.pool = pool
        self.transport: asyncio.Transport | None = None
        self.streaming = False  # dedicated SSE conn: closed after its job
        self.fifo: collections.deque[_Job] = collections.deque()
        self.buf = bytearray()
        # write coalescing: many pipelined requests -> one syscall
        self._init_coalescer(pool.loop)
        self.status = 0
        # framing state for the ACTIVE (head-of-fifo) response
        self._in_head = True
        self._remaining: Optional[int] = None
        self._chunked = False
        self._close_framed = False
        self._chunk_state = 0  # 0=size line, 1=data, 2=data CRLF, 3=trailers
        self._chunk_left = 0

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()

    @property
    def alive(self) -> bool:
        return self.transport is not None and not self.transport.is_closing()

    # -- request side -------------------------------------------------------

    def send_request(self, job: _Job) -> None:
        job.up = self
        self.fifo.append(job)
        if chaos.ENABLED:
            rule = chaos.check("gw.h1")
            if rule is not None:
                # protocol context — nothing to raise into, so both kinds
                # kill the engine conn mid-splice: torn writes a partial
                # request first.  connection_lost runs the replay budget
                # for the whole FIFO, exactly as a real engine death would.
                if rule.kind == "torn":
                    self.queue_write(
                        job.raw[: max(1, int(len(job.raw) * rule.frac))]
                    )
                self.close()
                return
        self.queue_write(job.raw)

    # -- response side ------------------------------------------------------

    def data_received(self, data: bytes) -> None:
        if not self.fifo:
            # unsolicited bytes with nothing outstanding: protocol confusion
            self.close()
            return
        self.fifo[0].raw = b""  # response started: no replay for the head
        if self._in_head:
            self.buf += data
            while True:
                idx = self.buf.find(b"\r\n\r\n")
                if idx < 0:
                    return
                head = bytes(self.buf[: idx + 4])
                del self.buf[: idx + 4]
                try:
                    self._parse_head(head)
                except ValueError as e:
                    log.warning("bad engine response head: %s", e)
                    self._fail_all(f"bad engine response: {e}")
                    self.close()
                    return
                down = self.fifo[0].down
                if 100 <= self.status < 200:
                    # interim (e.g. 100 Continue): forward, keep head state
                    if down is not None:
                        down.forward(head)
                    continue
                self._in_head = False
                if down is not None:
                    down.forward_head(head)
                rest = bytes(self.buf)
                self.buf.clear()
                if rest:
                    self._feed_body(rest)
                elif self._body_done():
                    self._complete()
                return
        else:
            self._feed_body(data)

    def _parse_head(self, head: bytes) -> None:
        # memoized: an engine's response head repeats byte-for-byte at
        # steady state (same status/lengths; Date varies once a second)
        cached = self.pool.head_cache.get(head)
        if cached is not None:
            (self.status, self._remaining, self._chunked,
             self._close_framed) = cached
            self._chunk_state = 0
            self._chunk_left = 0
            return
        line_end = head.find(b"\r\n")
        parts = head[:line_end].split(b" ", 2)
        if len(parts) < 2:
            raise ValueError(f"bad status line {head[:line_end]!r}")
        self.status = int(parts[1])
        self._remaining = None
        self._chunked = False
        self._close_framed = False
        self._chunk_state = 0
        self._chunk_left = 0
        for line in head[line_end + 2 : -2].split(b"\r\n"):
            name, _, value = line.partition(b":")
            name = name.strip().lower()
            if name == b"content-length":
                self._remaining = int(value.strip())
            elif name == b"transfer-encoding":
                if b"chunked" in value.lower():
                    self._chunked = True
            elif name == b"connection":
                if value.strip().lower() == b"close":
                    self._close_framed = True
        if self.status in (204, 304):
            self._remaining = 0
        if not self._chunked and self._remaining is None:
            # no length, no chunking: framed by connection close — this conn
            # cannot carry the rest of its pipeline
            self._close_framed = True
        if len(self.pool.head_cache) >= 256:
            # clear-on-full: Date rotates every second, so stop-on-full
            # would go permanently cold after 256 distinct heads
            self.pool.head_cache.clear()
        self.pool.head_cache[head] = (
            self.status, self._remaining, self._chunked, self._close_framed
        )

    def _body_done(self) -> bool:
        return not self._chunked and self._remaining == 0

    def _feed_body(self, data: bytes) -> None:
        down = self.fifo[0].down
        if self._chunked:
            self._feed_chunked(data)
            return
        if self._remaining is None:  # close-framed: forward until EOF
            if down is not None:
                down.forward(data)
            return
        n = len(data)
        if n <= self._remaining:
            self._remaining -= n
            if down is not None:
                down.forward(data)
            if self._remaining == 0:
                self._complete()
        else:
            share = self._remaining
            self._remaining = 0
            if down is not None:
                down.forward(data[:share])
            self._complete()
            # remainder belongs to the NEXT pipelined response
            if data[share:]:
                self.data_received(data[share:])

    def _feed_chunked(self, data: bytes) -> None:
        """Incremental chunked-body forward: bytes stream downstream as they
        arrive (SSE events must not buffer), state tracks chunk boundaries."""
        down = self.fifo[0].down
        self.buf += data
        buf = self.buf
        pos = 0
        try:
            while True:
                if self._chunk_state == 0:  # chunk size line
                    nl = buf.find(b"\r\n", pos)
                    if nl < 0:
                        break
                    self._chunk_left = int(bytes(buf[pos:nl]).split(b";", 1)[0], 16)
                    pos = nl + 2
                    self._chunk_state = 3 if self._chunk_left == 0 else 1
                elif self._chunk_state == 1:  # chunk data
                    take = min(self._chunk_left, len(buf) - pos)
                    if take == 0:
                        break
                    pos += take
                    self._chunk_left -= take
                    if self._chunk_left == 0:
                        self._chunk_state = 2
                elif self._chunk_state == 2:  # CRLF after chunk data
                    if len(buf) - pos < 2:
                        break
                    pos += 2
                    self._chunk_state = 0
                else:  # trailers until blank line
                    nl = buf.find(b"\r\n", pos)
                    if nl < 0:
                        break
                    line = bytes(buf[pos:nl])
                    pos = nl + 2
                    if not line:
                        if down is not None:
                            down.forward(bytes(buf[:pos]))
                        rest = bytes(buf[pos:])
                        buf.clear()
                        self._complete()
                        if rest:
                            self.data_received(rest)
                        return
        except ValueError as e:
            log.warning("bad chunked framing from engine: %s", e)
            self._fail_all(f"bad chunked framing: {e}")
            self.close()
            return
        # forward everything consumed (complete chunks or mid-chunk data)
        if pos:
            if down is not None:
                down.forward(bytes(buf[:pos]))
            del buf[:pos]

    def _complete(self) -> None:
        job = self.fifo.popleft()
        status = self.status
        self._in_head = True
        if self._close_framed or self.streaming:
            # close-framed: the conn can't carry more responses; streaming:
            # dedicated conn, not in the pool's rotation — either way it
            # must not linger as an untracked idle socket
            self.close()  # connection_lost replays any remaining fifo
        if job.down is not None:
            if self._close_framed:
                # the forwarded head said "connection: close": the client
                # expects ITS connection to close too
                job.down.close_after = True
            job.down.upstream_done(status)

    def _fail_all(self, reason: str) -> None:
        jobs, self.fifo = list(self.fifo), collections.deque()
        for i, job in enumerate(jobs):
            if job.down is None:
                continue
            # the head response may be partially forwarded; the rest were
            # never answered
            job.down.upstream_failed(reason, forwarded=(i == 0 and not self._in_head))

    def connection_lost(self, exc) -> None:
        self.pool.drop(self)
        if not self.fifo:
            return
        jobs, self.fifo = list(self.fifo), collections.deque()
        head_active = not self._in_head
        # close-framed body: EOF IS completion for the head response
        if head_active and self._remaining is None and not self._chunked:
            job = jobs.pop(0)
            if job.down is not None:
                # close-delimited body: upstream EOF IS completion, and the
                # client (whose head said close-framed) needs the same EOF
                job.down.close_after = True
                job.down.upstream_done(self.status)
            head_active = False
        elif head_active:
            job = jobs.pop(0)
            if job.down is not None:
                job.down.upstream_failed(
                    f"engine connection lost mid-response: {exc}", forwarded=True
                )
            head_active = False
        # everything else was never answered: replay (predictions are
        # idempotent; feedback never rides the splice) — but only within
        # the replay budget: an engine that consistently closes on this
        # request would otherwise connect/close-loop to the deadline reaper
        for job in jobs:
            if job.down is None:
                continue
            if job.raw and job.replays < _MAX_REPLAYS:
                job.replays += 1
                self.pool.spawn_send(job)
            elif job.raw:
                job.down.upstream_failed(
                    f"engine closed the connection {job.replays + 1} times "
                    "without responding",
                    forwarded=False,
                    status=502,
                )
            else:
                job.down.upstream_failed(f"engine connection lost: {exc}", forwarded=False)


class _UpstreamPool:
    """A small set of persistent pipelined _UpConns for one engine."""

    def __init__(self, host: str, port: int, loop: asyncio.AbstractEventLoop):
        self.host = host
        self.port = port
        self.loop = loop
        self.conns: list[_UpConn] = []
        self.stream_conns: set[_UpConn] = set()  # dedicated SSE conns
        self.closed = False
        self.head_cache: dict[bytes, tuple] = {}  # response-head parse memo
        self._connecting = 0  # in-flight connects that count against the cap
        self.pending: collections.deque[_Job] = collections.deque()
        self._tasks: set[asyncio.Task] = set()

    def submit(self, job: _Job) -> None:
        """Queue on the least-loaded live connection, growing the set up to
        the cap; streaming jobs get a dedicated connection (a long-lived SSE
        response must not head-of-line-block pipelined unary calls).
        ``conns`` holds live conns only (pruned by drop())."""
        if not job.streaming:
            best = None
            best_depth = -1
            for c in self.conns:
                d = len(c.fifo)
                if d == 0:
                    c.send_request(job)
                    return
                if best is None or d < best_depth:
                    best, best_depth = c, d
            if len(self.conns) + self._connecting >= _MAX_UPSTREAM_CONNS:
                if best is not None:
                    best.send_request(job)
                else:
                    # every cap slot is an in-flight connect (cold burst):
                    # park until one lands
                    self.pending.append(job)
                return
        self.spawn_send(job)

    def spawn_send(self, job: _Job) -> None:
        """Connect a fresh conn, then send (cold path / replay / stream).
        Non-streaming connects count against the cap while in flight."""
        if not job.streaming:
            self._connecting += 1

        async def run():
            counted = not job.streaming
            try:
                _, conn = await self.loop.create_connection(
                    lambda: _UpConn(self), self.host, self.port
                )
            except OSError as e:
                if counted:
                    self._connecting -= 1
                # the request was never sent: a multi-upstream job moves to
                # another replica, else it fails now (parked jobs too: they
                # must not wait on a connect that failed)
                if job.down is not None:
                    job.down.upstream_unreachable(job, e)
                while self.pending:
                    p = self.pending.popleft()
                    if p.down is not None:
                        p.down.upstream_unreachable(p, e)
                return
            if counted:
                self._connecting -= 1
            if self.closed:
                # pool evicted while this connect was in flight (deployment
                # removed/updated): the job must fail NOW with a prompt 503,
                # not hang silently until the 504 reaper
                conn.close()
                if job.down is not None:
                    job.down.upstream_failed("deployment removed", forwarded=False)
                while self.pending:
                    p = self.pending.popleft()
                    if p.down is not None:
                        p.down.upstream_failed("deployment removed", forwarded=False)
                return
            if job.streaming:
                conn.streaming = True
                self.stream_conns.add(conn)
            else:
                self.conns.append(conn)
            conn.send_request(job)
            # drain parked jobs onto the now-live pool
            while self.pending:
                self.submit(self.pending.popleft())

        task = self.loop.create_task(run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def drop(self, conn: _UpConn) -> None:
        try:
            self.conns.remove(conn)
        except ValueError:
            pass
        self.stream_conns.discard(conn)

    def evict(self) -> None:
        self.closed = True
        conns, self.conns = self.conns, []
        streams, self.stream_conns = list(self.stream_conns), set()
        for c in conns:
            c.close()
        for c in streams:
            c.close()


# ---------------------------------------------------------------------------
# Downstream (client) side
# ---------------------------------------------------------------------------

class _DownConn(WriteCoalescer, asyncio.Protocol):
    def __init__(self, frontend: "H1SpliceFrontend"):
        self.frontend = frontend
        self.gateway = frontend.gateway
        self.transport: asyncio.Transport | None = None
        self.buf = bytearray()
        self._scan = 0
        self.awaiting = False  # a response (splice or fallback) is in flight
        self.job: _Job | None = None
        self.t0 = 0.0
        self.deadline = 0.0
        self.service = ""
        self.rec = None
        self.forwarded = False  # response bytes already written downstream
        self.close_after = False
        # wire accounting for the in-flight spliced request (obs/wire.py):
        # request head+body bytes, and response bytes as they forward
        self._req_bytes = 0
        self._resp_bytes = 0
        # (trace_id, span_id, parent_id, sampled, epoch_start) of the
        # in-flight spliced request; trace id echoed on the response head
        self._trace: tuple | None = None
        self.echo_trace_id: bytes | None = None
        self._sent_continue = False
        self._tasks: set[asyncio.Task] = set()
        # the in-flight spliced request's QoS admission ticket (released on
        # completion, failure, timeout reap, or client disconnect)
        self._qos_ticket = None
        # caching & reuse plane (docs/CACHING.md): the in-flight request's
        # cache key (leader of a potential collapse group), the response-
        # body capture, and — for a parked follower — the group key
        self._cache_key: str | None = None
        self._cap_buf: bytearray | None = None
        self._cap_status = 0
        self._collapse_key: str | None = None
        # backpressure: did we pause our own reads (pipelining client) /
        # the upstream conn's reads (slow client on a fast stream)?
        self._read_paused = False
        self._write_paused = False
        self._up_paused: "_UpConn | None" = None
        # write coalescing: response head + body (and any same-iteration
        # writes) leave in one syscall
        self._init_coalescer(frontend.loop)

    # -- flow control -------------------------------------------------------

    def pause_writing(self) -> None:
        """Downstream socket buffer is full (slow client).  Stop reading
        from the engine conn whose response is streaming to us, or a fast
        SSE stream buffers unboundedly in our transport."""
        self._write_paused = True
        job = self.job
        up = job.up if job is not None else None
        if (
            up is not None
            and up.fifo
            and up.fifo[0] is job
            and up.transport is not None
            and not up.transport.is_closing()
        ):
            try:
                up.transport.pause_reading()
                self._up_paused = up
            except RuntimeError:
                pass

    def resume_writing(self) -> None:
        self._write_paused = False
        self._resume_upstream()

    def _resume_upstream(self) -> None:
        up, self._up_paused = self._up_paused, None
        if up is not None and up.transport is not None and not up.transport.is_closing():
            try:
                up.transport.resume_reading()
            except RuntimeError:
                pass

    def _release_qos(self) -> None:
        ticket, self._qos_ticket = self._qos_ticket, None
        if ticket is not None:
            ticket.release()

    def write(self, data: bytes) -> None:
        self.queue_write(data)

    def _close(self) -> None:
        self.flush_now()
        if self.transport is not None:
            self.transport.close()

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass
        self.frontend._conns.add(self)

    def connection_lost(self, exc) -> None:
        self.frontend._conns.discard(self)
        self._release_qos()  # cancel-on-disconnect frees the admission slot
        self._resume_upstream()  # a dead client must not wedge the engine conn
        if self._collapse_key is not None:
            self.frontend.collapse_discard(self)
        key, self._cache_key = self._cache_key, None
        if key is not None:
            # the collapse leader vanished; its followers fail fast and
            # retry rather than waiting out the 504 reaper
            self.frontend.collapse_fail(key, 503, "collapsed leader disconnected")
        job, self.job = self.job, None
        if job is not None:
            # client went away: abandon the job — its response (if any)
            # gets consumed and discarded, keeping the upstream pipeline
            # intact for other clients
            job.down = None
        for t in self._tasks:
            t.cancel()

    # -- request processing -------------------------------------------------

    def data_received(self, data: bytes) -> None:
        self.buf += data
        if not self.awaiting:
            self._process()
        elif (
            len(self.buf) > _PIPELINE_BUF
            and not self._read_paused
            and self.transport is not None
        ):
            # a client pipelining (or flooding a body) ahead of its
            # in-flight response parks in the kernel buffer, not ours
            # (bounded read-ahead while awaiting)
            try:
                self.transport.pause_reading()
                self._read_paused = True
            except RuntimeError:
                pass

    def _process(self) -> None:
        while not self.awaiting:
            buf = self.buf
            idx = buf.find(b"\r\n\r\n", self._scan)
            if idx < 0:
                self._scan = max(0, len(buf) - 3)
                if len(buf) > 1 << 20:
                    self.write(_error_response(400, "request head too large"))
                    self._close()
                return
            head = bytes(buf[: idx + 4])
            # memoized: a steady-state client's request head repeats
            # byte-for-byte (same token, same lengths) across requests AND
            # across its connections
            cache = self.frontend.req_head_cache
            parsed = cache.get(head)
            if parsed is None:
                parsed = self._parse_request_head(head, idx)
                if parsed is None:
                    return  # error written, connection closing
                # bounded by count AND entry size: an unauthenticated peer
                # must not be able to pin megabytes via giant unique heads
                if len(head) <= 4096:
                    if len(cache) >= 256:
                        cache.clear()  # self-healing, never stop-on-full
                    cache[head] = parsed
            (method, route, content_length, auth, traceparent,
             deadline_ms, priority, chunked, expect, close_after,
             rewritten_head, splice_base, query) = parsed
            if chunked:
                # nothing we serve needs chunked uploads; keep the parser
                # simple and honest
                self.write(_error_response(411, "chunked requests unsupported"))
                self._close()
                return
            if content_length > _MAX_BODY:
                self.write(_error_response(400, "request body too large"))
                self._close()
                return
            if expect and not self._sent_continue:
                # ack exactly once per request, even when the body arrives
                # across many reads (each re-entering this parse)
                self.write(_CONTINUE_100)
                self._sent_continue = True
            total = idx + 4 + content_length
            if len(buf) < total:
                self._scan = idx  # head found; waiting on body bytes
                return
            self._scan = 0
            self._sent_continue = False
            self.close_after = close_after
            service = _SPLICE_PATHS.get(route) if method == b"POST" else None
            if service == "predictions" and (expect or self.gateway.tap.enabled):
                # Expect requests take the fallback hop so the engine never
                # sees the Expect header (we already sent the 100); tap
                # needs the body object.  Streams stay spliced: a duplicate
                # interim 100 is legal (RFC 9110 §15.2), losing streaming
                # through the fallback would not be.
                service = None
            if service is None:
                head_headers = (auth, traceparent, deadline_ms, priority,
                                query)
                body = bytes(buf[idx + 4 : total])
                del buf[:total]
                self.awaiting = True
                self.frontend.fallbacks += 1
                self.deadline = 0.0  # fallback cores carry their own timeouts
                task = self.frontend.loop.create_task(
                    self._fallback(method, route, head_headers, body)
                )
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                return
            # trace context: forward a client-sent (valid) traceparent
            # verbatim; mint a spec-valid root and INJECT it into the
            # spliced head when the client is trace-naive, so the engine's
            # spans always have a trace to join.  The same rebuild stamps
            # the per-deployment default deadline for SLO-naive clients
            # (a client-sent x-sct-deadline-ms splices through verbatim —
            # the microseconds spent here are not worth a rewrite).
            minted = None
            tp_parsed = parse_traceparent(traceparent)
            if tp_parsed is None:
                minted = new_traceparent(sampled=self.frontend.recorder.should_sample())
                tp_parsed = parse_traceparent(minted)
            inject_deadline = None
            if deadline_ms is None and self.gateway.default_deadline_ms:
                inject_deadline = self.gateway.default_deadline_ms
                deadline_ms = inject_deadline
            if rewritten_head is not None or minted is not None or inject_deadline:
                # hop-by-hop headers stripped / HTTP/1.0 line upgraded /
                # traceparent minted / deadline stamped: rebuild the head
                # for the shared upstream conn (RFC 9112 §7.6.1).  The
                # memoized ``splice_base`` (head minus the final CRLF) makes
                # this a flat concat — no per-request head slicing
                inject = b""
                if minted is not None:
                    inject += _TRACEPARENT_INJECT + minted.encode() + b"\r\n"
                if inject_deadline:
                    inject += _DEADLINE_INJECT + (
                        str(round(inject_deadline, 3)).encode()
                    ) + b"\r\n"
                raw = splice_base + inject + b"\r\n" + bytes(buf[idx + 4 : total])
            else:
                raw = bytes(buf[:total])
            del buf[:total]
            try:
                rec = self.gateway._principal_from_header(auth)
            except AuthError as e:
                self.frontend.observe("anonymous", "unknown", service, e.status, 0.0)
                self.write(_error_response(e.status, str(e)))
                if self.close_after:
                    self._close()
                    return
                continue
            if self.gateway._paused:
                # drained traffic must be a RECORDED 503, not a silent one
                self.frontend.observe(
                    rec.oauth_key, rec.name, service, 503, 0.0
                )
                self.write(_error_response(503, "gateway is paused", retry_after="1"))
                if self.close_after:
                    self._close()
                    return
                continue
            # content-addressed cache + collapse BEFORE QoS admission
            # (docs/CACHING.md): a hit costs no admission slot, no queue
            # position, no deadline budget, no engine socket; an identical
            # in-flight request parks as a follower of the one computing
            cache_key = None
            if service == "predictions" and self.gateway.cache_enabled_for(rec):
                from seldon_core_tpu_torch.cache import request_key

                body_bytes = (
                    raw[len(raw) - content_length:] if content_length else b""
                )
                cache_key = request_key(
                    "/api/v0.1/predictions", rec.spec_hash, body_bytes
                )
                entry = self.gateway.cache.get(rec.oauth_key, cache_key)
                echo = tp_parsed[0].encode()
                if entry is not None:
                    self.frontend.observe(
                        rec.oauth_key, rec.name, service, entry.status, 0.0
                    )
                    self.write(_response(
                        entry.status, entry.value,
                        extra_headers=(
                            _TRACE_ECHO + echo + b"\r\nx-sct-cache: hit\r\n"
                        ),
                    ))
                    if self.close_after:
                        self._close()
                        return
                    continue
                if not self.frontend.collapse_claim(cache_key, self):
                    # follower: the leader's response fans out to us on
                    # completion; the reaper 504s us if it never lands
                    from seldon_core_tpu_torch.utils.metrics import DEFAULT as _M

                    _M.cache_collapsed.labels(rec.name).inc()
                    self._collapse_key = cache_key
                    self.rec = rec
                    self.service = service
                    self.awaiting = True
                    self.forwarded = False
                    self.t0 = time.perf_counter()
                    trace_id, peer_span, flags = tp_parsed
                    self._trace = (
                        trace_id,
                        peer_span if minted is not None else None,
                        None if minted is not None else peer_span,
                        bool(flags & 0x01),
                        time.time(),
                    )
                    self.echo_trace_id = trace_id.encode()
                    self._req_bytes = len(raw)
                    self._resp_bytes = 0
                    self.deadline = (
                        self.frontend.loop.time() + self.gateway.timeout_s
                    )
                    return
            # QoS admission (per-deployment; inert unless SCT_GW_QOS_* is
            # configured): shed HERE, before any engine socket is touched
            try:
                ticket = self.gateway.qos_for(rec).admit(
                    priority,
                    budget_s=deadline_ms / 1e3 if deadline_ms else None,
                )
            except qos.QosRejection as e:
                self.frontend.observe(
                    rec.oauth_key, rec.name, service, e.status, 0.0
                )
                self.write(_error_response(
                    e.status, str(e),
                    retry_after=e.retry_after_header() if e.status == 429 else None,
                ))
                if self.close_after:
                    self._close()
                    return
                continue
            self._qos_ticket = ticket
            streaming = service == "predictions_stream"
            self.rec = rec
            self.service = service
            self.awaiting = True
            self.forwarded = False
            self.t0 = time.perf_counter()
            trace_id, peer_span, flags = tp_parsed
            self._trace = (
                trace_id,
                # minted root: the injected span id IS the gateway's span,
                # so the engine parents under it; client-sent: the gateway
                # span is a fresh sibling of the engine's under the client
                peer_span if minted is not None else None,
                None if minted is not None else peer_span,
                bool(flags & 0x01),
                time.time(),
            )
            self.echo_trace_id = trace_id.encode()
            timeout = (
                self.gateway.stream_timeout_s if streaming else self.gateway.timeout_s
            )
            self.deadline = self.frontend.loop.time() + timeout
            # the pick may splice a peer prefix hint into the head, so it
            # runs BEFORE the job captures the bytes (docs/CACHING.md)
            pool, raw, ep_key = self.frontend.pool_and_hint(rec, raw, content_length)
            self._req_bytes = len(raw)
            self._resp_bytes = 0
            # collapse leader: capture the response body for the cache and
            # for follower fan-out (forward_head validates the framing)
            self._cache_key = cache_key
            self._cap_buf = None
            self._cap_status = 0
            job = _Job(self, raw, streaming)
            if len(rec.replica_endpoints) > 1:
                job.route = (rec.oauth_key, ep_key, frozenset())
            self.job = job
            self.frontend.spliced += 1
            pool.submit(job)
            return

    def _parse_request_head(self, head: bytes, idx: int) -> tuple | None:
        """Full request-head parse (cache miss); returns None after writing
        an error response for malformed input."""
        line_end = head.find(b"\r\n")
        parts = head[:line_end].split(b" ", 2)
        if len(parts) != 3:
            self.write(_error_response(400, "malformed request line"))
            self._close()
            return None
        method, path, version = parts
        # strip query string for routing (forwarded verbatim; fallback
        # cores that need it — /stats/timeline?trace= — get it from the
        # parsed tuple, which memoizes with the head it came from)
        route, _, query = path.partition(b"?")
        content_length = None
        auth = ""
        traceparent = None
        deadline_ms = None
        priority = qos.PRIO_INTERACTIVE
        chunked = False
        expect = False
        close_after = version == b"HTTP/1.0"
        needs_rewrite = version != b"HTTP/1.1"
        kept_lines = []
        for line in head[line_end + 2 : -4].split(b"\r\n"):
            if not line:
                continue  # zero-header request: the slice is one empty string
            name, sep, value = line.partition(b":")
            # strict field-name grammar (RFC 7230 §3.2): no colon at all,
            # obs-fold continuations (leading SP/HTAB), and names with
            # whitespace/control/non-token bytes are smuggling vectors on
            # the shared spliced upstream — reject the request outright
            if not sep or not _is_token(name):
                self.write(_error_response(400, "bad header field name"))
                self._close()
                return None
            name = name.lower()
            if name in _HOP_BY_HOP:
                needs_rewrite = True
            else:
                kept_lines.append(line)
            if name == b"content-length":
                # STRICT parse: the raw head is spliced onto a shared
                # pipelined engine connection, so any framing value the
                # engine could read differently (signs, underscores,
                # duplicates) is a request-smuggling vector — reject
                v = value.strip()
                if not v.isdigit() or (
                    content_length is not None and content_length != int(v)
                ):
                    self.write(_error_response(400, "bad content-length"))
                    self._close()
                    return None
                content_length = int(v)
            elif name == b"authorization":
                auth = value.strip().decode("latin-1")
            elif name == b"traceparent":
                traceparent = value.strip().decode("latin-1")
            elif name == b"x-sct-deadline-ms":
                deadline_ms = qos.parse_deadline_ms(value.strip())
            elif name == b"x-sct-priority":
                priority = qos.parse_priority(value.strip())
            elif name == b"transfer-encoding":
                chunked = b"chunked" in value.lower()
            elif name == b"expect":
                expect = b"100-continue" in value.lower()
            elif name == b"connection":
                v = value.strip().lower()
                if v == b"close":
                    close_after = True
                elif v == b"keep-alive":
                    close_after = False
        rewritten = None
        if needs_rewrite:
            # rebuild the head for the shared upstream conn: HTTP/1.1 line,
            # hop-by-hop headers dropped (the gateway owns both connections'
            # lifecycle; the client's Connection choice binds only downstream)
            rewritten = (
                method + b" " + path + b" HTTP/1.1\r\n"
                + b"\r\n".join(kept_lines)
                + (b"\r\n\r\n" if kept_lines else b"\r\n")
            )
        # precomputed splice base (head minus the final CRLF): the per-
        # request trace/deadline injection becomes one flat concat, and at
        # steady state this whole tuple comes from the head memo
        base = (rewritten if rewritten is not None else head)[:-2]
        return (
            method, route, content_length or 0, auth, traceparent,
            deadline_ms, priority, chunked, expect, close_after, rewritten,
            base, query,
        )

    # -- splice callbacks ---------------------------------------------------

    def forward(self, data: bytes) -> None:
        self.forwarded = True
        self._resp_bytes += len(data)
        if self._cap_buf is not None:
            self._cap_buf += data
        self.write(data)

    def forward_head(self, head: bytes) -> None:
        """Forward the engine's (final) response head, echoing the trace id
        so the client can correlate without parsing spans."""
        self.forwarded = True
        if self._cache_key is not None:
            # capture only content-length-framed bodies: chunked/close-
            # framed responses forward with framing bytes interleaved and
            # are not replayable to cache hits or collapse followers
            try:
                self._cap_status = int(head.split(b" ", 2)[1])
            except (ValueError, IndexError):
                self._cap_status = 0
            hl = head.lower()
            replayable = (
                b"transfer-encoding" not in hl
                and b"connection: close" not in hl
                and b"content-length" in hl
            )
            self._cap_buf = bytearray() if replayable else None
        echo = self.echo_trace_id
        if echo:
            head = head[:-2] + _TRACE_ECHO + echo + b"\r\n\r\n"
        self._resp_bytes += len(head)
        self.write(head)

    def _finish_trace(self, status: int, dt: float) -> None:
        """Record the relay stage, wire bytes, and root span for one
        spliced request (span assembled by hand: the splice lives in
        protocol callbacks, not in one task's contextvar scope)."""
        rec = self.frontend.recorder
        rec.record_stage(STAGE_GATEWAY_RELAY, dt)
        self.frontend.wire_for(self.rec).record(
            bytes_in=self._req_bytes,
            bytes_out=self._resp_bytes,
            duration_s=dt,
        )
        self._req_bytes = 0
        self._resp_bytes = 0
        tr, self._trace = self._trace, None
        self.echo_trace_id = None
        if tr is None:
            return
        trace_id, span_id, parent_id, sampled, start = tr
        rec.record_span(
            "gateway.relay",
            trace_id=trace_id,
            span_id=span_id,
            parent_id=parent_id,
            start=start,
            duration_s=dt,
            service=self.service,
            status="OK" if status < 400 else "ERROR",
            attrs={"code": status, "engine.role": "gateway"},
            sampled=sampled,
        )

    def upstream_unreachable(self, job: _Job, exc: OSError) -> None:
        """The connect for ``job`` failed: another replica takes it when
        the record has one left untried, else the client gets the 503."""
        if not self.frontend.reroute(job):
            self.upstream_failed(f"engine unreachable: {exc}", forwarded=False)

    def upstream_done(self, status: int) -> None:
        self.frontend.note_outcome(self.job, status < 502 or status > 504)
        self.job = None
        self._release_qos()
        self._resume_upstream()
        rec = self.rec
        dt = time.perf_counter() - self.t0
        self._finish_trace(status, dt)
        self.frontend.observe(
            rec.oauth_key if rec else "anonymous",
            rec.name if rec else "unknown",
            self.service,
            status,
            dt,
        )
        key, self._cache_key = self._cache_key, None
        if key is not None:
            body = (
                bytes(self._cap_buf)
                if self._cap_buf is not None and self._cap_status == status
                else None
            )
            self._cap_buf = None
            if (
                body is not None
                and status == 200
                and rec is not None
                and self.gateway.cache is not None
            ):
                self.gateway.cache.put(rec.oauth_key, key, body)
            self.frontend.collapse_done(key, status, body)
        self._next()

    def upstream_failed(self, reason: str, forwarded: bool, status: int = 503) -> None:
        self.frontend.note_outcome(self.job, False)
        self.job = None
        self._release_qos()
        self._resume_upstream()
        key, self._cache_key = self._cache_key, None
        self._cap_buf = None
        if key is not None:
            self.frontend.collapse_fail(key, status, reason)
        rec = self.rec
        dt = time.perf_counter() - self.t0
        self._finish_trace(status, dt)
        self.frontend.observe(
            rec.oauth_key if rec else "anonymous",
            rec.name if rec else "unknown",
            self.service,
            status,
            dt,
        )
        if self.transport is None or self.transport.is_closing():
            return
        if forwarded or self.forwarded:
            # a partial response is on the wire: the only honest move is to
            # cut the connection so the client sees a broken response
            self._close()
            return
        self.write(_error_response(status, reason))
        self._next()

    def _next(self) -> None:
        self.awaiting = False
        self.rec = None
        if self.transport is None or self.transport.is_closing():
            return
        if self.close_after:
            self._close()
            return
        if self._read_paused:
            # response delivered: drain whatever the client pipelined
            # behind it out of the kernel buffer
            self._read_paused = False
            try:
                self.transport.resume_reading()
            except RuntimeError:
                pass
        if self.buf:
            self._process()

    def collapse_resolve(
        self, status: int, body: bytes | None, reason: str | None = None
    ) -> None:
        """A parked follower receives the collapse leader's outcome: the
        captured response verbatim (own trace id echoed), or the leader's
        failure status."""
        self._collapse_key = None
        rec = self.rec
        dt = time.perf_counter() - self.t0
        self._resp_bytes = len(body) if body is not None else 0
        self._finish_trace(status, dt)
        self.frontend.observe(
            rec.oauth_key if rec else "anonymous",
            rec.name if rec else "unknown",
            self.service,
            status,
            dt,
        )
        if self.transport is None or self.transport.is_closing():
            return
        if body is not None:
            echo = self.echo_trace_id or b""
            self.write(_response(
                status, body,
                extra_headers=(
                    _TRACE_ECHO + echo + b"\r\nx-sct-cache: collapsed\r\n"
                ),
            ))
        else:
            self.write(_error_response(
                status, reason or "collapsed upstream response not replayable"
            ))
        self._next()

    # -- fallback (full-parse) path -----------------------------------------

    async def _fallback(self, method: bytes, route: bytes, meta, body: bytes) -> None:
        auth, traceparent, deadline_ms, priority, query = meta
        try:
            status, payload, ctype = await self.frontend.handle_fallback(
                method, route, auth, traceparent, body,
                deadline_ms=deadline_ms, priority=priority, query=query,
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            log.exception("fallback handler failed")
            status, payload, ctype = 500, json.dumps(
                failure_status_dict(500, f"{type(e).__name__}: {e}")
            ).encode(), b"application/json"
        if self.transport is not None and not self.transport.is_closing():
            extra = b""
            parsed = parse_traceparent(get_traceparent())
            if parsed is not None and route in (
                b"/api/v0.1/predictions", b"/api/v0.1/feedback",
                b"/api/v0.1/disagg/generate",
            ):
                # ingress_core seeded/minted the trace in this task's context
                extra = _TRACE_ECHO + parsed[0].encode() + b"\r\n"
            if status in (429, 503):
                # ingress_core left a precise hint in the qos context when
                # it shed; the drain-paused 503 gets the 1s default
                extra += b"retry-after: %s\r\n" % (
                    (qos.get_retry_after() or "1").encode()
                )
            self.write(_response(status, payload, ctype, extra_headers=extra))
        self._next()


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------

class H1SpliceFrontend:
    """The gateway's REST server."""

    def __init__(self, gateway):
        self.gateway = gateway
        self.recorder = RECORDER
        self.loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_DownConn] = set()
        self._pools: dict[str, _UpstreamPool] = {}
        # collapse groups: cache key -> parked follower conns (the leader
        # is the conn whose _cache_key matches; docs/CACHING.md)
        self._collapse: dict[str, list[_DownConn]] = {}
        self.collapsed = 0  # lifetime follower count (stats/cache)
        # fast-path accounting: spliced (zero-parse forward) vs fallback
        # (full-parse core) requests — the ratio IS the fast-path coverage
        self.spliced = 0
        self.fallbacks = 0
        self.rerouted = 0  # spliced jobs moved off a replica that refused the connect
        self.req_head_cache: dict[bytes, tuple] = {}  # request-head parse memo
        self._metric_children: dict[tuple, object] = {}
        self._wire_children: dict[str, object] = {}  # per-deployment counters
        self._reap_handle: asyncio.TimerHandle | None = None
        self.bound_port = 0
        from seldon_core_tpu_torch.gateway.store import EndpointDiff

        self._ep_diff = EndpointDiff()
        self._ep_diff.seed(gateway.store.list())
        gateway.store.add_listener(self._on_deployment_event)

    def _on_deployment_event(self, event: str, rec) -> None:
        gone = self._ep_diff.removed(event, rec)
        if event in ("removed", "updated"):
            # evict ONLY the replicas the update removed (pools are keyed
            # per (deployment, replica)); survivors keep warm connections
            # across autoscale events
            doomed = [
                k for k in self._pools
                if k[0] == rec.oauth_key and k[1] in gone
            ]
            for k in doomed:
                pool = self._pools.pop(k)
                if self.loop is not None:
                    self.loop.call_soon_threadsafe(pool.evict)

    def note_outcome(self, job: "_Job | None", ok: bool) -> None:
        """Feed the replica's circuit breaker with a spliced request's
        outcome (multi-upstream records only)."""
        if job is not None and job.route is not None:
            router = self.gateway.router
            (router.note_success if ok else router.note_failure)(job.route[0], job.route[1])

    def reroute(self, job: _Job) -> bool:
        """Move a job whose replica refused the connect to another replica
        of its record (a p2c pick among those not yet tried): the request
        was never sent, so any request may move.  The failure feeds the
        replica's breaker.  False when none is left."""
        if job.route is None:
            return False
        dep, key, tried = job.route
        router = self.gateway.router
        router.note_failure(dep, key)
        tried = tried | {key}
        rec = self.gateway.store.get(dep)
        left = [ep for ep in (rec.replica_endpoints if rec is not None else ())
                if ep.key not in tried]
        if not left:
            job.route = None  # noted: the failure that follows counts once
            return False
        ep, _ = router.pick_with_peer(dep, left, None, None)
        job.route = (dep, ep.key, tried)
        self.rerouted += 1
        self._pool(rec, ep).submit(job)
        return True

    def _pool(self, rec, ep) -> _UpstreamPool:
        key = (rec.oauth_key, ep.key)
        pool = self._pools.get(key)
        if pool is None:
            pool = _UpstreamPool(ep.host, ep.rest_port, self.loop)
            self._pools[key] = pool
        return pool

    def pool_and_hint(
        self, rec, raw: bytes | None = None, content_length: int = 0
    ) -> "tuple[_UpstreamPool, bytes | None, str]":
        """Upstream pool for one request.  Single-upstream records (the
        overwhelmingly common case) cost one dict hit; multi-upstream
        records pick a replica per request — prefix-aware against polled
        digests when the request body carries tokens, p2c on load
        otherwise (disagg/router.py).  With it the tiered-prefix peer hint:
        when the router yields prefix affinity to load, the advertising replica + chain depth are spliced
        into the request head as ``x-sct-prefix-peer`` /
        ``x-sct-prefix-depth`` so the chosen engine pulls the chain instead
        of re-prefilling.  Returns ``(pool, raw, replica key)`` — ``raw`` is
        the original bytes when no hint fired (the common case costs nothing
        beyond the pick it already paid)."""
        endpoints = rec.replica_endpoints
        ep = endpoints[0]
        hint = None
        if len(endpoints) > 1:
            router = self.gateway.router
            tokens = adapter = None
            if (
                raw is not None
                and content_length
                and router.has_digests(rec.oauth_key)
            ):
                from seldon_core_tpu_torch.disagg.router import (
                    extract_prompt_request,
                )

                tokens, adapter = extract_prompt_request(
                    raw[len(raw) - content_length:]
                )
            ep, hint = router.pick_with_peer(
                rec.oauth_key, endpoints, tokens, adapter
            )
        pool = self._pool(rec, ep)
        if hint is not None and raw is not None:
            # inject before the head's final CRLF (RFC 9112 §7.6.1 —
            # same rebuild discipline as the traceparent splice)
            i = raw.find(b"\r\n\r\n")
            if i >= 0:
                inject = (
                    b"x-sct-prefix-peer: " + hint[0].encode() + b"\r\n"
                    b"x-sct-prefix-depth: "
                    + str(int(hint[1])).encode() + b"\r\n"
                )
                raw = raw[: i + 2] + inject + raw[i + 2:]
        return pool, raw, ep.key

    def wire_for(self, rec) -> "object":
        """Per-deployment wire byte counter for the splice path (cached —
        the WIRE registry lock must stay off the per-request path)."""
        name = rec.name if rec is not None else "unknown"
        counter = self._wire_children.get(name)
        if counter is None:
            counter = WIRE.counter(WIRE_GATEWAY_H1, name)
            self._wire_children[name] = counter
        return counter

    # -- request collapsing --------------------------------------------------

    def collapse_claim(self, key: str, conn: _DownConn) -> bool:
        """True -> ``conn`` leads the group for ``key`` and proceeds
        upstream; False -> it parked as a follower."""
        followers = self._collapse.get(key)
        if followers is None:
            self._collapse[key] = []
            return True
        followers.append(conn)
        self.collapsed += 1
        return False

    def collapse_done(self, key: str, status: int, body: bytes | None) -> None:
        followers = self._collapse.pop(key, None)
        if not followers:
            return
        if body is None and status < 400:
            # the leader's response wasn't replayable (chunked/close-framed)
            status = 502
        for f in followers:
            f.collapse_resolve(status, body)

    def collapse_fail(self, key: str, status: int, reason: str) -> None:
        followers = self._collapse.pop(key, None)
        if not followers:
            return
        for f in followers:
            f.collapse_resolve(status, None, reason)

    def collapse_discard(self, conn: _DownConn) -> None:
        """A parked follower went away (disconnect / reap)."""
        key, conn._collapse_key = conn._collapse_key, None
        followers = self._collapse.get(key) if key is not None else None
        if followers is not None and conn in followers:
            followers.remove(conn)

    def observe(self, principal: str, name: str, service: str, code: int, dt: float) -> None:
        key = (principal, name, service, code)
        child = self._metric_children.get(key)
        if child is None:
            child = self.gateway.metrics.ingress_requests.labels(
                principal, name, service, "POST", str(code)
            )
            if len(self._metric_children) < 4096:
                self._metric_children[key] = child
        child.observe(dt)

    # -- lifecycle ----------------------------------------------------------

    async def start(self, port: int, host: str | None = None) -> int:
        self.loop = asyncio.get_running_loop()
        configure_exporters_from_env()
        LOOP_LAG.start("gateway")
        if host is None:
            sock = _dual_stack_socket(port, reuse_port=False)
            self._server = await self.loop.create_server(
                lambda: _DownConn(self), sock=sock
            )
        else:
            self._server = await self.loop.create_server(
                lambda: _DownConn(self), host, port
            )
        self.bound_port = self._server.sockets[0].getsockname()[1]
        self._reap_handle = self.loop.call_later(1.0, self._reap)
        return self.bound_port

    def _reap(self) -> None:
        now = self.loop.time()
        for conn in list(self._conns):
            if conn.awaiting and conn.deadline and now >= conn.deadline:
                job, conn.job = conn.job, None
                conn._release_qos()
                conn._resume_upstream()
                if conn._collapse_key is not None:
                    self.collapse_discard(conn)  # timed-out follower
                key, conn._cache_key = conn._cache_key, None
                if key is not None:
                    # timed-out leader: its followers 504 with it
                    self.collapse_fail(key, 504, "engine timed out")
                if job is not None:
                    job.down = None  # discard whatever the engine returns
                # the timeout is a real 504: ingress metrics + the relay
                # span must both say so
                rec = conn.rec
                dt = time.perf_counter() - conn.t0
                conn._finish_trace(504, dt)
                self.observe(
                    rec.oauth_key if rec else "anonymous",
                    rec.name if rec else "unknown",
                    conn.service,
                    504,
                    dt,
                )
                if conn.transport is not None and not conn.transport.is_closing():
                    if not conn.forwarded:
                        conn.write(_error_response(504, "engine timed out"))
                    conn._close()
        self._reap_handle = self.loop.call_later(1.0, self._reap)

    async def stop(self) -> None:
        self.gateway.store.remove_listener(self._on_deployment_event)
        if self.loop is not None:
            LOOP_LAG.stop()
            await close_exporters()
        if self._reap_handle is not None:
            self._reap_handle.cancel()
            self._reap_handle = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for conn in list(self._conns):
            if conn.transport is not None:
                conn.transport.close()
        self._conns.clear()
        pools, self._pools = list(self._pools.values()), {}
        for p in pools:
            p.evict()

    # -- fallback routing ---------------------------------------------------

    async def handle_fallback(
        self,
        method: bytes,
        route: bytes,
        auth: str,
        traceparent: str | None,
        body: bytes,
        deadline_ms: float | None = None,
        priority: str = qos.PRIO_INTERACTIVE,
        query: bytes = b"",
    ) -> tuple[int, bytes, bytes]:
        gw = self.gateway
        # ingress_core re-parses header VALUES, so hand the already-parsed
        # ones back in wire form
        qos_kw = dict(
            deadline_header=str(deadline_ms) if deadline_ms else None,
            priority_header=priority,
        )
        if route == b"/api/v0.1/predictions" and method == b"POST":
            status, payload = await gw.ingress_core(
                auth, traceparent, body, "/api/v0.1/predictions", "predictions",
                **qos_kw,
            )
            return status, payload, b"application/json"
        if route == b"/api/v0.1/feedback" and method == b"POST":
            status, payload = await gw.ingress_core(
                auth, traceparent, body, "/api/v0.1/feedback", "feedback",
                **qos_kw,
            )
            return status, payload, b"application/json"
        if route == b"/api/v0.1/disagg/generate" and method == b"POST":
            # a disaggregated generation through the deployment's
            # (prefill-pool) engine: the standard ingress, never the cache
            status, payload = await gw.ingress_core(
                auth, traceparent, body, "/disagg/generate", "disagg_generate",
                **qos_kw,
            )
            return status, payload, b"application/json"
        if route == b"/oauth/token" and method == b"POST":
            client_id = client_secret = ""
            if auth.startswith("Basic "):
                import base64

                try:
                    decoded = base64.b64decode(auth[6:]).decode()
                    client_id, _, client_secret = decoded.partition(":")
                except Exception:
                    return 400, json.dumps(
                        failure_status_dict(400, "malformed basic auth header")
                    ).encode(), b"application/json"
            if not client_id:
                form = urllib.parse.parse_qs(body.decode("latin-1"))
                client_id = (form.get("client_id") or [""])[0]
                client_secret = (form.get("client_secret") or [""])[0]
            status, payload = gw.issue_token(client_id, client_secret)
            return status, json.dumps(payload).encode(), b"application/json"
        if route == b"/ping":
            return 200, b"pong", b"text/plain"
        if route == b"/ready":
            if gw._paused:
                return 503, b"paused", b"text/plain"
            return 200, b"ready", b"text/plain"
        if route == b"/pause" and method == b"POST":
            gw._paused = True
            return 200, b"paused", b"text/plain"
        if route == b"/unpause" and method == b"POST":
            gw._paused = False
            return 200, b"unpaused", b"text/plain"
        if route == b"/prometheus":
            gw.metrics.refresh_usage()
            return 200, gw.metrics.expose(), gw.metrics.expose_content_type().encode()
        if route == b"/stats/spans":
            return 200, json.dumps(self.recorder.stats(n=20)).encode(), b"application/json"
        if route == b"/stats/breakdown":
            return 200, json.dumps({"stages": self.recorder.breakdown()}).encode(), b"application/json"
        if route == b"/stats/qos":
            return 200, json.dumps({"qos": gw.qos_snapshot()}).encode(), b"application/json"
        if route == b"/stats/wire":
            payload = wire_stats_payload()
            payload["h1_frontend"] = {
                "spliced": self.spliced,
                "fallbacks": self.fallbacks,
                "rerouted": self.rerouted,
                "req_head_cache": len(self.req_head_cache),
            }
            return 200, json.dumps(payload).encode(), b"application/json"
        if route == b"/stats/cache":
            snap = gw.cache_snapshot()
            snap["h1_collapse"] = {
                "groups_inflight": len(self._collapse),
                "collapsed": self.collapsed,
            }
            return 200, json.dumps({"cache": snap}).encode(), b"application/json"
        if route == b"/stats/route":
            return 200, json.dumps(
                {"route": gw.route_snapshot()}
            ).encode(), b"application/json"
        if route == b"/stats/fleet":
            return 200, json.dumps(
                {"fleet": gw.fleet_snapshot()}
            ).encode(), b"application/json"
        if route == b"/stats/slo":
            return 200, json.dumps(
                {"slo": gw.slo_snapshot()}
            ).encode(), b"application/json"
        if route == b"/stats/autoscale":
            return 200, json.dumps(
                {"autoscale": gw.autoscale_snapshot()}
            ).encode(), b"application/json"
        if route == b"/stats/usage":
            return 200, json.dumps(
                {"usage": gw.usage_snapshot()}
            ).encode(), b"application/json"
        if route == b"/stats/timeline":
            form = urllib.parse.parse_qs(query.decode("latin-1"))
            trace = (form.get("trace") or [""])[0]
            if not trace:
                return 400, json.dumps(failure_status_dict(
                    400, "trace query parameter required"
                )).encode(), b"application/json"
            return 200, json.dumps(
                await gw.fleet.fan_timeline(trace)
            ).encode(), b"application/json"
        return 404, json.dumps(
            failure_status_dict(404, f"no route {route.decode('latin-1')}")
        ).encode(), b"application/json"
