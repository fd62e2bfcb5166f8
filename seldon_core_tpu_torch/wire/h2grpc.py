"""gRPC directly on asyncio, the port's data plane for gRPC: a copy of the
JAX package's ``wire/h2grpc.py`` on the stdlib alone (the card has no
grpcio).

After connection warmup a unary gRPC request is two small frames whose
headers are mostly 1-byte HPACK indexed fields (``wire/hpack.py``), so the
unary and server-streaming slice of HTTP/2 (RFC 7540) on asyncio serves
the protocol at its intended cost while staying interoperable with
standard grpc clients and servers.

Scope: unary-unary and server-streaming calls (token streaming for
generative serving), plaintext (h2c prior knowledge, what grpc uses on
insecure channels).  Implemented: connection preface, SETTINGS exchange
and ack, HEADERS (+CONTINUATION), DATA, full HPACK decode, both
directions of flow control (connection and stream windows, split on the
peer's max frame size, producer backpressure through ``drain_sends``),
PING reply, RST_STREAM and GOAWAY.  Not implemented: client-streaming and
bidi RPCs, push, priorities (ignored, optional per spec), TLS.

A server connection that is lost cancels its handler tasks and every
in-flight inline relay (``_ServerConn._on_closed``), so a dead client
never leaves an upstream engine computing until the channel's reaper.
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import struct
from typing import Any, Awaitable, Callable

from seldon_core_tpu_torch.wire import hpack
from seldon_core_tpu_torch.wire.iobuf import WriteCoalescer

log = logging.getLogger(__name__)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
END_STREAM = 0x1
ACK = 0x1
END_HEADERS = 0x4
PADDED = 0x8
PRIORITY_FLAG = 0x20

SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

DEFAULT_WINDOW = 65535
BIG_WINDOW = 16 * 1024 * 1024  # what we advertise for receives
DEFAULT_MAX_FRAME = 16384

_RAW_FRAME = -1  # send-queue marker: pre-framed bytes riding behind DATA

GRPC_STATUS_OK = 0
GRPC_STATUS_UNKNOWN = 2
GRPC_STATUS_UNIMPLEMENTED = 12

_pack_header = struct.Struct(">IBBI")  # we pack len into top 3 bytes manually


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    # 9-byte frame header as ONE int → bytes: len(24) type(8) flags(8) id(32)
    return (
        (len(payload) << 48 | ftype << 40 | flags << 32 | stream_id).to_bytes(9, "big")
        + payload
    )


def settings_payload(pairs: dict[int, int]) -> bytes:
    return b"".join(struct.pack(">HI", k, v) for k, v in pairs.items())


class GrpcWireError(Exception):
    """Connection-fatal protocol error."""


class GrpcCallError(Exception):
    """A call failed with a non-OK grpc-status."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(f"grpc-status {status}: {message}")
        self.status = status
        self.message = message


class GrpcStreamRefusedError(ConnectionError):
    """The server's GOAWAY refused this stream (id > last_stream_id): RFC
    7540 §6.8 guarantees it was never processed, so retrying is safe for
    ANY method — including non-idempotent ones."""


# ---------------------------------------------------------------------------
# Shared connection machinery (frame parse + flow control)
# ---------------------------------------------------------------------------

class _Conn(WriteCoalescer, asyncio.Protocol):
    """Common HTTP/2 connection state for both server and client roles."""

    is_server = False

    def __init__(self) -> None:
        self.transport: asyncio.Transport | None = None
        self._buf = bytearray()
        self._pos = 0
        self._preface_left = len(PREFACE) if self.is_server else 0
        self.decoder = hpack.Decoder()
        # send-side flow control (peer-controlled)
        self.out_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self._stream_out: dict[int, int] = {}
        self._send_queue: list[tuple[int, bytes, int]] = []  # (stream, data, flags)
        # receive-side: replenish the connection window as we consume
        self._recv_credit = 0
        # continuation state: (stream_id, flags, blocks)
        self._headers_in_flight: tuple[int, int, list[bytes]] | None = None
        # streaming producers parked on flow control (drain_sends)
        self._send_waiters: list[asyncio.Future] = []
        self._loop = asyncio.get_event_loop()
        # write coalescing (wire/iobuf.py): frames queue and flush once per
        # loop iteration — one writev carries many streams' frames
        self._init_coalescer(self._loop)
        self.closed = self._loop.create_future()

    # -- transport events ---------------------------------------------------

    def connection_made(self, transport: asyncio.BaseTransport) -> None:
        self.transport = transport  # type: ignore[assignment]
        transport.set_write_buffer_limits(high=4 * 1024 * 1024)  # type: ignore[attr-defined]
        # asyncio sets TCP_NODELAY only on sockets IT creates; connections
        # accepted through our hand-made dual-stack listener socket keep
        # Nagle on, and the small HEADERS/DATA writes then stall a flat
        # ~44ms per RPC against delayed ACKs
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as _socket

            try:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            except OSError:
                pass  # non-TCP transport (unix sockets, tests)
        if not self.is_server:
            self.transport.write(PREFACE)
        self.transport.write(
            frame(SETTINGS, 0, 0, settings_payload({
                SETTINGS_HEADER_TABLE_SIZE: 4096,
                SETTINGS_INITIAL_WINDOW_SIZE: BIG_WINDOW,
                SETTINGS_MAX_FRAME_SIZE: DEFAULT_MAX_FRAME,
            }))
            + frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", BIG_WINDOW - DEFAULT_WINDOW))
        )

    def connection_lost(self, exc: Exception | None) -> None:
        self.drop_writes()
        if not self.closed.done():
            self.closed.set_result(exc)
        # parked streaming producers must not wait on a dead connection
        waiters, self._send_waiters = self._send_waiters, []
        err = ConnectionError(f"h2 connection lost: {exc}")
        for fut, _sid in waiters:
            if not fut.done():
                fut.set_exception(err)
        self._on_closed(exc)

    def _on_closed(self, exc: Exception | None) -> None:  # overridden
        pass

    def data_received(self, data: bytes) -> None:
        buf = self._buf
        buf += data
        pos = self._pos
        try:
            if self._preface_left:
                take = min(self._preface_left, len(buf) - pos)
                start = len(PREFACE) - self._preface_left
                if bytes(buf[pos : pos + take]) != PREFACE[start : start + take]:
                    raise GrpcWireError("bad connection preface")
                self._preface_left -= take
                pos += take
            while len(buf) - pos >= 9:
                length = (buf[pos] << 16) | (buf[pos + 1] << 8) | buf[pos + 2]
                if len(buf) - pos < 9 + length:
                    break
                ftype = buf[pos + 3]
                flags = buf[pos + 4]
                stream_id = int.from_bytes(buf[pos + 5 : pos + 9], "big") & 0x7FFFFFFF
                payload = bytes(buf[pos + 9 : pos + 9 + length])
                pos += 9 + length
                self._dispatch(ftype, flags, stream_id, payload)
        except (GrpcWireError, hpack.HpackError, struct.error, IndexError, ValueError) as e:
            # malformed frames (short WINDOW_UPDATE, bad padding, invalid
            # huffman, ...) are peer protocol errors, not our crashes: a
            # GOAWAY + close, never an unhandled exception on the transport
            log.warning("h2 protocol error: %s", e)
            self._pos = pos
            if self.transport is not None:
                self.queue_write(frame(GOAWAY, 0, 0, struct.pack(">II", 0, 1)))
                self.flush_now()
                self.transport.close()
            return
        # compact the buffer once consumed past 64KB to bound memory
        if pos > 65536:
            del buf[:pos]
            pos = 0
        self._pos = pos

    # -- frame dispatch -----------------------------------------------------

    def _dispatch(self, ftype: int, flags: int, stream_id: int, payload: bytes) -> None:
        if self._headers_in_flight is not None and ftype != CONTINUATION:
            raise GrpcWireError("expected CONTINUATION")
        if ftype == DATA:
            self._credit_recv(len(payload))
            if flags & PADDED:
                pad = payload[0]
                payload = payload[1 : len(payload) - pad]
            self._on_data(stream_id, payload, bool(flags & END_STREAM))
        elif ftype == HEADERS:
            block = payload
            if flags & PADDED:
                pad = block[0]
                block = block[1 : len(block) - pad]
            if flags & PRIORITY_FLAG:
                block = block[5:]
            if flags & END_HEADERS:
                self._headers_done(stream_id, flags, [block])
            else:
                self._headers_in_flight = (stream_id, flags, [block])
        elif ftype == CONTINUATION:
            if self._headers_in_flight is None:
                raise GrpcWireError("unexpected CONTINUATION")
            sid, hflags, blocks = self._headers_in_flight
            if sid != stream_id:
                raise GrpcWireError("CONTINUATION on wrong stream")
            blocks.append(payload)
            if flags & END_HEADERS:
                self._headers_in_flight = None
                self._headers_done(sid, hflags, blocks)
        elif ftype == SETTINGS:
            if flags & ACK:
                return
            for off in range(0, len(payload) - 5, 6):
                key, value = struct.unpack_from(">HI", payload, off)
                if key == SETTINGS_INITIAL_WINDOW_SIZE:
                    delta = value - self.peer_initial_window
                    self.peer_initial_window = value
                    for sid in self._stream_out:
                        self._stream_out[sid] += delta
                elif key == SETTINGS_MAX_FRAME_SIZE:
                    self.peer_max_frame = value
                # SETTINGS_HEADER_TABLE_SIZE constrains our ENCODER (RFC
                # 7541 §4.2), which is stateless (never uses the dynamic
                # table) and therefore always compliant; our DECODER's limit
                # is the 4096 we advertised, not the peer's value
            self.queue_write(frame(SETTINGS, ACK, 0))
            self._pump_sends()
        elif ftype == WINDOW_UPDATE:
            (incr,) = struct.unpack(">I", payload)
            incr &= 0x7FFFFFFF
            if stream_id == 0:
                self.out_window += incr
            elif stream_id in self._stream_out:
                self._stream_out[stream_id] += incr
            elif self._stream_open(stream_id):
                # credit granted before we pumped any DATA for the stream
                # (e.g. the peer enlarges the window while the handler is
                # still computing) — must not be dropped, or a big response
                # can stall on flow control forever
                self._stream_out[stream_id] = self.peer_initial_window + incr
            # else: a completed stream (state dropped by forget_stream) —
            # re-creating the entry would leak it
            self._pump_sends()
        elif ftype == PING:
            if not flags & ACK:
                self.queue_write(frame(PING, ACK, 0, payload))
        elif ftype == RST_STREAM:
            self._on_rst(stream_id, struct.unpack(">I", payload)[0])
        elif ftype == GOAWAY:
            self._on_goaway(payload)
        elif ftype == PUSH_PROMISE:
            raise GrpcWireError("PUSH_PROMISE not supported")
        # PRIORITY and unknown frame types: ignored (per spec)

    def _headers_done(self, stream_id: int, flags: int, blocks: list[bytes]) -> None:
        # memoized: repeat blocks (constant templates both directions) skip
        # the full HPACK decode.  The list is shared — never mutated.
        headers = self.decoder.decode_cached(
            blocks[0] if len(blocks) == 1 else b"".join(blocks)
        )
        self._on_headers(stream_id, headers, bool(flags & END_STREAM))

    # -- receive flow control ----------------------------------------------

    def _credit_recv(self, n: int) -> None:
        """Replenish the connection+stream windows we advertised.  Batched:
        one WINDOW_UPDATE per ~1MB consumed, not per frame."""
        self._recv_credit += n
        if self._recv_credit >= 1024 * 1024:
            self.queue_write(
                frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", self._recv_credit))
            )
            self._recv_credit = 0

    def _stream_recv_credit(self, stream_id: int, n: int) -> None:
        # per-stream windows: our INITIAL_WINDOW_SIZE is BIG_WINDOW; unary
        # messages larger than that need explicit stream credit
        if n > 0:
            self.queue_write(
                frame(WINDOW_UPDATE, 0, stream_id, struct.pack(">I", n))
            )

    # -- send path with flow control ---------------------------------------

    def send_data(self, stream_id: int, data: bytes, end_stream: bool) -> None:
        """DATA split on peer max-frame-size, honoring both windows; excess
        queues until WINDOW_UPDATE."""
        self._stream_out.setdefault(stream_id, self.peer_initial_window)
        self._send_queue.append((stream_id, data, END_STREAM if end_stream else 0))
        self._pump_sends()

    def send_raw_after_data(self, stream_id: int, raw: bytes) -> None:
        """Write ``raw`` (e.g. a trailers HEADERS frame) without overtaking
        any DATA still queued for the stream on flow control."""
        self._send_queue.append((stream_id, raw, _RAW_FRAME))
        self._pump_sends()

    def _pump_sends(self) -> None:
        if not self._send_queue or self.transport is None:
            return
        out = []
        queue = self._send_queue
        self._send_queue = []
        blocked: set[int] = set()  # streams with requeued data this pump
        finished: set[int] = set()  # streams whose final frame went out
        for stream_id, data, flags in queue:
            if stream_id in blocked:
                self._send_queue.append((stream_id, data, flags))
                continue
            if flags == _RAW_FRAME:
                # raw frames are only used for trailers — end of stream
                out.append(data)
                finished.add(stream_id)
                continue
            sent = 0
            swin = self._stream_out.get(stream_id, self.peer_initial_window)
            while sent < len(data) or (flags and sent == len(data) == 0):
                budget = min(self.out_window, swin, self.peer_max_frame)
                chunk = data[sent : sent + budget] if budget > 0 else b""
                if len(data) > 0 and not chunk:
                    break  # window exhausted; requeue remainder
                last = sent + len(chunk) >= len(data)
                out.append(
                    frame(DATA, flags if last else 0, stream_id, chunk)
                )
                sent += len(chunk)
                self.out_window -= len(chunk)
                swin -= len(chunk)
                if len(data) == 0:
                    break
            self._stream_out[stream_id] = swin
            if sent < len(data):
                blocked.add(stream_id)
                self._send_queue.append((stream_id, data[sent:], flags))
            elif flags & END_STREAM:
                finished.add(stream_id)
        still_queued = {sid for sid, _, _ in self._send_queue}
        for sid in finished - still_queued:
            self._stream_out.pop(sid, None)
        if out:
            self.queue_write(b"".join(out) if len(out) > 1 else out[0])
        self._wake_send_waiters()

    def forget_stream(self, stream_id: int) -> None:
        """Drop per-stream send-window state once a stream completes —
        stream IDs are never reused, so entries left behind are a leak of
        ~one dict slot per RPC on long-lived connections.  A remainder
        parked in the send queue keeps the entry until it drains."""
        if any(sid == stream_id for sid, _, _ in self._send_queue):
            return
        self._stream_out.pop(stream_id, None)

    # -- send backpressure (streaming responses) ----------------------------

    _SEND_HIGH_WATER = 256 * 1024

    def _queued_send_bytes(self, stream_id: int) -> int:
        # PER-STREAM accounting: one stream parked on its peer window must
        # not head-of-line-block other producers multiplexed here
        return sum(
            len(d)
            for sid, d, f in self._send_queue
            if sid == stream_id and f != _RAW_FRAME
        )

    def _wake_send_waiters(self) -> None:
        if not self._send_waiters:
            return
        still_blocked = []
        for fut, sid in self._send_waiters:
            if fut.done():
                continue
            if self._queued_send_bytes(sid) <= self._SEND_HIGH_WATER:
                fut.set_result(None)
            else:
                still_blocked.append((fut, sid))
        self._send_waiters = still_blocked

    async def drain_sends(self, stream_id: int) -> None:
        """Park until THIS stream's flow-control send queue is below the
        high-water mark — a streaming producer must not buffer an unbounded
        response for a slow peer."""
        while True:
            if self.transport is None or self.transport.is_closing():
                raise ConnectionError("h2 connection closed")
            if self._queued_send_bytes(stream_id) <= self._SEND_HIGH_WATER:
                return
            fut = asyncio.get_running_loop().create_future()
            self._send_waiters.append((fut, stream_id))
            await fut

    # -- role hooks ---------------------------------------------------------

    def _on_headers(self, stream_id: int, headers, end: bool) -> None:
        raise NotImplementedError

    def _on_data(self, stream_id: int, data: bytes, end: bool) -> None:
        raise NotImplementedError

    def _stream_open(self, stream_id: int) -> bool:
        """Is this stream known-in-progress (request received / call
        pending)?  Governs whether early WINDOW_UPDATEs create send-window
        state."""
        return False

    def _on_rst(self, stream_id: int, code: int) -> None:
        pass

    def _on_goaway(self, payload: bytes) -> None:
        if self.transport is not None:
            self.transport.close()


def grpc_frame(payload: bytes) -> bytes:
    """gRPC message framing: 1-byte compressed flag + u32 length."""
    return b"\x00" + len(payload).to_bytes(4, "big") + payload


def parse_grpc_frames(buf: bytes) -> list[bytes]:
    out = []
    pos = 0
    while pos + 5 <= len(buf):
        if buf[pos] != 0:
            raise GrpcCallError(GRPC_STATUS_UNKNOWN, "compressed messages unsupported")
        n = int.from_bytes(buf[pos + 1 : pos + 5], "big")
        if pos + 5 + n > len(buf):
            raise GrpcCallError(GRPC_STATUS_UNKNOWN, "truncated gRPC frame")
        out.append(buf[pos + 5 : pos + 5 + n])
        pos += 5 + n
    if pos != len(buf):
        raise GrpcCallError(GRPC_STATUS_UNKNOWN, "trailing bytes after gRPC frame")
    return out


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

Handler = Callable[[bytes], Awaitable[bytes]]

# constant response header/trailer templates (stateless HPACK encode)
_RESPONSE_HEADERS = hpack.encode_headers(
    [(b":status", b"200"), (b"content-type", b"application/grpc")]
)
_TRAILERS_OK = hpack.encode_headers([(b"grpc-status", b"0")])


class _ServerConn(_Conn):
    is_server = True

    def __init__(
        self,
        handlers: dict[bytes, Handler],
        conns: "set[_ServerConn] | None" = None,
        on_request_headers: "Callable[[list], None] | None" = None,
        stream_handlers: "dict[bytes, Any] | None" = None,
        relay_handlers: "dict[bytes, Any] | None" = None,
    ):
        super().__init__()
        self.handlers = handlers
        # server-streaming RPCs: async fn(bytes) -> AsyncIterator[bytes]
        self.stream_handlers = stream_handlers or {}
        # inline relays: sync fn(conn, stream_id, headers, framed_body) that
        # completes the stream later via conn.write_unary_response — no
        # task, no future, no gRPC re-framing (the proxy hot path)
        self.relay_handlers = relay_handlers or {}
        # stream_id -> zero-arg cancel fn, set by relay handlers so a client
        # RST propagates upstream instead of leaving the backend computing
        self.relay_cancels: dict[int, Any] = {}
        # invoked with the request header list inside the context the
        # handler task will inherit — lets the application seed per-request
        # contextvars (e.g. traceparent) without wire/ knowing about them
        self._on_request_headers = on_request_headers
        # stream -> [path, data buffer]
        self._streams: dict[int, list[Any]] = {}
        self._tasks: set[asyncio.Task] = set()
        self._stream_tasks: dict[int, asyncio.Task] = {}
        self.max_stream = 0  # highest accepted stream id (GOAWAY payload)
        self._conns = conns
        if conns is not None:
            conns.add(self)

    def _on_closed(self, exc: Exception | None) -> None:
        for t in self._tasks:
            t.cancel()
        # a dead downstream connection must cancel in-flight inline relays
        # upstream too (an RST does this per-stream; full connection loss
        # would otherwise leave the engine computing to the channel reaper)
        cancels, self.relay_cancels = self.relay_cancels, {}
        for cancel in cancels.values():
            try:
                cancel()
            except Exception:
                log.exception("relay cancel failed on connection loss")
        self._streams.clear()
        self._stream_tasks.clear()
        if self._conns is not None:
            self._conns.discard(self)

    def _on_headers(self, stream_id: int, headers, end: bool) -> None:
        path = b""
        for name, value in headers:
            if name == b":path":
                path = value
                break
        self._streams[stream_id] = [path, bytearray(), headers]
        self.max_stream = max(self.max_stream, stream_id)
        if end:
            self._finish_request(stream_id)

    def _on_data(self, stream_id: int, data: bytes, end: bool) -> None:
        st = self._streams.get(stream_id)
        if st is None:
            return
        st[1] += data
        if len(st[1]) > BIG_WINDOW // 2:
            self._stream_recv_credit(stream_id, len(data))
        if end:
            self._finish_request(stream_id)

    def _stream_open(self, stream_id: int) -> bool:
        return (
            stream_id in self._streams
            or stream_id in self._stream_tasks
            or stream_id in self.relay_cancels
        )

    def _on_rst(self, stream_id: int, code: int) -> None:
        self._streams.pop(stream_id, None)
        cancel = self.relay_cancels.pop(stream_id, None)
        if cancel is not None:
            try:
                cancel()
            except Exception:
                log.exception("relay cancel failed")
        task = self._stream_tasks.pop(stream_id, None)
        if task is not None:
            # client cancelled (e.g. its deadline passed): stop the handler
            # instead of computing a response nobody will read
            task.cancel()
        # purge DATA parked on flow control: the client dropped its stream
        # state, so no WINDOW_UPDATE will ever release these bytes — left
        # queued they'd keep drain_sends producers over the high-water mark
        # forever
        self._send_queue = [e for e in self._send_queue if e[0] != stream_id]
        # drop any send-window state created by an early WINDOW_UPDATE —
        # a cancelled stream never reaches the success path that pops it
        self.forget_stream(stream_id)
        self._wake_send_waiters()

    def _finish_request(self, stream_id: int) -> None:
        path, body, headers = self._streams.pop(stream_id)
        relay = self.relay_handlers.get(path)
        if relay is not None:
            # proxy hot path: runs inline in this callback — auth, upstream
            # forward and the response write all happen without creating a
            # task or parsing the gRPC message framing
            try:
                relay(self, stream_id, headers, bytes(body))
            except Exception as e:
                log.exception("relay handler failed")
                self._send_error(
                    stream_id, GRPC_STATUS_UNKNOWN, f"{type(e).__name__}: {e}"
                )
            return
        stream_handler = self.stream_handlers.get(path)
        handler = self.handlers.get(path)
        if handler is None and stream_handler is None:
            self._send_error(stream_id, GRPC_STATUS_UNIMPLEMENTED, f"unknown method {path.decode()}")
            return
        try:
            messages = parse_grpc_frames(bytes(body))
            if len(messages) != 1:
                raise GrpcCallError(GRPC_STATUS_UNKNOWN, "expected exactly one message")
        except GrpcCallError as e:
            self._send_error(stream_id, e.status, e.message)
            return
        if stream_handler is not None:
            coro = self._run_stream(stream_id, stream_handler, messages[0])
        else:
            coro = self._run(stream_id, handler, messages[0])
        if self._on_request_headers is not None:
            # run the hook + handler in a copied context so per-request
            # contextvars it sets don't leak across requests.  A hook
            # failure (e.g. non-UTF-8 metadata) fails THIS stream only —
            # letting it escape would GOAWAY the whole connection and kill
            # every other caller multiplexed on it.
            ctx = contextvars.copy_context()
            try:
                ctx.run(self._on_request_headers, headers)
            except Exception as e:
                log.warning("request-headers hook failed: %s", e)
                coro.close()
                self._send_error(
                    stream_id, GRPC_STATUS_UNKNOWN, f"bad request metadata: {e}"
                )
                return
            task = asyncio.get_running_loop().create_task(coro, context=ctx)
        else:
            task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        self._stream_tasks[stream_id] = task

        def _done(t, sid=stream_id):
            self._tasks.discard(t)
            self._stream_tasks.pop(sid, None)

        task.add_done_callback(_done)

    async def _run(self, stream_id: int, handler: Handler, payload: bytes) -> None:
        try:
            response = await handler(payload)
        except asyncio.CancelledError:
            return  # stream was reset; nobody is listening
        except GrpcCallError as e:
            self._send_error(stream_id, e.status, e.message)
            return
        except Exception as e:
            log.exception("grpc handler failed")
            self._send_error(stream_id, GRPC_STATUS_UNKNOWN, f"{type(e).__name__}: {e}")
            return
        self.write_unary_response(stream_id, grpc_frame(response))

    def write_unary_response(self, stream_id: int, body: bytes) -> None:
        """Complete a unary stream: response headers + ``body`` (already
        gRPC-framed) + OK trailers.  Hot path is ONE coalesced write."""
        if self.transport is None or self.transport.is_closing():
            return
        trailers = frame(HEADERS, END_HEADERS | END_STREAM, stream_id, _TRAILERS_OK)
        swin = self._stream_out.get(stream_id, self.peer_initial_window)
        if (
            not self._send_queue
            and len(body) <= self.peer_max_frame
            and len(body) <= self.out_window
            and len(body) <= swin
        ):
            # hot path: the whole response (headers + data + trailers) in
            # ONE write — one syscall, one TCP segment group
            self.out_window -= len(body)
            self.queue_write(
                frame(HEADERS, END_HEADERS, stream_id, _RESPONSE_HEADERS)
                + frame(DATA, 0, stream_id, body)
                + trailers
            )
            self._stream_out.pop(stream_id, None)
            return
        # windowed path: trailers ride the send queue so they can never
        # overtake DATA parked on flow control
        self.queue_write(frame(HEADERS, END_HEADERS, stream_id, _RESPONSE_HEADERS))
        self.send_data(stream_id, body, end_stream=False)
        self.send_raw_after_data(stream_id, trailers)
        self.forget_stream(stream_id)

    async def _run_stream(self, stream_id: int, handler, payload: bytes) -> None:
        """Server-streaming RPC: the handler is an async generator of
        response message bytes; each message goes out as its own gRPC frame
        the moment it is yielded (flow-control backpressure via
        drain_sends), trailers close the stream."""
        wrote_headers = False
        try:
            async for msg in handler(payload):
                if self.transport is None or self.transport.is_closing():
                    return
                if not wrote_headers:
                    self.queue_write(
                        frame(HEADERS, END_HEADERS, stream_id, _RESPONSE_HEADERS)
                    )
                    wrote_headers = True
                self.send_data(stream_id, grpc_frame(msg), end_stream=False)
                # a slow consumer parks the PRODUCER here, not server memory
                await self.drain_sends(stream_id)
        except asyncio.CancelledError:
            return  # stream was reset; nobody is listening
        except GrpcCallError as e:
            self._stream_failure(stream_id, wrote_headers, e.status, e.message)
            return
        except ConnectionError:
            return
        except Exception as e:
            log.exception("grpc stream handler failed")
            self._stream_failure(
                stream_id, wrote_headers, GRPC_STATUS_UNKNOWN,
                f"{type(e).__name__}: {e}",
            )
            return
        if self.transport is None or self.transport.is_closing():
            return
        if not wrote_headers:  # empty stream: headers still owed
            self.queue_write(
                frame(HEADERS, END_HEADERS, stream_id, _RESPONSE_HEADERS)
            )
        self.send_raw_after_data(
            stream_id, frame(HEADERS, END_HEADERS | END_STREAM, stream_id, _TRAILERS_OK)
        )
        self.forget_stream(stream_id)

    def _stream_failure(
        self, stream_id: int, wrote_headers: bool, status: int, message: str
    ) -> None:
        """Mid-stream errors become trailers (response HEADERS already went
        out, so _send_error's :status block would be malformed)."""
        if not wrote_headers:
            self._send_error(stream_id, status, message)
            return
        if self.transport is None or self.transport.is_closing():
            return
        trailers = hpack.encode_headers(
            [
                (b"grpc-status", str(status).encode()),
                (b"grpc-message", message.encode("utf-8", "replace")),
            ]
        )
        self.send_raw_after_data(
            stream_id, frame(HEADERS, END_HEADERS | END_STREAM, stream_id, trailers)
        )
        self.forget_stream(stream_id)

    def _send_error(self, stream_id: int, status: int, message: str) -> None:
        # errored streams bypass the success path's forget_stream — drop the
        # send-window slot here or every failed RPC leaks one dict entry
        self.forget_stream(stream_id)
        if self.transport is None or self.transport.is_closing():
            return
        trailers = hpack.encode_headers(
            [
                (b":status", b"200"),
                (b"content-type", b"application/grpc"),
                (b"grpc-status", str(status).encode()),
                (b"grpc-message", message.encode("utf-8", "replace")),
            ]
        )
        self.queue_write(frame(HEADERS, END_HEADERS | END_STREAM, stream_id, trailers))


def _dual_stack_socket(port: int, reuse_port: bool):
    import socket

    # proto must be IPPROTO_TCP (not 0): asyncio's transport layer only
    # applies TCP_NODELAY when sock.proto == IPPROTO_TCP, and sockets
    # accepted from this listener inherit its proto — with Nagle left on,
    # the response's small frames stall ~44ms against delayed ACKs
    try:
        sock = socket.socket(
            socket.AF_INET6, socket.SOCK_STREAM, socket.IPPROTO_TCP
        )
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
        addr = ("::", port)
    except OSError:  # IPv6-less host
        sock = socket.socket(
            socket.AF_INET, socket.SOCK_STREAM, socket.IPPROTO_TCP
        )
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


class FastGrpcServer:
    """gRPC server on asyncio.  ``handlers`` maps full method paths
    (``/seldon.protos.Seldon/Predict``) to ``async fn(bytes) -> bytes``;
    ``stream_handlers`` maps paths to server-streaming handlers
    (``async fn(bytes) -> AsyncIterator[bytes]``)."""

    def __init__(
        self,
        handlers: dict[str, Handler],
        on_request_headers: "Callable[[list], None] | None" = None,
        stream_handlers: "dict[str, Any] | None" = None,
        relay_handlers: "dict[str, Any] | None" = None,
    ):
        self.handlers = {k.encode(): v for k, v in handlers.items()}
        self.stream_handlers = {
            k.encode(): v for k, v in (stream_handlers or {}).items()
        }
        self.relay_handlers = {
            k.encode(): v for k, v in (relay_handlers or {}).items()
        }
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_ServerConn] = set()
        self._on_request_headers = on_request_headers
        self.bound_port = 0

    def add_handler(self, path: str, fn: Handler) -> None:
        self.handlers[path.encode()] = fn

    def add_stream_handler(self, path: str, fn) -> None:
        self.stream_handlers[path.encode()] = fn

    def add_relay_handler(self, path: str, fn) -> None:
        """Register an inline proxy handler: sync ``fn(conn, stream_id,
        headers, framed_body)`` that later calls
        ``conn.write_unary_response(stream_id, framed_bytes)`` (or
        ``conn._send_error``)."""
        self.relay_handlers[path.encode()] = fn

    async def start(
        self, port: int, host: str | None = None, reuse_port: bool = False
    ) -> int:
        import socket

        loop = asyncio.get_running_loop()
        try:
            factory = lambda: _ServerConn(  # noqa: E731
                self.handlers, self._conns, self._on_request_headers,
                self.stream_handlers, self.relay_handlers,
            )
            if host is None:
                # ONE dual-stack socket ([::] with V6ONLY off), like the
                # grpcio server this replaces: an IPv6-only cluster must not
                # get connection-refused from a ready pod.  (create_server
                # with host=None would make one socket PER family — and with
                # port=0 each would land on a DIFFERENT ephemeral port.)
                sock = _dual_stack_socket(port, reuse_port)
                self._server = await loop.create_server(factory, sock=sock)
            else:
                self._server = await loop.create_server(
                    factory, host, port, reuse_port=reuse_port or None
                )
        except OSError as e:
            # strict-boot contract: a gRPC-only client must never see silent
            # connection refusals from a pod that reports ready
            raise RuntimeError(f"could not bind gRPC port {port}: {e}") from e
        self.bound_port = self._server.sockets[0].getsockname()[1]
        return self.bound_port

    async def stop(self, grace: float | None = None) -> None:
        """grpc.aio-like stop: close the listener, give in-flight handlers
        ``grace`` seconds to finish (GOAWAY tells clients no new streams),
        then close every established connection."""
        server, self._server = self._server, None
        if server is not None:
            server.close()
        conns = list(self._conns)
        for conn in conns:
            if conn.transport is not None and not conn.transport.is_closing():
                # last_stream_id = highest accepted: tells clients their
                # in-flight streams WILL be answered (0 would mean "nothing
                # was processed" and make them abandon in-flight RPCs)
                conn.queue_write(
                    frame(GOAWAY, 0, 0, struct.pack(">II", conn.max_stream, 0))
                )
                conn.flush_now()
        if grace:
            deadline = asyncio.get_running_loop().time() + grace
            while any(c._tasks for c in conns):
                if asyncio.get_running_loop().time() >= deadline:
                    break
                await asyncio.sleep(0.05)
        for conn in conns:
            if conn.transport is not None:
                conn.transport.close()
        self._conns.clear()
        if server is not None:
            # 3.12+: wait_closed also waits for connection handlers, so it
            # must come AFTER the transports are closed or it never returns
            await server.wait_closed()

    async def wait_for_termination(self) -> None:
        if self._server is not None:
            await self._server.wait_closed()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class _StreamCall:
    """Client-side state for one server-streaming RPC: complete messages
    land on ``queue`` as they arrive; the terminal item is
    ``("end", status, message)`` or ``("err", exc)``."""

    __slots__ = ("queue", "buf", "headers", "dead")

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.buf = bytearray()
        self.headers: list | None = None
        self.dead = False  # framing error seen: drop further input

    def feed(self, data: bytes) -> None:
        """Incremental gRPC length-prefix framing: push every complete
        message, keep the remainder buffered."""
        if self.dead:
            return
        self.buf += data
        while True:
            if len(self.buf) < 5:
                return
            if self.buf[0] != 0:
                self.dead = True
                self.buf.clear()
                self.queue.put_nowait(
                    ("err", GrpcCallError(GRPC_STATUS_UNKNOWN, "compressed messages unsupported"))
                )
                return
            (ln,) = struct.unpack_from(">I", self.buf, 1)
            if len(self.buf) < 5 + ln:
                return
            self.queue.put_nowait(("msg", bytes(self.buf[5 : 5 + ln])))
            del self.buf[: 5 + ln]

    def finish(self) -> None:
        status = GRPC_STATUS_OK
        message = ""
        for name, value in self.headers or []:
            if name == b"grpc-status":
                status = int(value)
            elif name == b"grpc-message":
                message = value.decode("utf-8", "replace")
        self.queue.put_nowait(("end", status, message))


class _ClientConn(_Conn):
    is_server = False

    def __init__(self, authority: str):
        super().__init__()
        self.authority = authority
        self._next_stream = 1
        self.drain_when_idle = False  # set when replaced due to exhaustion
        # stream -> [sink, headers, bytearray data, is_cb]; sink is a Future
        # (is_cb False) or a callback fn(status, message, framed_body)
        # (is_cb True — the relay path: no future, no task, raw bytes out)
        self._calls: dict[int, list[Any]] = {}
        self._stream_calls: dict[int, _StreamCall] = {}
        self._path_templates: dict[bytes, bytes] = {}
        # per-(path, metadata) header-block cache: steady-state clients send
        # identical metadata every call (e.g. a bearer token) — cap guards
        # against per-request-unique metadata (traceparent) blowing it up
        self._header_cache: dict[tuple, bytes] = {}

    def _on_closed(self, exc: Exception | None) -> None:
        err = ConnectionError(f"h2 connection lost: {exc}")
        calls, self._calls = self._calls, {}
        for sink, _, _, is_cb in calls.values():
            if is_cb:
                sink(14, f"engine unreachable: connection lost: {exc}", b"")
            elif not sink.done():
                sink.set_exception(err)
        for sc in self._stream_calls.values():
            sc.queue.put_nowait(("err", err))
        self._stream_calls.clear()

    def _stream_open(self, stream_id: int) -> bool:
        return stream_id in self._calls or stream_id in self._stream_calls

    def _on_goaway(self, payload: bytes) -> None:
        # graceful drain, not a hard close: a stopping server announces "no
        # new streams" — accepted in-flight calls finish (the point of its
        # grace period), but streams ABOVE last_stream_id were refused and
        # will never be answered: fail them now as retryable so the hop
        # retry layer can resend instead of waiting out the call timeout
        # (RFC 7540 §6.8)
        last_stream = (
            struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            if len(payload) >= 4
            else 0
        )
        refused = [sid for sid in self._calls if sid > last_stream]
        err = GrpcStreamRefusedError(
            f"stream refused by GOAWAY (last_stream_id={last_stream})"
        )
        for sid in refused:
            sink, _, _, is_cb = self._calls.pop(sid)
            if is_cb:
                sink(14, "stream refused by GOAWAY", b"")
            elif not sink.done():
                sink.set_exception(err)
        for sid in [s for s in self._stream_calls if s > last_stream]:
            self._stream_calls.pop(sid).queue.put_nowait(("err", err))
        self.drain_when_idle = True
        self.maybe_drain_close()

    def _template(self, path: bytes, metadata: tuple = ()) -> bytes:
        # The stateless HPACK encode lets the cached base block and the
        # per-call metadata block simply concatenate.  Repeat metadata
        # (bearer tokens, fixed keys) hits the bounded (path, metadata)
        # cache; per-request-unique metadata (traceparent span ids) would
        # never hit, so the cache is capped rather than keyed on path only.
        if metadata:
            key = (path, metadata)
            t = self._header_cache.get(key)
            if t is not None:
                return t
        t = self._path_templates.get(path)
        if t is None:
            t = hpack.encode_headers(
                [
                    (b":method", b"POST"),
                    (b":scheme", b"http"),
                    (b":path", path),
                    (b":authority", self.authority.encode()),
                    (b"content-type", b"application/grpc"),
                    (b"te", b"trailers"),
                ]
            )
            self._path_templates[path] = t
        if metadata:
            t = t + hpack.encode_headers(
                [
                    (
                        k.encode() if isinstance(k, str) else k,
                        v.encode() if isinstance(v, str) else v,
                    )
                    for k, v in metadata
                ]
            )
            if len(self._header_cache) >= 64:
                # clear-on-full, not stop-on-full: per-request-unique
                # metadata (traceparent span ids) must not permanently
                # poison the cache against repeat keys (bearer tokens)
                self._header_cache.clear()
            self._header_cache[(path, metadata)] = t
        return t

    @property
    def exhausted(self) -> bool:
        """Stream IDs are 31-bit and never reused: a long-lived connection
        must be cycled before the space runs out (the channel replaces an
        exhausted connection and drains this one)."""
        return self._next_stream >= 1 << 30

    def maybe_drain_close(self) -> None:
        if (
            self.drain_when_idle
            and not self._calls
            and not self._stream_calls
            and self.transport is not None
        ):
            self.queue_write(frame(GOAWAY, 0, 0, struct.pack(">II", 0, 0)))
            self.flush_now()
            self.transport.close()

    def next_stream_id(self) -> int:
        stream_id = self._next_stream
        self._next_stream += 2
        return stream_id

    def _send_request(self, stream_id: int, path: bytes, framed: bytes, metadata: tuple) -> None:
        """HEADERS + framed DATA; hot path is one coalesced write with no
        send-queue machinery when the windows are open (the normal case)."""
        hdr = frame(HEADERS, END_HEADERS, stream_id, self._template(path, metadata))
        n = len(framed)
        if (
            not self._send_queue
            and n <= self.peer_max_frame
            and n <= self.out_window
            and n <= self.peer_initial_window
        ):
            self.out_window -= n
            self.queue_write(hdr + frame(DATA, END_STREAM, stream_id, framed))
        else:
            self.queue_write(hdr)
            self.send_data(stream_id, framed, end_stream=True)

    def call(
        self,
        path: bytes,
        payload: bytes,
        metadata: tuple = (),
        stream_id: int | None = None,
    ) -> asyncio.Future:
        if self.transport is None or self.transport.is_closing():
            raise ConnectionError("h2 connection closed")
        if stream_id is None:
            stream_id = self.next_stream_id()
        fut = asyncio.get_running_loop().create_future()
        self._calls[stream_id] = [fut, None, bytearray(), False]
        self._send_request(stream_id, path, grpc_frame(payload), metadata)
        return fut

    def call_framed(
        self,
        path: bytes,
        framed: bytes,
        cb,
        metadata: tuple = (),
    ) -> int:
        """Relay-path unary call: ``framed`` is an ALREADY-FRAMED gRPC body
        forwarded verbatim; ``cb(status, message, framed_body)`` fires when
        the response completes (framed_body raw, only meaningful on status
        0).  No future, no task — callbacks all the way down."""
        if self.transport is None or self.transport.is_closing():
            raise ConnectionError("h2 connection closed")
        stream_id = self.next_stream_id()
        self._calls[stream_id] = [cb, None, bytearray(), True]
        self._send_request(stream_id, path, framed, metadata)
        return stream_id

    def start_stream(
        self,
        path: bytes,
        payload: bytes,
        metadata: tuple = (),
        stream_id: int | None = None,
    ) -> "_StreamCall":
        """Open a server-streaming RPC; messages arrive on the returned
        call's queue as the server yields them."""
        if self.transport is None or self.transport.is_closing():
            raise ConnectionError("h2 connection closed")
        if stream_id is None:
            stream_id = self.next_stream_id()
        sc = _StreamCall()
        self._stream_calls[stream_id] = sc
        self._send_request(stream_id, path, grpc_frame(payload), metadata)
        return sc

    def cancel_stream(self, stream_id: int) -> None:
        """Local cancellation (timeout): RST_STREAM(CANCEL) + drop state."""
        self._calls.pop(stream_id, None)
        self._stream_calls.pop(stream_id, None)
        self._stream_out.pop(stream_id, None)
        self._send_queue = [e for e in self._send_queue if e[0] != stream_id]
        if self.transport is not None and not self.transport.is_closing():
            self.queue_write(
                frame(RST_STREAM, 0, stream_id, struct.pack(">I", 0x8))  # CANCEL
            )
        self.maybe_drain_close()

    def _on_headers(self, stream_id: int, headers, end: bool) -> None:
        sc = self._stream_calls.get(stream_id)
        if sc is not None:
            sc.headers = (sc.headers or []) + headers
            if end:
                self._stream_calls.pop(stream_id, None)
                sc.finish()
                self.maybe_drain_close()
            return
        call = self._calls.get(stream_id)
        if call is None:
            return
        if call[1] is None:
            call[1] = headers
        else:
            call[1] = call[1] + headers  # trailers appended
        if end:
            self._finish(stream_id)

    def _on_data(self, stream_id: int, data: bytes, end: bool) -> None:
        sc = self._stream_calls.get(stream_id)
        if sc is not None:
            sc.feed(data)
            # per-stream window credit is DEFERRED to call_stream's consumer
            # loop: a slow consumer (e.g. a gateway relaying to a slow
            # client) then exerts real backpressure — the server can run at
            # most our advertised window ahead of consumption instead of
            # buffering the whole stream here.  (The CONNECTION window is
            # credited in _dispatch for every DATA frame; doing it again
            # would ratchet past 2^31-1, RFC 7540 §6.9.1.)
            if end:
                self._stream_calls.pop(stream_id, None)
                sc.finish()
                self.maybe_drain_close()
            return
        call = self._calls.get(stream_id)
        if call is None:
            return
        call[2] += data
        if len(call[2]) > BIG_WINDOW // 2:
            self._stream_recv_credit(stream_id, len(data))
        if end:
            self._finish(stream_id)

    def _on_rst(self, stream_id: int, code: int) -> None:
        self._stream_out.pop(stream_id, None)
        sc = self._stream_calls.pop(stream_id, None)
        if sc is not None:
            sc.queue.put_nowait(
                ("err", GrpcCallError(GRPC_STATUS_UNKNOWN, f"stream reset: h2 code {code}"))
            )
            return
        call = self._calls.pop(stream_id, None)
        if call is None:
            return
        if call[3]:
            call[0](GRPC_STATUS_UNKNOWN, f"stream reset: h2 code {code}", b"")
        elif not call[0].done():
            call[0].set_exception(
                GrpcCallError(GRPC_STATUS_UNKNOWN, f"stream reset: h2 code {code}")
            )

    def _finish(self, stream_id: int) -> None:
        sink, headers, body, is_cb = self._calls.pop(stream_id)
        # drop send-window state a peer WINDOW_UPDATE may have created (a
        # grpcio server credits every DATA frame) — left behind, each call
        # would leak one dict entry
        self._stream_out.pop(stream_id, None)
        self.maybe_drain_close()
        status = GRPC_STATUS_OK
        message = ""
        for name, value in headers or []:
            if name == b"grpc-status":
                status = int(value)
            elif name == b"grpc-message":
                message = value.decode("utf-8", "replace")
        if is_cb:
            # relay path: hand back the RAW framed body — no parse, no copy
            sink(status, message, bytes(body) if status == GRPC_STATUS_OK else b"")
            return
        fut = sink
        if fut.done():
            return
        if status != GRPC_STATUS_OK:
            fut.set_exception(GrpcCallError(status, message))
            return
        try:
            messages = parse_grpc_frames(bytes(body))
            if len(messages) != 1:
                raise GrpcCallError(GRPC_STATUS_UNKNOWN, "expected one response message")
            fut.set_result(messages[0])
        except GrpcCallError as e:
            fut.set_exception(e)


class FastGrpcChannel:
    """Pooled unary client: ``await channel.call("/pkg.Svc/Method", bytes)``.

    One connection by default (HTTP/2 multiplexes); the connection is
    (re)established lazily so the channel survives server restarts.
    """

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self.host = host.strip("[]") or "127.0.0.1"
        self.port = int(port)
        self.authority = target
        self._conn: _ClientConn | None = None
        self._connecting: asyncio.Lock = asyncio.Lock()
        # coarse deadline reaper for call_framed (relay) calls: one 1s timer
        # for the whole channel instead of a TimerHandle per call
        self._reap_entries: list[tuple[float, _ClientConn, int]] = []
        self._reap_handle: asyncio.TimerHandle | None = None

    @staticmethod
    def _usable(conn: _ClientConn | None) -> bool:
        return (
            conn is not None
            and conn.transport is not None
            and not conn.transport.is_closing()
            and not conn.exhausted
            and not conn.drain_when_idle  # server sent GOAWAY: no new streams
        )

    async def _connection(self) -> _ClientConn:
        conn = self._conn
        if self._usable(conn):
            return conn
        async with self._connecting:
            conn = self._conn
            if self._usable(conn):
                return conn
            if conn is not None and conn.exhausted:
                # cycle before the 31-bit stream-ID space runs out; the old
                # connection finishes its in-flight calls then closes itself
                conn.drain_when_idle = True
                conn.maybe_drain_close()
            loop = asyncio.get_running_loop()
            _, conn = await loop.create_connection(
                lambda: _ClientConn(self.authority), self.host, self.port
            )
            self._conn = conn
            return conn

    # -- relay (callback) path ---------------------------------------------

    def try_call_framed(
        self,
        path: bytes,
        framed: bytes,
        cb,
        timeout: float = 30.0,
        metadata: tuple = (),
    ):
        """Synchronous send of an already-framed unary call on the pooled
        connection; returns a zero-arg cancel fn, or ``None`` when no usable
        connection exists (caller falls back to the async path).  ``cb``
        fires exactly once: (status, message, framed_body)."""
        conn = self._conn
        if not self._usable(conn):
            return None
        # single-fire is guaranteed by _calls ownership: every completion
        # path (response, RST, GOAWAY, connection loss, reaper, cancel) pops
        # the entry before acting, so no wrapper is needed
        sid = conn.call_framed(path, framed, cb, metadata)
        loop = conn._loop
        self._reap_entries.append((loop.time() + timeout, conn, sid))
        if self._reap_handle is None:
            self._reap_handle = loop.call_later(1.0, self._reap)

        def cancel():
            if conn._calls.pop(sid, None) is not None:
                conn.cancel_stream(sid)

        return cancel

    def _reap(self) -> None:
        self._reap_handle = None
        now = asyncio.get_event_loop().time()
        live = []
        for deadline, conn, sid in self._reap_entries:
            entry = conn._calls.get(sid)
            if entry is None:
                continue  # completed or cancelled
            if now >= deadline:
                conn._calls.pop(sid, None)
                conn.cancel_stream(sid)
                entry[0](4, "deadline exceeded", b"")  # DEADLINE_EXCEEDED
            else:
                live.append((deadline, conn, sid))
        self._reap_entries = live
        if live:
            self._reap_handle = asyncio.get_event_loop().call_later(1.0, self._reap)

    async def call_framed_connecting(
        self,
        path: bytes,
        framed: bytes,
        cb,
        timeout: float = 30.0,
        metadata: tuple = (),
        on_cancelable=None,
    ) -> None:
        """Cold path for the relay: establish the connection, then send.
        Connection failure surfaces through ``cb`` as UNAVAILABLE.  Once the
        call is actually issued, ``on_cancelable(cancel_fn)`` fires so the
        caller can swap its provisional cancel (task.cancel) for the real
        stream cancel."""
        try:
            await self._connection()
        except OSError as e:
            cb(14, f"engine unreachable: {e}", b"")
            return
        cancel = self.try_call_framed(path, framed, cb, timeout, metadata)
        if cancel is None:
            cb(14, "engine unreachable: connection closed during connect", b"")
        elif on_cancelable is not None:
            on_cancelable(cancel)

    async def call(
        self,
        path: str | bytes,
        payload: bytes,
        timeout: float = 30.0,
        metadata: tuple = (),
    ) -> bytes:
        conn = await self._connection()
        path_b = path if isinstance(path, bytes) else path.encode()
        stream_id = conn.next_stream_id()
        fut = conn.call(path_b, payload, metadata, stream_id)
        try:
            return await asyncio.wait_for(fut, timeout)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            # tell the server to stop working on it and drop our stream
            # state — silently abandoning the stream leaks the _calls entry
            # and leaves the handler running with no deadline
            conn.cancel_stream(stream_id)
            raise

    async def call_stream(
        self,
        path: str | bytes,
        payload: bytes,
        timeout: float = 300.0,
        metadata: tuple = (),
    ):
        """Server-streaming RPC: async-iterates response message bytes as
        the server yields them.  ``timeout`` bounds the WHOLE stream; a
        non-OK grpc-status raises GrpcCallError after the received
        messages."""
        conn = await self._connection()
        path_b = path if isinstance(path, bytes) else path.encode()
        stream_id = conn.next_stream_id()
        sc = conn.start_stream(path_b, payload, metadata, stream_id)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        try:
            while True:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise asyncio.TimeoutError()
                item = await asyncio.wait_for(sc.queue.get(), remaining)
                kind = item[0]
                if kind == "msg":
                    # credit the stream window only as messages are
                    # CONSUMED (5 = gRPC frame prefix); withheld credit is
                    # the backpressure that stops a fast server overrunning
                    # a slow consumer
                    if conn.transport is not None and not conn.transport.is_closing():
                        conn._stream_recv_credit(stream_id, len(item[1]) + 5)
                    yield item[1]
                elif kind == "end":
                    _, status, message = item
                    if status != GRPC_STATUS_OK:
                        raise GrpcCallError(status, message)
                    return
                else:  # err
                    raise item[1]
        except BaseException:
            # ANY abnormal exit (timeout, cancellation, framing error, a
            # server-reported status): tell the server to stop and drop our
            # stream state — the server may still be producing
            conn.cancel_stream(stream_id)
            raise

    async def close(self) -> None:
        if self._reap_handle is not None:
            self._reap_handle.cancel()
            self._reap_handle = None
        self._reap_entries = []
        conn, self._conn = self._conn, None
        if conn is not None and conn.transport is not None:
            conn.queue_write(frame(GOAWAY, 0, 0, struct.pack(">II", 0, 0)))
            conn.flush_now()
            conn.transport.close()


class FastStub:
    """Typed stub over FastGrpcChannel: ``FastStub(channel,
    "Seldon").Predict(msg)`` with the messages of ``proto/prediction.py``."""

    def __init__(self, channel: FastGrpcChannel, service: str):
        from seldon_core_tpu_torch.proto.grpc_defs import SERVICES, full_service_name

        for method, (req, res) in SERVICES[service].items():
            path = f"/{full_service_name(service)}/{method}"

            def make(path=path, res=res):
                async def rpc(message, timeout: float = 30.0, metadata=None):
                    raw = await channel.call(
                        path,
                        message.SerializeToString(),
                        timeout,
                        metadata=tuple(metadata) if metadata else (),
                    )
                    return res.FromString(raw)

                return rpc

            setattr(self, method, make())
