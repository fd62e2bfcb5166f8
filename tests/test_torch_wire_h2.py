"""The port's h2 gRPC data plane (``seldon_core_tpu_torch/wire``): every
class of the JAX package's ``tests/test_wire.py`` run on the port's
``hpack``/``h2grpc`` (HPACK, stream-state cleanup, the retry
classification, eviction, the fast server and client, server streaming,
connection loss cancelling relays), with grpcio on the test side only, in
both directions: a stock grpcio client against the port's server and the
port's client against a grpcio server.  Every socket binds to loopback."""

import asyncio

import grpc
import numpy as np
import pytest

from seldon_core_tpu.proto import prediction_pb2 as pb
from seldon_core_tpu.proto.grpc_defs import Stub, add_service
from seldon_core_tpu_torch.contract import Payload, payload_to_proto
from seldon_core_tpu_torch.proto import prediction as tpb
from seldon_core_tpu_torch.wire import (
    FastGrpcChannel,
    FastGrpcServer,
    FastStub,
    GrpcCallError,
)
from seldon_core_tpu_torch.wire import hpack

run = asyncio.run


# ---------------------------------------------------------------------------
# HPACK
# ---------------------------------------------------------------------------

class TestHpack:
    def test_huffman_round_trip(self):
        for s in (b"", b"a", b"application/grpc", b"www.example.com", bytes(range(256))):
            assert hpack.huffman_decode(hpack.huffman_encode(s)) == s

    def test_huffman_rejects_non_eos_padding(self):
        # 'a' = 5 bits (00011); zero-bit padding would walk the tree and
        # decode a spurious extra symbol — RFC 7541 §5.2 requires an error
        code, length = hpack.HUFFMAN_CODES[ord("a")], hpack.HUFFMAN_LENGTHS[ord("a")]
        padded_with_zeros = bytes([(code << (8 - length)) & 0xFF])
        with pytest.raises(hpack.HpackError):
            hpack.huffman_decode(padded_with_zeros)
        # the same byte padded with EOS-prefix ones is valid
        ok = bytes([(code << (8 - length)) | ((1 << (8 - length)) - 1)])
        assert hpack.huffman_decode(ok) == b"a"

    def test_int_codec_boundaries(self):
        for value in (0, 1, 30, 31, 32, 127, 128, 255, 16383, 2**20):
            enc = hpack.encode_int(value, 5)
            got, pos = hpack.decode_int(enc, 0, 5)
            assert got == value and pos == len(enc)

    def test_static_and_literal_round_trip(self):
        headers = [
            (b":method", b"POST"),
            (b":status", b"200"),
            (b":path", b"/seldon.protos.Seldon/Predict"),
            (b"grpc-status", b"0"),
            (b"x-custom-header", b"some value"),
        ]
        assert hpack.Decoder().decode(hpack.encode_headers(headers)) == headers

    def test_dynamic_table_indexing(self):
        # literal-with-incremental-indexing then 1-byte indexed reference
        block1 = bytes([0x40]) + hpack.encode_string(b"x-k") + hpack.encode_string(b"v1")
        d = hpack.Decoder()
        assert d.decode(block1) == [(b"x-k", b"v1")]
        idx = len(hpack.STATIC_TABLE) + 1
        block2 = hpack.encode_int(idx, 7, 0x80)
        assert d.decode(block2) == [(b"x-k", b"v1")]

class TestStreamStateCleanup:
    """Errored / client-cancelled RPCs must not leak _stream_out slots
    (the send-window entry created by an early client WINDOW_UPDATE)."""

    def _conn(self):
        from seldon_core_tpu_torch.wire.h2grpc import _ServerConn

        async def make():
            # constructed under a running loop: _Conn.__init__ creates a
            # future from the current loop, which may not exist depending
            # on which tests ran before this one
            conn = _ServerConn({})
            conn.transport = None  # _send_error bails before writing
            return conn

        return run(make())

    def test_send_error_drops_send_window(self):
        conn = self._conn()
        conn._stream_out[7] = 65535
        conn._send_error(7, 2, "boom")
        assert 7 not in conn._stream_out

    def test_rst_drops_send_window(self):
        conn = self._conn()
        conn._stream_out[9] = 65535
        conn._on_rst(9, 8)
        assert 9 not in conn._stream_out


class TestRetryClassification:
    """Pin the UNAVAILABLE connect-vs-sent wordings: grpc-core
    messages are unstable, so classification matches several markers."""

    def test_connect_failure_markers(self):
        from seldon_core_tpu_torch.engine.grpc_transport import _is_connect_failure

        for d in (
            "Failed to connect to remote host",
            "connection refused by peer",
            "failed to connect to all addresses; ECONNREFUSED",
            "DNS resolution failed for svc:9000",
        ):
            assert _is_connect_failure(d), d

    def test_sent_failures_stay_sent(self):
        from seldon_core_tpu_torch.engine.grpc_transport import _is_connect_failure

        # "Connection reset" means the connection was ESTABLISHED — the
        # request may have been processed, so non-idempotent must NOT retry
        for d in (
            None,
            "",
            "Connection reset by peer",
            "recvmsg: ECONNRESET",
            "GOAWAY received",
            "Socket closed",
            "keepalive watchdog timeout",
        ):
            assert not _is_connect_failure(d), d


class TestHpackEviction:
    def test_dynamic_table_eviction(self):
        d = hpack.Decoder(max_table_size=64)  # fits one small entry only
        for i in range(3):
            block = (
                bytes([0x40])
                + hpack.encode_string(f"k{i}".encode())
                + hpack.encode_string(b"v")
            )
            d.decode(block)
        assert len(d._dynamic) == 1  # older entries evicted

    def test_table_size_update_over_limit_rejected(self):
        d = hpack.Decoder(max_table_size=4096)
        with pytest.raises(hpack.HpackError):
            d.decode(hpack.encode_int(65536, 5, 0x20))


# ---------------------------------------------------------------------------
# transport interop
# ---------------------------------------------------------------------------

async def _echo(payload: bytes) -> bytes:
    return payload


def _msg(rows=1) -> bytes:
    return payload_to_proto(
        Payload.from_array(np.arange(rows * 3, dtype=np.float64).reshape(rows, 3))
    ).SerializeToString()


class TestFastServer:
    def test_fast_client_fast_server(self):
        async def go():
            server = FastGrpcServer({"/seldon.protos.Seldon/Predict": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            wire = _msg()
            outs = [await ch.call("/seldon.protos.Seldon/Predict", wire) for _ in range(20)]
            await ch.close()
            await server.stop()
            return outs, wire

        outs, wire = run(go())
        assert all(o == wire for o in outs)

    def test_grpcio_client_against_fast_server(self):
        """A stock grpc.aio client (dynamic-table HPACK, default windows)
        must work unmodified against the fast server."""

        async def go():
            server = FastGrpcServer({"/seldon.protos.Seldon/Predict": _echo})
            port = await server.start(0, host="127.0.0.1")
            msg = pb.SeldonMessage.FromString(_msg(2))
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = Stub(ch, "Seldon")
                outs = [await stub.Predict(msg) for _ in range(30)]
            await server.stop()
            return outs, msg

        outs, msg = run(go())
        assert all(o.SerializeToString() == msg.SerializeToString() for o in outs)

    def test_fast_client_against_grpcio_server(self):
        async def go():
            gsrv = grpc.aio.server()

            async def Predict(request, context):
                return request

            add_service(gsrv, "Seldon", {"Predict": Predict})
            port = gsrv.add_insecure_port("127.0.0.1:0")
            await gsrv.start()
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            wire = _msg()
            outs = [await ch.call("/seldon.protos.Seldon/Predict", wire) for _ in range(30)]
            await ch.close()
            await gsrv.stop(0)
            return outs, wire

        outs, wire = run(go())
        assert all(o == wire for o in outs)

    def test_unknown_method_is_unimplemented(self):
        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            try:
                with pytest.raises(GrpcCallError) as e:
                    await ch.call("/a/Nope", b"x")
                return e.value.status
            finally:
                await ch.close()
                await server.stop()

        assert run(go()) == 12  # UNIMPLEMENTED

    def test_handler_exception_surfaces_as_status(self):
        async def boom(payload: bytes) -> bytes:
            raise RuntimeError("kaboom")

        async def go():
            server = FastGrpcServer({"/a/B": boom})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            try:
                with pytest.raises(GrpcCallError) as e:
                    await ch.call("/a/B", b"x")
                return e.value
            finally:
                await ch.close()
                await server.stop()

        err = run(go())
        assert err.status == 2 and "kaboom" in err.message

    def test_flow_control_big_payloads_both_stacks(self):
        """5MB echoes exceed every default window; DATA must be windowed and
        trailers must not overtake queued DATA (a grpcio client advertises
        only a 64KB initial window, forcing the server's send queue)."""
        big = bytes(np.random.default_rng(0).integers(0, 256, 5_000_000, dtype=np.uint8))

        async def go():
            server = FastGrpcServer({"/big/Echo": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            fast = await ch.call("/big/Echo", big, timeout=60)
            # interleave big and small to exercise per-stream ordering
            mixed = await asyncio.gather(
                *(ch.call("/big/Echo", big if i % 3 == 0 else b"s" * 10, timeout=60) for i in range(9))
            )
            await ch.close()
            async with grpc.aio.insecure_channel(
                f"127.0.0.1:{port}",
                options=[("grpc.max_receive_message_length", 64 * 1024 * 1024)],
            ) as gch:
                rpc = gch.unary_unary("/big/Echo")
                gout = await rpc(big, timeout=60)
            await server.stop()
            return fast, mixed, gout

        fast, mixed, gout = run(go())
        assert fast == big and gout == big
        for i, o in enumerate(mixed):
            assert o == (big if i % 3 == 0 else b"s" * 10)

    def test_metadata_reaches_wire(self):
        """Custom metadata (gateway OAuth tokens) must round-trip: a grpcio
        server echoes the received metadata back through the response."""

        async def go():
            gsrv = grpc.aio.server()
            seen = {}

            async def Predict(request, context):
                for k, v in context.invocation_metadata():
                    seen[k] = v
                return request

            add_service(gsrv, "Seldon", {"Predict": Predict})
            port = gsrv.add_insecure_port("127.0.0.1:0")
            await gsrv.start()
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            await ch.call(
                "/seldon.protos.Seldon/Predict",
                _msg(),
                metadata=(("oauth_token", "tok123"),),
            )
            await ch.close()
            await gsrv.stop(0)
            return seen

        seen = run(go())
        assert seen.get("oauth_token") == "tok123"

    def test_fast_stub_typed_interface(self):
        async def go():
            server = FastGrpcServer({"/seldon.protos.Seldon/Predict": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            stub = FastStub(ch, "Seldon")
            out = await stub.Predict(tpb.SeldonMessage.FromString(_msg()))
            await ch.close()
            await server.stop()
            return out

        out = run(go())
        assert out.SerializeToString() == _msg()

    def test_malformed_frames_get_goaway_not_crash(self):
        """Short WINDOW_UPDATE / bad padding must produce GOAWAY + close,
        never an unhandled exception on the transport."""
        from seldon_core_tpu_torch.wire.h2grpc import PREFACE, frame, WINDOW_UPDATE

        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(PREFACE)
            writer.write(frame(WINDOW_UPDATE, 0, 0, b"\x01"))  # short payload
            await writer.drain()
            # server must close the connection (after GOAWAY), not hang
            data = await asyncio.wait_for(reader.read(), timeout=5)
            writer.close()
            # a well-formed connection still works afterwards
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            out = await ch.call("/a/B", b"ok")
            await ch.close()
            await server.stop()
            return data, out

        data, out = run(go())
        assert out == b"ok"
        assert data  # at least SETTINGS + GOAWAY came back before close

    def test_stream_id_exhaustion_cycles_connection(self):
        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            await ch.call("/a/B", b"1")
            first_conn = ch._conn
            first_conn._next_stream = 1 << 30  # simulate 30h of traffic
            await ch.call("/a/B", b"2")
            second_conn = ch._conn
            out = await ch.call("/a/B", b"3")
            await ch.close()
            await server.stop()
            return first_conn is not second_conn, out

        cycled, out = run(go())
        assert cycled and out == b"3"

    def test_timeout_sends_rst_and_cancels_handler(self):
        """An abandoned deadline must not leak stream state or leave the
        server handler running forever."""
        started = asyncio.Event()
        cancelled = asyncio.Event()

        async def slow(payload: bytes) -> bytes:
            started.set()
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                cancelled.set()
                raise
            return payload

        async def go():
            server = FastGrpcServer({"/a/Slow": slow, "/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            with pytest.raises(asyncio.TimeoutError):
                await ch.call("/a/Slow", b"x", timeout=0.3)
            await asyncio.wait_for(cancelled.wait(), timeout=5)
            conn = ch._conn
            # client dropped its per-stream state
            assert not conn._calls and not conn._stream_out
            # the connection is still healthy for new calls
            out = await ch.call("/a/B", b"ok")
            await ch.close()
            await server.stop()
            return out

        assert run(go()) == b"ok"

    def test_stream_state_freed_after_calls(self):
        """Per-stream send-window entries must not accumulate across RPCs
        (one leak per call on long-lived engine->microservice channels)."""

        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            for _ in range(50):
                await ch.call("/a/B", b"x")
            client_state = len(ch._conn._stream_out)
            server_conn = next(iter(server._conns))
            server_state = len(server_conn._stream_out)
            await ch.close()
            await server.stop()
            return client_state, server_state

        client_state, server_state = run(go())
        assert client_state == 0
        assert server_state == 0

    def test_stop_closes_established_connections(self):
        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            await ch.call("/a/B", b"x")
            await server.stop(grace=1)
            with pytest.raises((ConnectionError, GrpcCallError, asyncio.TimeoutError, OSError)):
                await ch.call("/a/B", b"y", timeout=2)
            await ch.close()

        run(go())

    def test_graceful_stop_lets_inflight_finish(self):
        """stop(grace) must let in-flight RPCs complete: GOAWAY carries the
        highest accepted stream id and the client drains instead of killing
        pending calls."""
        release = asyncio.Event()

        async def slow(payload: bytes) -> bytes:
            await release.wait()
            return payload + b"-done"

        async def go():
            server = FastGrpcServer({"/a/Slow": slow})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            call = asyncio.ensure_future(ch.call("/a/Slow", b"x", timeout=30))
            await asyncio.sleep(0.2)  # request reaches the handler
            stop_task = asyncio.ensure_future(server.stop(grace=10))
            await asyncio.sleep(0.2)  # GOAWAY delivered while call in flight
            release.set()
            out = await call
            await stop_task
            await ch.close()
            return out

        assert run(go()) == b"x-done"

    def test_request_headers_hook_seeds_task_context(self):
        """The on_request_headers hook runs in the handler task's context so
        per-request contextvars (traceparent at the engine's gRPC ingress)
        propagate to downstream hops without leaking across requests."""
        import contextvars

        var: contextvars.ContextVar = contextvars.ContextVar("probe", default=None)
        seen = []

        def hook(headers):
            for k, v in headers:
                if k == b"x-probe":
                    var.set(v.decode())

        async def echo_probe(payload: bytes) -> bytes:
            seen.append(var.get())
            return payload

        async def go():
            server = FastGrpcServer({"/a/B": echo_probe}, on_request_headers=hook)
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            await ch.call("/a/B", b"1", metadata=(("x-probe", "alpha"),))
            await ch.call("/a/B", b"2")  # no header: must not inherit alpha
            await ch.call("/a/B", b"3", metadata=(("x-probe", "beta"),))
            await ch.close()
            await server.stop()

        run(go())
        assert seen == ["alpha", None, "beta"]

    def test_metadata_not_cached_in_template(self):
        """Per-request metadata (fresh traceparent per call) must not grow
        the hpack template cache."""

        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            for i in range(50):
                await ch.call("/a/B", b"x", metadata=(("traceparent", f"00-{i:032x}-{i:016x}-01"),))
            cache_size = len(ch._conn._path_templates)
            await ch.close()
            await server.stop()
            return cache_size

        assert run(go()) == 1  # one entry per path, not per metadata

    def test_ping_and_continuation_frames(self):
        """Raw-frame drive of rarely-hit protocol paths: PING must be acked
        with the same payload, and a header block split across HEADERS +
        CONTINUATION must still parse into one request."""
        from seldon_core_tpu_torch.wire import hpack as _hpack
        from seldon_core_tpu_torch.wire.h2grpc import (
            CONTINUATION,
            DATA,
            END_HEADERS,
            END_STREAM,
            HEADERS,
            PING,
            PREFACE,
            frame,
            grpc_frame,
        )

        async def go():
            server = FastGrpcServer({"/a/B": _echo})
            port = await server.start(0, host="127.0.0.1")
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(PREFACE)
            # PING with a marker payload
            writer.write(frame(PING, 0, 0, b"pingpong"))
            # request headers split across HEADERS + CONTINUATION
            block = _hpack.encode_headers(
                [
                    (b":method", b"POST"),
                    (b":scheme", b"http"),
                    (b":path", b"/a/B"),
                    (b":authority", b"t"),
                    (b"content-type", b"application/grpc"),
                    (b"te", b"trailers"),
                ]
            )
            half = len(block) // 2
            writer.write(frame(HEADERS, 0, 1, block[:half]))  # no END_HEADERS
            writer.write(frame(CONTINUATION, END_HEADERS, 1, block[half:]))
            writer.write(frame(DATA, END_STREAM, 1, grpc_frame(b"hello")))
            await writer.drain()
            # collect frames until the response trailers arrive
            buf = b""
            saw_ping_ack = saw_data = False
            deadline = asyncio.get_event_loop().time() + 10
            while asyncio.get_event_loop().time() < deadline:
                chunk = await asyncio.wait_for(reader.read(4096), timeout=5)
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 9:
                    n = (buf[0] << 16) | (buf[1] << 8) | buf[2]
                    if len(buf) < 9 + n:
                        break
                    ftype, payload = buf[3], buf[9 : 9 + n]
                    if ftype == PING and payload == b"pingpong":
                        saw_ping_ack = True
                    if ftype == DATA and b"hello" in payload:
                        saw_data = True
                    buf = buf[9 + n :]
                if saw_ping_ack and saw_data:
                    break
            writer.close()
            await server.stop()
            return saw_ping_ack, saw_data

        saw_ping_ack, saw_data = run(go())
        assert saw_ping_ack and saw_data

    def test_dynamic_table_size_update_from_peer(self):
        """A peer shrinking its encoder table emits a table-size-update
        opcode; the server's decoder must apply it and keep serving."""
        from seldon_core_tpu_torch.wire import hpack as _hpack

        d = _hpack.Decoder(max_table_size=4096)
        # block 1: add a dynamic entry
        block1 = (
            bytes([0x40]) + _hpack.encode_string(b"x-k") + _hpack.encode_string(b"v")
        )
        assert d.decode(block1) == [(b"x-k", b"v")]
        # block 2: size update FIRST (RFC 7541 §4.2 requires it at block
        # start) shrinking to zero, then a static index — entry evicted
        block2 = (
            _hpack.encode_int(0, 5, 0x20)  # table size -> 0
            + _hpack.encode_int(2, 7, 0x80)  # static: :method GET
        )
        assert d.decode(block2) == [(b":method", b"GET")]
        assert len(d._dynamic) == 0  # evicted by the size update


# ---------------------------------------------------------------------------
# server-streaming
# ---------------------------------------------------------------------------

class TestServerStreaming:
    def test_stream_messages_arrive_incrementally(self):
        """Prove true streaming, not buffer-until-end: the handler parks
        after its first yield until the CLIENT confirms receipt — a
        buffering implementation would deadlock here."""

        async def go():
            got_first = asyncio.Event()

            async def counter(payload: bytes):
                n = int(payload.decode())
                yield b"msg-0"
                await asyncio.wait_for(got_first.wait(), 5)
                for i in range(1, n):
                    yield f"msg-{i}".encode()

            server = FastGrpcServer({}, stream_handlers={"/test.Svc/Count": counter})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            out = []
            async for msg in ch.call_stream("/test.Svc/Count", b"4", timeout=10):
                if not out:
                    got_first.set()
                out.append(msg)
            await ch.close()
            await server.stop()
            return out

        out = run(go())
        assert out == [b"msg-0", b"msg-1", b"msg-2", b"msg-3"]

    def test_empty_stream_ok(self):
        async def go():
            async def empty(payload: bytes):
                return
                yield  # pragma: no cover

            server = FastGrpcServer({}, stream_handlers={"/test.Svc/Empty": empty})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            out = [m async for m in ch.call_stream("/test.Svc/Empty", b"")]
            await ch.close()
            await server.stop()
            return out

        assert run(go()) == []

    def test_mid_stream_error_reaches_client_after_messages(self):
        async def go():
            async def faulty(payload: bytes):
                yield b"ok-1"
                yield b"ok-2"
                raise GrpcCallError(3, "bad argument later")

            server = FastGrpcServer({}, stream_handlers={"/test.Svc/Faulty": faulty})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            out = []
            err = None
            try:
                async for msg in ch.call_stream("/test.Svc/Faulty", b""):
                    out.append(msg)
            except GrpcCallError as e:
                err = e
            await ch.close()
            await server.stop()
            return out, err

        out, err = run(go())
        assert out == [b"ok-1", b"ok-2"]
        assert err is not None and err.status == 3 and "later" in err.message

    def test_unary_and_stream_share_one_connection(self):
        async def go():
            async def gen(payload: bytes):
                for i in range(3):
                    yield payload + str(i).encode()

            server = FastGrpcServer(
                {"/test.Svc/Echo": _echo},
                stream_handlers={"/test.Svc/Gen": gen},
            )
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            streamed = [m async for m in ch.call_stream("/test.Svc/Gen", b"x")]
            unary = await ch.call("/test.Svc/Echo", b"hello")
            assert ch._conn is not None  # same pooled connection
            await ch.close()
            await server.stop()
            return streamed, unary

        streamed, unary = run(go())
        assert streamed == [b"x0", b"x1", b"x2"]
        assert unary == b"hello"

    def test_grpcio_client_reads_our_stream(self):
        """Interop: a standard grpcio client consumes the fast server's
        stream (the whole point of speaking real HTTP/2)."""

        async def go():
            async def gen(payload: bytes):
                for i in range(3):
                    yield f"tok-{i}".encode()

            server = FastGrpcServer({}, stream_handlers={"/test.Svc/Gen": gen})
            port = await server.start(0, host="127.0.0.1")
            ch = grpc.aio.insecure_channel(f"127.0.0.1:{port}")
            call = ch.unary_stream(
                "/test.Svc/Gen",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            out = [m async for m in call(b"")]
            await ch.close()
            await server.stop()
            return out

        assert run(go()) == [b"tok-0", b"tok-1", b"tok-2"]

    def test_big_messages_ride_flow_control(self):
        async def go():
            big = bytes(range(256)) * 4096  # 1 MiB per message

            async def gen(payload: bytes):
                for _ in range(4):
                    yield big

            server = FastGrpcServer({}, stream_handlers={"/test.Svc/Big": gen})
            port = await server.start(0, host="127.0.0.1")
            ch = FastGrpcChannel(f"127.0.0.1:{port}")
            sizes = [len(m) async for m in ch.call_stream("/test.Svc/Big", b"")]
            await ch.close()
            await server.stop()
            return sizes, len(big)

        sizes, n = run(go())
        assert sizes == [n] * 4

    def test_rst_on_blocked_stream_frees_backpressure(self):
        """A cancelled flow-control-blocked stream must not leave its
        parked DATA counting against drain_sends forever (that would
        wedge every later streaming producer on the connection)."""

        async def go():
            from seldon_core_tpu_torch.wire.h2grpc import _ServerConn

            conn = _ServerConn({})
            conn.transport = None
            # park >high-water bytes for stream 5
            conn._send_queue.append((5, b"x" * (conn._SEND_HIGH_WATER + 1), 0))
            assert conn._queued_send_bytes(5) > conn._SEND_HIGH_WATER
            # per-stream accounting: stream 7 is NOT blocked by stream 5
            assert conn._queued_send_bytes(7) == 0
            conn._on_rst(5, 8)
            assert conn._queued_send_bytes(5) == 0
            assert conn._send_queue == []

        run(go())


class TestServerConnLossCancelsRelays:
    def test_on_closed_pops_and_invokes_relay_cancels(self):
        """A dead downstream gRPC connection must cancel
        in-flight inline relays upstream — full connection loss gets the
        same treatment a per-stream RST already had."""
        from seldon_core_tpu_torch.wire.h2grpc import _ServerConn

        async def go():
            conn = _ServerConn({})
            called = []
            conn.relay_cancels[1] = lambda: called.append(1)
            conn.relay_cancels[3] = lambda: called.append(3)

            def boom():
                called.append(5)
                raise RuntimeError("cancel blew up")

            conn.relay_cancels[5] = boom
            conn._on_closed(ConnectionError("client went away"))
            return conn, called

        conn, called = asyncio.run(go())
        assert sorted(called) == [1, 3, 5], "every relay cancel must run"
        assert conn.relay_cancels == {}, "cancels must be popped, not re-run"
