"""A minimal pooled HTTP/1.1 POST client: the port's copy of the JAX
package's ``wire/h1client.py``, on asyncio streams alone.

A hop from the engine to a remote graph unit, or from the gateway to an
engine replica, is a fixed-shape request (a POST with a few headers and a
known body, or a bodiless GET of a ``/stats`` route), so this client does
only what such a hop needs:

- one persistent connection pool per (host, port), LIFO recycle;
- requests written as one pre-assembled bytes block;
- responses parsed with two reads in the common case (header block +
  content-length body); chunked and connection-close bodies supported.

Failures are classified for the caller's retry policy:
:class:`H1ConnectError` (never sent: any method may retry) and
:class:`H1SentError` (may have reached the upstream: only idempotent
methods retry).  A reused idle socket that died before any response byte
is replayed exactly once on a fresh connection (RFC 9112 section 9.3.1).

The pool's semaphore is made at first use, so it binds to the loop that
posts (an engine builds its graph, and so its pools, off its loop).
"""

from __future__ import annotations

import asyncio

__all__ = ["H1Pool", "H1Response", "H1ConnectError", "H1SentError"]


class H1ConnectError(ConnectionError):
    """The TCP connect to the upstream failed: the request was provably
    never sent, so retrying is safe for ANY method."""


class H1SentError(ConnectionError):
    """The connection died after the request (or part of it) was written:
    the upstream may have processed it, so only idempotent methods retry."""


class _StaleConn(ConnectionError):
    """A REUSED connection died before a single response byte arrived: the
    upstream closed an idle keep-alive socket.  Treated as never sent and
    replayed exactly once; any failure after response bytes (or on a fresh
    connection) is not replayed."""


class H1Response:
    """A reply: its status, body and headers (names lower case)."""

    __slots__ = ("status", "body", "headers")

    def __init__(self, status: int, body: bytes, headers: dict[str, str] | None = None):
        self.status = status
        self.body = body
        self.headers = headers if headers is not None else {}


_CRLF = b"\r\n"
_CONN_ERRORS = (ConnectionError, asyncio.IncompleteReadError, OSError, ValueError)


class H1Pool:
    """Keep-alive connection pool to one upstream: at most ``limit`` idle
    sockets kept for reuse and ``max_conns`` requests in flight (callers
    past it queue).  ``opened`` counts the connections ever made."""

    def __init__(self, host: str, port: int, limit: int = 64, max_conns: int = 512):
        self.host = host
        self.port = port
        self.limit = limit
        self.opened = 0
        self._idle: list[tuple[asyncio.StreamReader, asyncio.StreamWriter]] = []
        self._host_hdr = f"{host}:{port}".encode()
        self._closed = False
        self._max_conns = max_conns
        self._sem: asyncio.Semaphore | None = None

    async def _open(self):
        try:
            conn = await asyncio.open_connection(self.host, self.port)
        except OSError as e:
            raise H1ConnectError(f"{self.host}:{self.port}: {e}") from e
        self.opened += 1
        return conn

    def _recycle(self, conn) -> None:
        if self._closed or len(self._idle) >= self.limit:
            conn[1].close()
        else:
            self._idle.append(conn)

    async def close(self) -> None:
        """Stop recycling and close every idle socket; requests in flight
        finish on their own connections, which are then closed."""
        self._closed = True
        idle, self._idle = self._idle, []
        for _r, w in idle:
            w.close()

    def _request_bytes(self, path: str, body: bytes | None,
                       headers: dict[str, str] | None) -> bytes:
        """A POST of ``body``, or a bodiless GET when ``body`` is None."""
        if body is None:
            parts = [b"GET ", path.encode(), b" HTTP/1.1", _CRLF,
                     b"host: ", self._host_hdr, _CRLF]
            body = b""
        else:
            parts = [
                b"POST ", path.encode(), b" HTTP/1.1", _CRLF,
                b"host: ", self._host_hdr, _CRLF,
                b"content-type: application/json", _CRLF,
                b"content-length: ", str(len(body)).encode(), _CRLF,
            ]
        for k, v in (headers or {}).items():
            parts.extend((k.encode(), b": ", v.encode(), _CRLF))
        parts.extend((_CRLF, body))
        return b"".join(parts)

    async def get(self, path: str, timeout: float = 30.0) -> H1Response:
        """One GET (``/stats/*`` scrapes), with :meth:`post`'s budget and
        failure classes."""
        return await self.post(path, None, timeout=timeout)

    async def post(self, path: str, body: bytes | None,
                   headers: dict[str, str] | None = None,
                   timeout: float = 30.0) -> H1Response:
        """One POST (a GET when ``body`` is None) within ONE overall
        ``timeout`` budget: the wait for a free connection, the connect,
        the write and the read, the stale keep-alive replay included.
        Raises :class:`H1ConnectError`, :class:`H1SentError` or
        ``asyncio.TimeoutError``."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout

        def remaining() -> float:
            return max(0.001, deadline - loop.time())

        if self._sem is None:
            self._sem = asyncio.Semaphore(self._max_conns)
        await asyncio.wait_for(self._sem.acquire(), remaining())
        try:
            return await self._post_locked(path, body, headers, remaining)
        finally:
            self._sem.release()

    async def _post_locked(self, path, body, headers, remaining) -> H1Response:
        req = self._request_bytes(path, body, headers)
        reused = bool(self._idle)
        conn = self._idle.pop() if reused else await asyncio.wait_for(self._open(), remaining())
        try:
            return await asyncio.wait_for(self._roundtrip(conn, req, reused), remaining())
        except _StaleConn:
            conn[1].close()
            # replay exactly once, on a provably fresh connection
            conn = await asyncio.wait_for(self._open(), remaining())
            try:
                return await asyncio.wait_for(self._roundtrip(conn, req, reused=False),
                                              remaining())
            except _CONN_ERRORS as e2:
                conn[1].close()
                raise H1SentError(str(e2)) from e2
        except H1SentError:
            conn[1].close()
            raise
        except _CONN_ERRORS as e:
            # ValueError: malformed framing; the request may have been processed
            conn[1].close()
            raise H1SentError(str(e)) from e
        except asyncio.TimeoutError:
            conn[1].close()
            raise

    async def _roundtrip(self, conn, req: bytes, reused: bool) -> H1Response:
        reader, writer = conn
        try:
            writer.write(req)
            await writer.drain()
            status_line = await reader.readline()
        except (ConnectionError, OSError) as e:
            # nothing read yet: on a reused socket, the upstream's keep-alive timeout
            if reused:
                raise _StaleConn(str(e)) from e
            raise
        if not status_line:
            if reused:
                raise _StaleConn("idle keep-alive closed by upstream")
            raise ConnectionResetError("upstream closed before responding")
        try:
            status = int(status_line.split(b" ", 2)[1])
        except (IndexError, ValueError):
            raise H1SentError(f"bad status line {status_line!r}") from None
        length = None
        chunked = False
        keep_alive = True
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (_CRLF, b"\n", b""):
                break
            name, _, value = line.partition(b":")
            name = name.strip().lower()
            value = value.strip()
            headers[name.decode("latin-1")] = value.decode("latin-1")
            if name == b"content-length":
                length = int(value)
            elif name == b"transfer-encoding" and b"chunked" in value.lower():
                chunked = True
            elif name == b"connection" and value.lower() == b"close":
                keep_alive = False
        if chunked:
            body = await self._read_chunked(reader)
        elif length is not None:
            body = await reader.readexactly(length)
        elif not keep_alive:
            body = await reader.read()
        else:
            raise H1SentError("response has no framing (length/chunked/close)")
        if keep_alive:
            self._recycle(conn)
        else:
            writer.close()
        return H1Response(status, bytes(body), headers)

    @staticmethod
    async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
        out = bytearray()
        while True:
            size_line = await reader.readline()
            size = int(size_line.split(b";", 1)[0], 16)
            if size == 0:
                # the trailers, up to the final blank line
                while True:
                    line = await reader.readline()
                    if line in (_CRLF, b"\n", b""):
                        return bytes(out)
            out += await reader.readexactly(size)
            await reader.readexactly(2)  # the chunk's trailing CRLF
