"""The HTTP/1.1 server side the engine and the wrapper runtime share, on
asyncio streams alone: one request read off a connection, one response
assembled, and the JSON body of a request parsed as the JAX package's
servers parse it.

A request body is JSON, or form-encoded with the message in a ``json``
field (``application/x-www-form-urlencoded`` or ``multipart/form-data``),
as the reference engine posts it between services.
"""

from __future__ import annotations

import asyncio
import email.parser
import email.policy
import json
import urllib.parse
from typing import Any, Callable

from seldon_core_tpu_torch.contract.codec import CodecError

MAX_BODY = 64 << 20
MAX_HEADERS = 100
REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented", 503: "Service Unavailable",
    504: "Gateway Timeout",
}


class BadRequest(Exception):
    """A request that cannot be read; ``status`` is its reply's code."""

    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status


async def read_request(reader: asyncio.StreamReader,
                       body_limit: Callable[[str], int] = lambda _path: MAX_BODY):
    """One HTTP/1.x request -> ``(method, path, version, headers, body,
    query)`` (header names lower case, ``query`` the raw string after
    ``?``), or None at a clean end of stream.  A body
    over ``body_limit(path)`` bytes is refused (413), as is a chunked one
    (501)."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ")
    except ValueError:
        raise BadRequest(400, "malformed request line") from None
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= MAX_HEADERS:
            raise BadRequest(400, "too many headers")
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise BadRequest(501, "chunked request bodies are not supported")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise BadRequest(400, "bad Content-Length") from None
    path, _, query = target.partition("?")
    limit = body_limit(path)
    if length < 0 or length > limit:
        raise BadRequest(413, f"body of {length} bytes exceeds {limit}")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, version, headers, body, query


def keep_alive(version: str, headers: dict[str, str]) -> bool:
    """Whether the connection stays open after this request's reply."""
    conn = headers.get("connection", "").lower()
    return conn == "keep-alive" if version == "HTTP/1.0" else conn != "close"


def response(status: int, body: bytes, ctype: str, keep_alive: bool,
             extra: dict[str, str] | None = None) -> bytes:
    """A whole response: status line, headers and ``body``."""
    more = "".join(f"{k}: {v}\r\n" for k, v in (extra or {}).items())
    head = (
        f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}\r\n"
        f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n{more}"
        f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
    )
    return head.encode("latin-1") + body


def _form_field(body: bytes, ctype: str, field: str) -> str | None:
    """The ``field`` of a form body, or None when it has none."""
    if "multipart" in ctype:
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            f"Content-Type: {ctype}\r\n\r\n".encode("latin-1") + body)
        for part in msg.iter_parts():
            if part.get_param("name", header="content-disposition") == field:
                return part.get_payload(decode=True).decode()
        return None
    values = urllib.parse.parse_qs(body.decode("latin-1"), keep_blank_values=True)
    return values[field][0] if field in values else None


def request_json(body: bytes, headers: dict[str, str]) -> Any:
    """A request's JSON: the body itself, or the ``json`` field of a form
    body (the content type holds ``form``).  Raises :class:`CodecError`
    with the JAX servers' reasons.  A body that is a JSON object or array
    is taken as JSON whatever its content type says: ``urllib`` labels every
    body it posts as a form unless told otherwise (the JAX servers refuse
    such a request), and a large tensor body is not scanned as a form."""
    ctype = headers.get("content-type", "")
    raw = body
    if "form" in ctype.lower() and body.lstrip()[:1] not in (b"{", b"["):
        try:
            raw = _form_field(body, ctype, "json")
        except (ValueError, AttributeError) as e:  # a malformed form or part
            raise CodecError(f"malformed form body: {e}") from e
        if raw is None:
            raise CodecError("form request missing 'json' field")
    try:
        return json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise CodecError(f"invalid JSON body: {e}") from e
