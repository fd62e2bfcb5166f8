"""The engine: a REST front for one predictor, on the stdlib alone.

    python -m seldon_core_tpu_torch.engine.app --port 8000 [--device cuda|cpu]

Serves ``POST /api/v0.1/predictions`` (a SeldonMessage JSON body),
``GET /ping`` and ``GET /ready`` (true once the graph's units are built and
warmed) with a minimal HTTP/1.1 handler on ``asyncio.start_server``:
Content-Length bodies, keep-alive unless the client says ``close``.  The
predictor comes from ``ENGINE_PREDICTOR`` as for the JAX engine.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os

from seldon_core_tpu_torch import resolve_device
from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    payload_from_json,
    payload_to_dict,
)
from seldon_core_tpu_torch.engine.service import PredictionService, load_predictor_spec
from seldon_core_tpu_torch.executor.generation import QueueFull
from seldon_core_tpu_torch.graph.units import GraphUnitError

log = logging.getLogger(__name__)

MAX_BODY = 64 << 20
MAX_HEADERS = 100
_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 429: "Too Many Requests", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class _BadRequest(Exception):
    def __init__(self, status: int, reason: str):
        super().__init__(reason)
        self.status = status


async def _read_request(reader: asyncio.StreamReader):
    """One HTTP/1.x request -> ``(method, path, version, headers, body)``,
    or None at a clean end of stream."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").rstrip("\r\n").split(" ")
    except ValueError:
        raise _BadRequest(400, "malformed request line") from None
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= MAX_HEADERS:
            raise _BadRequest(400, "too many headers")
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise _BadRequest(501, "chunked request bodies are not supported")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise _BadRequest(400, "bad Content-Length") from None
    if length < 0 or length > MAX_BODY:
        raise _BadRequest(413, f"body of {length} bytes exceeds {MAX_BODY}")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), target.split("?", 1)[0], version, headers, body


def _response(status: int, body: bytes, ctype: str, keep_alive: bool) -> bytes:
    head = (
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
        f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
        f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
    )
    return head.encode("latin-1") + body


def _json(status: int, obj: dict) -> tuple[int, bytes, str]:
    return status, json.dumps(obj).encode(), "application/json"


class EngineApp:
    """The engine's HTTP front over one :class:`PredictionService`."""

    def __init__(self, service: PredictionService):
        self.service = service
        self.ready = False
        self.boot_error: str | None = None
        self._server: asyncio.base_events.Server | None = None

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str, port: int) -> None:
        """Listen (``/ping`` answers from here on)."""
        self._server = await asyncio.start_server(self._handle, host, port)

    async def boot(self) -> None:
        """Build the graph's units off the event loop (loading a model
        blocks), then warm them; ``/ready`` turns true after."""
        try:
            await asyncio.to_thread(self.service.start)
            await self.service.warmup()
        except Exception as e:
            self.boot_error = f"{type(e).__name__}: {e}"
            raise
        self.ready = True

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.service.close()

    async def _route(self, method: str, path: str, body: bytes) -> tuple[int, bytes, str]:
        if path == "/ping":
            return 200, b"pong", "text/plain"
        if path == "/ready":
            if self.ready:
                return 200, b"ready", "text/plain"
            if self.boot_error:
                return 503, f"boot failed: {self.boot_error}".encode(), "text/plain"
            return 503, b"warming", "text/plain"
        if path == "/api/v0.1/predictions":
            if method != "POST":
                return _json(405, failure_status_dict(405, "POST a SeldonMessage"))
            return await self._predictions(body)
        return _json(404, failure_status_dict(404, f"no route {path}"))

    async def _predictions(self, body: bytes) -> tuple[int, bytes, str]:
        if not self.ready:
            return _json(503, failure_status_dict(503, "engine is not ready"))
        try:
            out = await self.service.predict(payload_from_json(body))
        except CodecError as e:
            return _json(400, failure_status_dict(400, str(e)))
        except QueueFull as e:
            return _json(429, failure_status_dict(429, str(e)))
        except GraphUnitError as e:
            return _json(500, failure_status_dict(500, str(e)))
        resp = payload_to_dict(out)
        resp["status"] = {"code": 200, "status": "SUCCESS"}
        return _json(200, resp)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _BadRequest as e:
                    writer.write(_response(e.status, str(e).encode(), "text/plain", False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, version, headers, body = req
                conn = headers.get("connection", "").lower()
                keep = conn == "keep-alive" if version == "HTTP/1.0" else conn != "close"
                try:
                    status, payload, ctype = await self._route(method, path, body)
                except Exception as e:  # noqa: BLE001 - the connection must get an answer
                    log.exception("request %s %s failed", method, path)
                    status, payload, ctype = _json(
                        500, failure_status_dict(500, f"{type(e).__name__}: {e}")
                    )
                writer.write(_response(status, payload, ctype, keep))
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()


async def _serve(host: str, port: int, device: str) -> None:
    service = PredictionService(load_predictor_spec(), device=device)
    app = EngineApp(service)
    await app.start(host, port)
    log.info("engine listening on %s:%d (device %s)", host, app.port, device)
    try:
        await app.boot()
        log.info("engine ready")
        await asyncio.Event().wait()  # serve until cancelled
    finally:
        await app.close()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu engine on PyTorch")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("ENGINE_SERVER_PORT", "8000"))
    )
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)
    with contextlib.suppress(KeyboardInterrupt):
        asyncio.run(_serve(args.host, args.port, args.device))


if __name__ == "__main__":
    main()
