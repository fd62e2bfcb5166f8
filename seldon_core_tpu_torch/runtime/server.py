"""The model microservice's REST server: the port's copy of the JAX
package's ``runtime/server.py``, on ``asyncio.start_server`` (the card has
no aiohttp) with the engine's request reader (``wire/h1server.py``).

It wraps one user component behind the wrapper runtime's routes, so that
a graph unit can run in a process of its own and the engine calls it over
HTTP (a REST endpoint):

    POST /predict, /api/v0.1/predictions   a MODEL's predict
    POST /transform-input, /transform-output
    POST /route          -> the branch as a 1x1 ndarray
    POST /aggregate      {"seldonMessages": [...]}
    POST /send-feedback  a Feedback message, ``routing`` optional
    GET  /ping, /ready, /health/status
    GET  /prometheus     the process's metric families (``utils/metrics.py``)

A body is JSON or form-encoded with the message in a ``json`` field.  A
bad body is a 400, a :class:`GraphUnitError` a 500, and any other
exception of the user's code a 500 whose reason is ``"<Type>: <msg>"``,
all with a FAILURE status.  The component is served as given: the server
puts nothing on a device.  While it listens, the event loop's lag probe
runs (``seldon_eventloop_lag_seconds{service="microservice"}``).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import signal
from typing import Any

import numpy as np

from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    feedback_from_dict,
    payload_from_dict,
    payload_to_dict,
)
from seldon_core_tpu_torch.contract.payload import Payload
from seldon_core_tpu_torch.graph.spec import PredictiveUnitSpec, UnitType
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.graph.walker import LocalClient, make_annotation_lock
from seldon_core_tpu_torch.obs.probes import LOOP_LAG
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS
from seldon_core_tpu_torch.wire.h1server import (
    BadRequest,
    keep_alive,
    read_request,
    request_json,
    response,
)

log = logging.getLogger(__name__)


def _reply(status: int, obj: dict) -> tuple[int, bytes, str]:
    return status, json.dumps(obj).encode(), "application/json"


def _failure(code: int, reason: str, status: int = 400) -> tuple[int, bytes, str]:
    return _reply(status, failure_status_dict(code, reason))


class MicroserviceApp:
    """The REST front of one user component."""

    def __init__(self, component: Any, name: str = "model", service_type: str = "MODEL"):
        self.component = component
        self.name = name
        self.service_type = service_type
        # two client views of one component: a MODEL's transform_input is its
        # predict, a TRANSFORMER's its transform_input.  They share ONE
        # annotation lock, or a /predict could race a /transform-input over
        # the same stateful component's tags
        shared_lock = make_annotation_lock(component)
        self._model_client = LocalClient(
            PredictiveUnitSpec(name=name, type=UnitType.MODEL), component, tag_lock=shared_lock)
        self._transformer_client = LocalClient(
            PredictiveUnitSpec(name=name, type=UnitType.TRANSFORMER), component,
            tag_lock=shared_lock)
        self._server: asyncio.base_events.Server | None = None
        self._probing = False  # this server holds the loop-lag probe
        self._conns: set[asyncio.StreamWriter] = set()
        self._posts = {
            "/predict": self.predict,
            "/api/v0.1/predictions": self.predict,
            "/transform-input": self.transform_input,
            "/transform-output": self.transform_output,
            "/route": self.route,
            "/aggregate": self.aggregate,
            "/send-feedback": self.send_feedback,
        }
        self._gets = {"/ping": b"pong", "/ready": b"ready", "/health/status": b"pong"}

    @property
    def port(self) -> int:
        return self._server.sockets[0].getsockname()[1]

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._handle, host, port)
        LOOP_LAG.start("microservice")
        self._probing = True

    async def close(self) -> None:
        """Stop listening and close every connection, the idle keep-alive
        ones of an engine's pool included (the server waits for them)."""
        if self._probing:
            LOOP_LAG.stop()
            self._probing = False
        if self._server is not None:
            self._server.close()
            for writer in list(self._conns):
                writer.close()
            await self._server.wait_closed()

    # -- routes -----------------------------------------------------------

    async def dispatch(self, method: str, path: str, body: bytes,
                       headers: dict[str, str]) -> tuple[int, bytes, str]:
        """One request -> ``(status, body, content type)``."""
        if path == "/prometheus":
            if method != "GET":
                return _failure(405, f"GET {path}", status=405)
            return 200, DEFAULT_METRICS.expose(), DEFAULT_METRICS.expose_content_type()
        if path in self._gets:
            if method != "GET":
                return _failure(405, f"GET {path}", status=405)
            return 200, self._gets[path], "text/plain"
        handler = self._posts.get(path)
        if handler is None:
            return _failure(404, f"no route {path}", status=404)
        if method != "POST":
            return _failure(405, f"POST to {path}", status=405)
        return await handler(body, headers)

    async def _guarded(self, coro) -> tuple[int, bytes, str]:
        """The wire contract of every component call: a FAILURE status with
        400 for a bad body, 500 for a unit's error or any exception of the
        user's code."""
        try:
            return await coro
        except CodecError as e:
            return _failure(400, str(e))
        except GraphUnitError as e:
            return _failure(500, str(e), status=500)
        except Exception as e:  # noqa: BLE001 - user code may raise anything
            log.exception("unhandled component error")
            return _failure(500, f"{type(e).__name__}: {e}", status=500)

    async def _transform(self, body, headers, client: LocalClient, method: str):
        async def go():
            payload = payload_from_dict(request_json(body, headers))
            if method == "input":
                out = await client.transform_input(payload)
            else:
                out = await client.transform_output(payload)
            return _reply(200, payload_to_dict(out))

        return await self._guarded(go())

    async def predict(self, body: bytes, headers: dict[str, str]):
        return await self._transform(body, headers, self._model_client, "input")

    async def transform_input(self, body: bytes, headers: dict[str, str]):
        return await self._transform(body, headers, self._transformer_client, "input")

    async def transform_output(self, body: bytes, headers: dict[str, str]):
        return await self._transform(body, headers, self._transformer_client, "output")

    async def route(self, body: bytes, headers: dict[str, str]):
        async def go():
            payload = payload_from_dict(request_json(body, headers))
            branch = await self._model_client.route(payload)
            # the branch as a 1x1 ndarray, as the reference router runtime answers
            return _reply(200, payload_to_dict(payload.with_array(np.array([[branch]]), names=[])))

        return await self._guarded(go())

    async def aggregate(self, body: bytes, headers: dict[str, str]):
        async def go():
            msgs = request_json(body, headers).get("seldonMessages", [])
            if not msgs:
                return _failure(400, "seldonMessages list is empty")
            out = await self._model_client.aggregate([payload_from_dict(m) for m in msgs])
            return _reply(200, payload_to_dict(out))

        return await self._guarded(go())

    async def send_feedback(self, body: bytes, headers: dict[str, str]):
        async def go():
            obj = request_json(body, headers)
            fb = feedback_from_dict(obj)
            routing = obj.get("routing")  # extension: the routed branch, explicitly
            if routing is None and fb.response is not None:
                routing = fb.response.meta.routing.get(self.name)
            await self._model_client.send_feedback(
                fb, int(routing) if routing is not None else None)
            return _reply(200, payload_to_dict(Payload()))

        return await self._guarded(go())

    # -- connections ------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            while True:
                try:
                    req = await read_request(reader)
                except BadRequest as e:
                    writer.write(response(e.status, str(e).encode(), "text/plain", False))
                    await writer.drain()
                    break
                if req is None:
                    break
                method, path, version, headers, body, _query = req
                keep = keep_alive(version, headers)
                status, payload, ctype = await self.dispatch(method, path, body, headers)
                writer.write(response(status, payload, ctype, keep))
                await writer.drain()
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()
            with contextlib.suppress(ConnectionError):
                await writer.wait_closed()


def serve(component: Any, port: int, name: str = "model", service_type: str = "MODEL") -> None:
    """Serve ``component`` on every interface until SIGTERM or SIGINT, then
    return (so the interpreter's exit handlers, the persistence flush among
    them, run)."""

    async def main() -> None:
        app = MicroserviceApp(component, name=name, service_type=service_type)
        await app.start("0.0.0.0", port)
        log.info("microservice %s (%s) listening on port %d", name, service_type, app.port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await app.close()

    asyncio.run(main())
