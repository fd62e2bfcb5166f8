"""Request/response firehose tap: the port's copy of the JAX package's
``gateway/tap.py``.

The reference publishes every prediction request+response pair to Kafka
(topic = client id, key = puid, value = RequestResponse proto; 20ms max
block so serving never stalls — reference:
api-frontend/.../kafka/KafkaRequestResponseProducer.java:33-76).

Same contract here as a pluggable async sink: the durable broker of
``taplog.py`` (``GATEWAY_TAP_BROKER``) or a JSONL file per deployment
(``GATEWAY_TAP_DIR``).  ``GATEWAY_TAP_KAFKA`` is refused by name: the
card's image has no Kafka client.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Protocol

log = logging.getLogger(__name__)


class RequestResponseTap(Protocol):
    # False lets the ingress skip building the publish arguments entirely
    # (parsing request+reply JSON per call) when no sink is configured
    enabled: bool

    async def publish(self, client_id: str, puid: str, request: Any, response: Any) -> None: ...

    async def close(self) -> None: ...


class NullTap:
    enabled = False

    async def publish(self, client_id: str, puid: str, request: Any, response: Any) -> None:
        return None

    async def close(self) -> None:
        return None


class QueuedTap:
    """Base: publishes go through a bounded queue drained by a background
    task — a slow sink must not stall serving (the reference bounds Kafka
    blocking at 20ms for the same reason; here publish never blocks: the
    pair is dropped when the queue is full, and drops are counted).

    Subclasses implement ``_emit(client_id, line)`` (async, may block)."""

    enabled = True

    def __init__(self, max_queue: int = 4096):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max_queue)
        self._task: asyncio.Task | None = None
        self.dropped = 0
        self.published = 0

    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drain())

    async def publish(self, client_id: str, puid: str, request: Any, response: Any) -> None:
        self._ensure_running()
        line = {
            "ts": time.time(),
            "puid": puid,
            "client": client_id,
            "request": request,
            "response": response,
        }
        try:
            self._queue.put_nowait((client_id, line))
        except asyncio.QueueFull:
            self.dropped += 1

    async def _emit(self, client_id: str, line: dict) -> None:
        raise NotImplementedError

    async def _drain(self) -> None:
        while True:
            client_id, line = await self._queue.get()
            try:
                await self._emit(client_id, line)
                self.published += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                self.dropped += 1
                log.exception("tap emit failed")

    async def close(self) -> None:
        if self._task is not None:
            while not self._queue.empty():
                await asyncio.sleep(0.01)
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass


class JsonlTap(QueuedTap):
    """Append request/response pairs to ``{dir}/{client_id}.jsonl``."""

    def __init__(self, directory: str, max_queue: int = 4096):
        super().__init__(max_queue)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _write(self, client_id: str, line: dict) -> None:
        path = os.path.join(self.directory, f"{client_id}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")

    async def _emit(self, client_id: str, line: dict) -> None:
        # serialize+write off the event loop: a slow disk must not stall
        # auth/predictions/health on the serving loop
        await asyncio.get_running_loop().run_in_executor(
            None, self._write, client_id, line
        )


class BrokerTap(QueuedTap):
    """Durable tap: publish pairs to the tap broker (seldon_core_tpu_torch/
    taplog.py), topic = client id, key = puid — the reference's Kafka
    layout (KafkaRequestResponseProducer.java:70-73) over the framework's
    own log service.  Appends are bounded-block (default 20ms, like the
    reference's ``max.block.ms``)."""

    def __init__(self, host: str, port: int, max_queue: int = 4096, timeout_s: float = 0.02):
        super().__init__(max_queue)
        from seldon_core_tpu_torch.taplog import TapBrokerClient

        self.client = TapBrokerClient(host, port, timeout_s=timeout_s)

    async def _emit(self, client_id: str, line: dict) -> None:
        await self.client.append(client_id, line["puid"], line)

    async def close(self) -> None:
        await super().close()
        await self.client.close()


def tap_from_env(environ: dict | None = None) -> RequestResponseTap:
    """``GATEWAY_TAP_BROKER=host:port`` (durable broker) >
    ``GATEWAY_TAP_DIR=<dir>`` (local JSONL) > disabled.
    ``GATEWAY_TAP_KAFKA`` raises: the card's image has no Kafka client."""
    env = environ if environ is not None else os.environ
    broker = env.get("GATEWAY_TAP_BROKER", "")
    if broker:
        host, _, port = broker.partition(":")
        return BrokerTap(host or "127.0.0.1", int(port or 7780))
    if env.get("GATEWAY_TAP_KAFKA", ""):
        raise NotImplementedError(
            "GATEWAY_TAP_KAFKA: the Kafka tap is not in the port (the card's image has no "
            "Kafka client library); use GATEWAY_TAP_BROKER=<host:port> (the taplog broker)")
    directory = env.get("GATEWAY_TAP_DIR", "")
    if directory:
        return JsonlTap(directory)
    return NullTap()
