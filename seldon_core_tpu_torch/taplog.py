"""Durable tap broker: a minimal append-only log service and its client,
the port's copy of the JAX package's ``taplog.py`` (the same frames, so
either package's client talks to either package's broker).

The reference publishes its request/response firehose to Kafka (reference:
api-frontend/.../kafka/KafkaRequestResponseProducer.java:33-76 — topic per
client, puid key, 20ms max block).  This build ships its own broker instead
of assuming a Kafka cluster: a single-binary TCP service
(``sct-tap-broker``) writing per-topic append-only JSONL segments, plus an
asyncio client whose ``append`` is *bounded-block* — a dead broker costs a
publisher at most its timeout, never a stalled serving path.  Where a
Kafka client library IS installed, ``gateway/tap.py`` exposes a Kafka
producer behind the same tap protocol.

Wire protocol (length-prefixed JSON, little-endian uint32 frames):

    -> {"op": "append", "topic": t, "key": k, "value": v}
    <- {"ok": true, "offset": N}
    -> {"op": "fetch", "topic": t, "offset": N, "max": M}
    <- {"ok": true, "records": [{"offset": ..., "ts": ..., "key": ...,
        "value": ...}, ...]}
    -> {"op": "ping"}          <- {"ok": true}
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import struct
import time
from typing import Any

log = logging.getLogger(__name__)

MAX_FRAME = 64 * 1024 * 1024
_LEN = struct.Struct("<I")


async def _read_frame(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ValueError(f"frame {n} exceeds {MAX_FRAME}")
    body = await reader.readexactly(n)
    return json.loads(body)


def _frame(obj: dict) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode()
    return _LEN.pack(len(body)) + body


def _safe_topic(topic: str) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in topic)
    return safe or "_"


class TapBrokerServer:
    """Append-only per-topic logs under ``directory``.

    Offsets are line numbers; existing segments are scanned at startup so
    offsets survive restarts.  ``fsync`` trades throughput for durability
    per record (default off: the page cache + append-only layout already
    survives process crashes, matching Kafka's default posture).
    """

    def __init__(
        self,
        directory: str,
        host: str = "0.0.0.0",
        port: int = 7780,
        fsync: bool = False,
    ):
        self.directory = directory
        self.host, self.port = host, port
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._offsets: dict[str, int] = {}
        self._files: dict[str, Any] = {}
        self._lock = asyncio.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self.bound_port: int = 0

    def _path(self, topic: str) -> str:
        return os.path.join(self.directory, f"{_safe_topic(topic)}.log")

    def _open(self, topic: str):
        f = self._files.get(topic)
        if f is None:
            path = self._path(topic)
            if topic not in self._offsets:
                count = 0
                if os.path.exists(path):
                    # crash recovery: a torn final record (no trailing
                    # newline) was never acked — truncate it, or the next
                    # append would concatenate onto it and leave one
                    # permanently unparseable line mid-file that stalls
                    # every consumer at that offset forever
                    self._truncate_torn_tail(path)
                    with open(path, "rb") as existing:
                        count = sum(1 for _ in existing)
                self._offsets[topic] = count
            f = open(path, "ab")
            self._files[topic] = f
        return f

    @staticmethod
    def _truncate_torn_tail(path: str) -> None:
        with open(path, "rb+") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size == 0:
                return
            fh.seek(size - 1)
            if fh.read(1) == b"\n":
                return
            # scan back to the last complete record boundary
            pos = size - 1
            chunk = 4096
            while pos > 0:
                read_from = max(0, pos - chunk)
                fh.seek(read_from)
                data = fh.read(pos - read_from)
                nl = data.rfind(b"\n")
                if nl != -1:
                    fh.truncate(read_from + nl + 1)
                    return
                pos = read_from
            fh.truncate(0)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        log.info("tap broker on %s:%d -> %s", self.host, self.bound_port, self.directory)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() (3.12+) waits for connection handlers too —
            # close live client connections or shutdown hangs forever
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
        for f in self._files.values():
            f.close()
        self._files.clear()

    # -- ops -----------------------------------------------------------------

    async def _append(self, msg: dict) -> dict:
        topic = str(msg.get("topic", ""))
        if not topic:
            return {"ok": False, "error": "missing topic"}
        async with self._lock:
            f = self._open(topic)
            offset = self._offsets[topic]
            record = {
                "offset": offset,
                "ts": time.time(),
                "key": msg.get("key", ""),
                "value": msg.get("value"),
            }
            f.write(json.dumps(record, separators=(",", ":")).encode() + b"\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
            self._offsets[topic] = offset + 1
        return {"ok": True, "offset": offset}

    async def _fetch(self, msg: dict) -> dict:
        topic = str(msg.get("topic", ""))
        start = int(msg.get("offset", 0))
        limit = min(int(msg.get("max", 100)), 10_000)
        path = self._path(topic)
        records = []
        if os.path.exists(path):
            async with self._lock:
                f = self._files.get(topic)
                if f is not None:
                    f.flush()
            with open(path, "rb") as reader:
                for i, line in enumerate(reader):
                    if i < start:
                        continue
                    if len(records) >= limit:
                        break
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        # The trailing line may be a torn partial flush (read
                        # happens outside the append lock); stop there rather
                        # than failing the consumer connection — the completed
                        # line will be served on the next fetch.
                        break
        return {"ok": True, "records": records}

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                msg = await _read_frame(reader)
                if msg is None:
                    break
                op = msg.get("op")
                if op == "append":
                    reply = await self._append(msg)
                elif op == "fetch":
                    reply = await self._fetch(msg)
                elif op == "ping":
                    reply = {"ok": True}
                else:
                    reply = {"ok": False, "error": f"unknown op {op!r}"}
                writer.write(_frame(reply))
                await writer.drain()
        except (ValueError, json.JSONDecodeError) as e:
            try:
                writer.write(_frame({"ok": False, "error": str(e)}))
                await writer.drain()
            except ConnectionError:
                pass
        except ConnectionError:
            pass
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass


class TapBrokerClient:
    """Async client with bounded-block appends and one reconnect attempt.

    Calls are serialized per client (one in-flight request per connection);
    the gateway tap keeps its own queue in front, so this never becomes the
    serving path's bottleneck.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 0.02):
        self.host, self.port = host, port
        self.timeout_s = timeout_s
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._lock = asyncio.Lock()

    async def _connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)

    async def _roundtrip(self, msg: dict, timeout_s: float) -> dict:
        async def attempt() -> dict:
            if self._writer is None:
                await self._connect()
            assert self._writer is not None and self._reader is not None
            self._writer.write(_frame(msg))
            await self._writer.drain()
            reply = await _read_frame(self._reader)
            if reply is None:
                raise ConnectionError("broker closed connection")
            return reply

        async with self._lock:
            try:
                return await asyncio.wait_for(attempt(), timeout_s)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                await self._drop()
                # one reconnect: a broker restart must not need a client one
                return await asyncio.wait_for(attempt(), timeout_s)

    async def _drop(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        self._reader = self._writer = None

    async def append(
        self, topic: str, key: str, value: Any, timeout_s: float | None = None
    ) -> int:
        reply = await self._roundtrip(
            {"op": "append", "topic": topic, "key": key, "value": value},
            timeout_s if timeout_s is not None else self.timeout_s,
        )
        if not reply.get("ok"):
            raise RuntimeError(f"append failed: {reply.get('error')}")
        return int(reply["offset"])

    async def fetch(self, topic: str, offset: int = 0, max_records: int = 100) -> list[dict]:
        reply = await self._roundtrip(
            {"op": "fetch", "topic": topic, "offset": offset, "max": max_records},
            max(self.timeout_s, 5.0),  # fetches are consumer-side, not hot path
        )
        if not reply.get("ok"):
            raise RuntimeError(f"fetch failed: {reply.get('error')}")
        return reply["records"]

    async def ping(self, timeout_s: float = 2.0) -> bool:
        try:
            return bool((await self._roundtrip({"op": "ping"}, timeout_s)).get("ok"))
        except (ConnectionError, OSError, asyncio.TimeoutError, RuntimeError):
            return False

    async def close(self) -> None:
        async with self._lock:
            await self._drop()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu tap broker")
    parser.add_argument("--port", type=int, default=int(os.environ.get("TAP_BROKER_PORT", "7780")))
    parser.add_argument("--dir", default=os.environ.get("TAP_BROKER_DIR", "./tap-logs"))
    parser.add_argument("--fsync", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    async def run() -> None:
        server = TapBrokerServer(args.dir, port=args.port, fsync=args.fsync)
        await server.start()
        try:
            await asyncio.Event().wait()
        finally:
            await server.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()
