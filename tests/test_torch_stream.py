"""Token streaming on the port's engine, on the CPU.

``GenerationScheduler.submit(on_token=...)`` fires per delivered token,
``GenerativeComponent.stream`` yields them as they decode, and the
engine's ``POST /api/v0.1/predictions/stream`` writes them as server-sent
events, one write per decode block: the streamed tokens must equal the
unstreamed reply exactly, a bad request must be a 400 before any header
of the event stream, a client that leaves mid-stream must free its slot
once (the pool's free blocks come back to their count before the request,
none twice), and ``/pause`` must turn ``/ready`` false until ``/unpause``.
"""

import asyncio
import json
import socket
import time

import numpy as np
import pytest

from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.graph.spec import PredictorSpec

BLOCK = 4


def _spec(impl="JAX_GENERATIVE", **params):
    return PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "gen", "type": "MODEL", "implementation": impl,
        "parameters": [{"name": k, "value": str(v), "type": t} for k, (v, t) in params.items()],
    }})


TINY = dict(family=("llama", "STRING"), preset=("tiny", "STRING"), n_slots=(2, "INT"),
            max_new_tokens=(8, "INT"), decode_block=(BLOCK, "INT"))


def _raw(port, path, body: bytes, method="POST", read_events: int | None = None):
    """One request over a raw socket -> (status, headers, body bytes).
    With ``read_events`` the socket is closed once that many events came."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=20)
    try:
        sock.sendall((f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode()
                     + body)
        data = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
            if read_events is not None and data.count(b"\n\ndata:") + 1 >= read_events \
                    and b"data:" in data:
                break
    finally:
        sock.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return int(lines[0].split(" ")[1]), {k.lower(): v for k, v in headers.items()}, payload


def _events(payload: bytes) -> list[dict]:
    return [json.loads(chunk[len(b"data: "):]) for chunk in payload.split(b"\n\n")
            if chunk.startswith(b"data: ")]


async def _engine(spec):
    app = EngineApp(PredictionService(spec, device="cpu"))
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


def test_stream_groups_are_decode_blocks_and_equal_the_reply():
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            comp = app.service.walker.component
            prompt = [5, 9, 2, 17, 3]
            groups = [g async for g in comp.stream_groups(prompt, max_new_tokens=9)]
            flat = [t async for t in comp.stream(prompt, max_new_tokens=9)]
            reply = await comp.scheduler.submit(np.asarray(prompt, np.int32), max_new_tokens=9)
            seen = []
            hooked = await comp.scheduler.submit(np.asarray(prompt, np.int32), max_new_tokens=9,
                                                 on_token=seen.append)
            return groups, flat, reply.tolist(), seen, hooked.tolist()
        finally:
            await app.close()

    groups, flat, reply, seen, hooked = asyncio.run(go())
    # the first token comes from the prefill, then one decode block at a time
    assert [len(g) for g in groups] == [1, BLOCK, BLOCK]
    assert sum(groups, []) == flat == reply == seen == hooked


def test_sse_stream_equals_the_unstreamed_reply():
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            body = json.dumps({"tokens": [5, 9, 2, 17, 3], "max_new_tokens": 9}).encode()
            sse = await asyncio.to_thread(_raw, app.port, "/api/v0.1/predictions/stream", body)
            wrapped = await asyncio.to_thread(
                _raw, app.port, "/api/v0.1/predictions/stream",
                json.dumps({"strData": body.decode()}).encode())
            plain = await asyncio.to_thread(
                _raw, app.port, "/api/v0.1/predictions",
                json.dumps({"strData": body.decode()}).encode())
            return sse, wrapped, plain, dict(app.stream_stats)
        finally:
            await app.close()

    (status, headers, payload), wrapped, plain, stats = asyncio.run(go())
    assert status == 200 and headers["content-type"] == "text/event-stream"
    events = _events(payload)
    tokens = [e["token"] for e in events if "token" in e]
    assert events[-1] == {"done": True, "tokens": tokens}
    want = json.loads(json.loads(plain[2])["strData"])["tokens"]
    assert tokens == want and len(want) == 9
    assert _events(wrapped[2]) == events
    # one write per delivered group: the prefill's token, then two blocks
    assert stats == {"streams": 2, "events": 18, "writes": 6, "disconnects": 0}


@pytest.mark.parametrize("body", [
    {"tokens": [5, 9, 2], "max_new_tokens": "many"},
    {"tokens": [5, 9, 2], "temperature": "hot"},
    {"tokens": [[5, 9], [2]]},
    {"tokens": []},
    {"prompt": [5]},
])
def test_bad_stream_request_is_a_400_before_any_header(body):
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            return await asyncio.to_thread(_raw, app.port, "/api/v0.1/predictions/stream",
                                           json.dumps(body).encode())
        finally:
            await app.close()

    status, headers, payload = asyncio.run(go())
    assert status == 400 and headers["content-type"] == "application/json"
    assert json.loads(payload)["status"]["code"] == 400


def test_stream_needs_a_generative_unit():
    async def go():
        app = await _engine(_spec(impl="SIMPLE_MODEL"))
        try:
            return await asyncio.to_thread(_raw, app.port, "/api/v0.1/predictions/stream",
                                           json.dumps({"tokens": [1, 2]}).encode())
        finally:
            await app.close()

    status, _, payload = asyncio.run(go())
    assert status == 400 and "generative unit" in json.loads(payload)["status"]["info"]


def test_client_leaving_mid_stream_frees_its_slot_once():
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            model = app.service.walker.component.model
            free0 = model.free_block_count
            fetch = model.step_k_fetch

            def slow_fetch(handle):  # blocks slow enough for the client to leave mid-stream
                time.sleep(0.02)
                return fetch(handle)

            model.step_k_fetch = slow_fetch
            body = json.dumps({"tokens": [5, 9, 2, 17, 3], "max_new_tokens": 100}).encode()
            await asyncio.to_thread(_raw, app.port, "/api/v0.1/predictions/stream", body,
                                    read_events=2)
            deadline = time.perf_counter() + 30
            while (app.stream_stats["disconnects"] < 1 or model.free_block_count != free0) \
                    and time.perf_counter() < deadline:
                await asyncio.sleep(0.02)
            return model, free0, dict(app.stream_stats)
        finally:
            await app.close()

    model, free0, stats = asyncio.run(go())
    assert stats["disconnects"] == 1
    assert model.tokens_emitted < 100  # the request was reaped, not run to its end
    assert model.free_block_count == free0 == model.kv_blocks - 1
    assert len(set(model._free_blocks)) == len(model._free_blocks)  # no block freed twice


def test_pause_turns_ready_false_until_unpause():
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            seq = [("/ready", "GET"), ("/pause", "POST"), ("/ready", "GET"), ("/unpause", "GET"),
                   ("/ready", "GET"), ("/pause", "GET"), ("/ready", "GET"), ("/unpause", "POST"),
                   ("/ready", "GET")]
            return [(await asyncio.to_thread(_raw, app.port, p, b"", m))[::2] for p, m in seq]
        finally:
            await app.close()

    got = asyncio.run(go())
    assert got == [(200, b"ready"), (200, b"paused"), (503, b"paused"), (200, b"unpaused"),
                   (200, b"ready"), (200, b"paused"), (503, b"paused"), (200, b"unpaused"),
                   (200, b"ready")]


def test_a_raising_token_hook_is_detached_and_the_request_completes():
    async def go():
        app = await _engine(_spec(**TINY))
        try:
            sched = app.service.walker.component.scheduler
            calls = []

            def hook(tok):
                calls.append(tok)
                raise ValueError("listener broke")

            out = await sched.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=9,
                                     on_token=hook)
            again = await sched.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=9)
            return out.tolist(), again.tolist(), calls
        finally:
            await app.close()

    out, again, calls = asyncio.run(go())
    assert out == again and len(out) == 9
    assert calls == out[:1]  # fired once, then detached
