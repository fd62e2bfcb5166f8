"""The port's response tiers on the CPU, against the JAX package.

* ``cache/content.py``: ``request_key``, ``canonical_body``,
  ``payload_cache_key`` and ``spec_hash`` give the JAX digests (``spec_hash``
  of the same predictor JSON through both spec classes);
* ``ResponseCache`` and ``SemanticCache``: one operation sequence gives
  the same hits, misses, evictions, expirations and flushes in both;
* ``SingleFlight``: the JAX package's three cases;
* the engine: an exact hit spends no device step, a herd collapses into
  one walk, a graph that is not deterministic refuses the response tiers,
  the walker's node tier serves a RANDOM_ABTEST's deterministic children,
  a semantic hit on the tiny preset with ``embed`` on;
* ROADMAP C7: the JAX engine answers a request that differs from a cached
  one only in ``max_new_tokens`` (or names another ``adapter``) with the
  cached reply; the port does not;
* the usage meter conserves requests, tokens and device seconds over a
  mixed wave.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu import cache as jcache
from seldon_core_tpu.contract import payload as jpayload
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu_torch import cache as tcache
from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.obs import METER

run = asyncio.run
PROMPT = [5, 9, 2, 17, 3]


def _param(name, value, ptype="STRING"):
    return {"name": name, "value": str(value), "type": ptype}


def _gen(name="gen", **extra):
    params = [_param("preset", "tiny"), _param("n_slots", 2, "INT"),
              _param("max_new_tokens", 4, "INT"), _param("decode_block", 4, "INT")]
    params += [_param(k, v, t) for k, (v, t) in extra.items()]
    return {"name": name, "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": params}


def _mlp(name, rng):
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL", "parameters": [
        _param("family", "mlp"), _param("preset", "tiny"), _param("rng", rng, "INT"),
        _param("max_delay_ms", "1.0", "FLOAT")]}


def _body(tokens=PROMPT, **opts):
    return {"strData": json.dumps({"tokens": tokens, **opts})}


def _post(port, path, body, headers=None):
    """-> (status, headers, body bytes)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


async def _engine(graph, **kw):
    app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                      device="cpu"), **kw)
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


async def _send(app, body, headers=None, path="/api/v0.1/predictions"):
    return await asyncio.to_thread(_post, app.port, path, body, headers)


async def _stats_cache(app) -> dict:
    return (await asyncio.to_thread(_get, app.port, "/stats/cache"))["cache"]


async def _until(cond, timeout_s: float = 20.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.01)


@pytest.fixture
def planes_on(monkeypatch):
    monkeypatch.setenv("SCT_CACHE", "1")
    monkeypatch.setenv("SCT_SEMCACHE", "1")
    METER.reset()
    yield
    METER.reset()


# --------------------------------------------------------------------------
# keys
# --------------------------------------------------------------------------

PREDICTORS = [
    {"name": "p", "graph": {"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}},
    {"name": "p", "graph": _gen(embed=("true", "BOOL"))},
    {"name": "ab", "replicas": 2, "annotations": {"a": "b"}, "graph": {
        "name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
        "parameters": [_param("ratioA", 0.5, "FLOAT")],
        "children": [_mlp("a", 0), _mlp("b", 1)]}},
    {"name": "t", "graph": {"name": "g", "type": "GUARDRAIL", "implementation": "GUARDRAIL",
                            "methods": ["TRANSFORM_OUTPUT"],
                            "endpoint": {"type": "LOCAL", "service_port": 9}}},
]


@pytest.mark.parametrize("spec", PREDICTORS, ids=["simple", "generative", "abtest", "methods"])
def test_spec_hash_equals_the_jax_digest_through_both_spec_classes(spec):
    want = jcache.spec_hash(JaxPredictorSpec.model_validate(spec))
    assert tcache.spec_hash(PredictorSpec.from_dict(spec)) == want
    assert tcache.spec_hash(spec) == jcache.spec_hash(spec)


def test_request_key_and_canonical_body_equal_the_jax_digests():
    bodies = [{"b": 1, "a": [1, 2]}, {"strData": json.dumps({"tokens": PROMPT})},
              {"data": {"ndarray": [[1.5, 2.0]]}, "meta": {"puid": "x"}}, {}]
    for body in bodies:
        assert tcache.canonical_body(body) == jcache.canonical_body(body)
        for route, h in (("predictions", "h1"), ("grpc:Predict", "h2")):
            got = tcache.request_key(route, h, tcache.canonical_body(body))
            assert got == jcache.request_key(route, h, jcache.canonical_body(body))
    assert tcache.canonical_body({"b": 1, "a": 2}) == tcache.canonical_body({"a": 2, "b": 1})


def test_payload_cache_key_equals_the_jax_digest():
    rng = np.random.default_rng(0)
    cases = [
        (rng.normal(size=(2, 3)).astype(np.float32), ["x", "y", "z"], "NDARRAY"),
        (np.arange(6, dtype=np.int32).reshape(3, 2), [], "TENSOR"),
        (rng.normal(size=(1, 4)).astype(np.float64), [], "RAW"),
        ('{"tokens": [5, 9]}', [], "STRING"),
        (b"\x00\x01bytes", [], "BINARY"),
        (None, [], "EMPTY"),
    ]
    for data, names, kind in cases:
        want = jcache.payload_cache_key(jpayload.Payload(data, names,
                                                          getattr(jpayload.DataKind, kind)))
        got = tcache.payload_cache_key(Payload(data, names, getattr(DataKind, kind)))
        assert got == want, kind
    assert tcache.payload_cache_key(Payload(None, [], DataKind.EMPTY)) is None


# --------------------------------------------------------------------------
# the caches' operation sequences against the JAX classes
# --------------------------------------------------------------------------


def _response_ops(mod, clock):
    """The JAX ``TestResponseCache`` sequences on one cache class; -> the
    observable results."""
    out = []
    c = mod.ResponseCache("t", max_entries=3, max_bytes=1000, ttl_s=60)
    for i in range(5):
        c.put("ns", f"k{i}", b"x" * 10)
    out += [c.get("ns", "k0"), c.get("ns", "k1"), c.get("ns", "k4").value, c.evictions]
    c.put("ns", "big", b"y" * 990)
    out += [c.bytes, c.get("ns", "k2"), c.get("ns", "big").value]
    small = mod.ResponseCache("t", max_bytes=100)
    small.put("ns", "k", b"z" * 101)  # larger than the whole budget
    out += [small.get("ns", "k"), small.snapshot()]
    ttl = mod.ResponseCache("t", ttl_s=5.0)
    ttl.put("ns", "k", b"v")
    out.append(ttl.get("ns", "k").value)
    clock[0] += 6.0
    out += [ttl.get("ns", "k"), ttl.expirations]
    ns = mod.ResponseCache("t")
    ns.put("a", "k", b"1")
    ns.put("b", "k", b"2")
    ns.put("b", "k2", b"22")
    out += [ns.flush("a"), ns.get("a", "k"), ns.get("b", "k").value, ns.flush("a"),
            ns.flush(None), ns.snapshot()]
    out.append(c.snapshot())
    return [o.value if hasattr(o, "nbytes") and hasattr(o, "value") else o for o in out]


def _semantic_ops(mod, clock):
    """The JAX ``TestSemanticCacheUnit`` sequences; -> the results."""
    V = np.array([1.0, 0.0, 0.0], np.float32)
    near = np.array([0.99, 0.05, 0.0], np.float32)
    far = np.array([0.5, 0.86, 0.0], np.float32)
    out = []
    c = mod.SemanticCache(sim_threshold=0.9)
    c.put("ns", V, b"answer", "tag")
    out += [c.lookup("ns", near, "tag"), c.lookup("ns", far, "tag"), c.hits, c.misses,
            c.last_sim, c.lookup("other", V, "tag"), c.lookup("ns", V, "tag2")]
    out += [c.lookup("ns", 3 * V, "tag"), round(c.last_sim, 6), c.snapshot()]
    ttl = mod.SemanticCache(ttl_s=5.0)
    ttl.put("ns", V, b"v", "t")
    clock[0] += 6.0
    out += [ttl.lookup("ns", V, "t"), ttl.expirations]
    b = mod.SemanticCache(max_entries=2, max_bytes=10_000)
    for i in range(4):
        vec = np.zeros(3, np.float32)
        vec[i % 3] = 1.0
        b.put("ns", vec, bytes([i]), "t")
    out += [len(b._entries), b.evictions, b.lookup("ns", np.array([0, 0, 1.0], np.float32), "t")]
    big = mod.SemanticCache(max_bytes=64)
    big.put("ns", V, b"x" * 1000, "t")
    out.append(len(big._entries))
    f = mod.SemanticCache()
    f.put("a", V, b"1", "t")
    f.put("b", V, b"2", "t")
    out += [f.flush("a"), f.flush("a"), f.flush(), f.snapshot()]
    return out


@pytest.mark.parametrize("ops", [_response_ops, _semantic_ops], ids=["response", "semantic"])
def test_caches_give_the_jax_results_for_one_operation_sequence(ops, monkeypatch):
    def results(mod, modules):
        clock = [1000.0]
        for m in modules:
            monkeypatch.setattr(m.time, "monotonic", lambda: clock[0])
        return ops(mod, clock)

    from seldon_core_tpu.cache import content as jc, semantic as js
    from seldon_core_tpu_torch.cache import content as tc, semantic as ts

    want = results(jcache, (jc, js))
    got = results(tcache, (tc, ts))
    assert got == want


# --------------------------------------------------------------------------
# single-flight: the JAX package's three cases on both classes
# --------------------------------------------------------------------------


async def _collapse_case(sf_cls):
    sf, calls = sf_cls(), []

    async def work():
        calls.append(1)
        await asyncio.sleep(0.02)
        return 42

    results = await asyncio.gather(*(sf.do("k", work) for _ in range(9)))
    return results, len(calls), sf.snapshot()


async def _distinct_case(sf_cls):
    sf, calls = sf_cls(), []

    async def work(i):
        calls.append(i)
        await asyncio.sleep(0.01)
        return i

    out = await asyncio.gather(*(sf.do(i, lambda i=i: work(i)) for i in range(4)))
    return sorted(out), sorted(calls), sf.snapshot()


async def _error_case(sf_cls):
    sf = sf_cls()

    async def boom():
        await asyncio.sleep(0.01)
        raise ValueError("upstream down")

    results = await asyncio.gather(*(sf.do("k", boom) for _ in range(3)),
                                   return_exceptions=True)
    return [type(r).__name__ for r in results], sf.snapshot()


@pytest.mark.parametrize("case", [_collapse_case, _distinct_case, _error_case],
                         ids=["collapses", "distinct_keys", "leader_error"])
def test_single_flight_equals_the_jax_collapser(case):
    want = run(case(jcache.SingleFlight))
    assert run(case(tcache.SingleFlight)) == want
    if case is _collapse_case:
        assert want[:2] == ([42] * 9, 1) and want[2]["collapsed"] == 8
    if case is _error_case:
        assert want[0] == ["ValueError"] * 3 and want[1]["collapsed_errors"] == 2


def test_a_cancelled_leader_fails_its_followers():
    async def go():
        sf = tcache.SingleFlight()
        gate = asyncio.Event()

        async def slow():
            await gate.wait()
            return 1

        leader = asyncio.create_task(sf.do("k", slow))
        await asyncio.sleep(0)
        followers = [asyncio.create_task(sf.do("k", slow)) for _ in range(2)]
        await asyncio.sleep(0)
        leader.cancel()
        res = await asyncio.gather(*followers, return_exceptions=True)
        return leader.cancelled(), res, sf.inflight

    cancelled, res, inflight = run(go())
    assert cancelled and inflight == 0
    assert all(isinstance(r, asyncio.CancelledError) for r in res)


# --------------------------------------------------------------------------
# the engine's tiers
# --------------------------------------------------------------------------


def _model(app, name="gen"):
    return dict(app.service.walker.iter_components())[name].model


def test_exact_hit_spends_no_device_step_and_a_herd_is_one_walk(planes_on):
    body = {"strData": _body(max_new_tokens=6)["strData"], "meta": {"tags": {"t": 1}}}

    async def go():
        app = await _engine(_gen())
        try:
            m = _model(app)
            first = await _send(app, json.dumps(body, separators=(",", ":")).encode())
            before = (m.prefills, m.steps, m.decode_blocks)
            # the same body, its keys in another order and spaced otherwise
            again = await _send(app, json.dumps(dict(reversed(body.items())), indent=2).encode())
            after = (m.prefills, m.steps, m.decode_blocks)
            herd_body = _body([7, 7, 8, 1], max_new_tokens=5)
            p0 = m.prefills
            herd = await asyncio.gather(*(_send(app, herd_body) for _ in range(6)))
            herd_prefills = m.prefills - p0
            cache = await _stats_cache(app)
            other = await _send(app, _body(max_new_tokens=6, temperature=0.0))
            return first, again, before, after, herd, herd_prefills, cache, other
        finally:
            await app.close()

    first, again, before, after, herd, herd_prefills, cache, other = run(go())
    assert first[0] == 200 and "x-sct-cache" not in {k.lower() for k in first[1]}
    assert again[0] == 200 and again[1].get("x-sct-cache") == "hit"
    assert again[2] == first[2]  # byte-equal
    assert after == before  # no prefill, no step, no block
    assert [h[0] for h in herd] == [200] * 6 and len({h[2] for h in herd}) == 1
    assert herd_prefills == 1  # one walk for the herd
    assert cache["collapse"]["leaders"] >= 2 and cache["collapse"]["collapsed"] >= 1
    assert cache["response"]["hits"] >= 1 and cache["graph_deterministic"] is True
    assert other[0] == 200 and other[1].get("x-sct-cache") is None  # another body: a miss


@pytest.mark.parametrize("graph", [
    {"name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
     "parameters": [_param("ratioA", 0.5, "FLOAT")], "children": [_mlp("a", 0), _mlp("b", 1)]},
    _gen(temperature=(0.8, "FLOAT")),
], ids=["random_abtest", "sampled_unit"])
def test_a_graph_that_is_not_deterministic_refuses_the_response_tiers(planes_on, graph):
    async def go():
        app = await _engine(graph)
        try:
            return app._resp_cache, app._sem_cache, await _stats_cache(app)
        finally:
            await app.close()

    resp, sem, cache = run(go())
    assert resp is None and sem is None
    assert cache["graph_deterministic"] is False
    assert "response" in cache and "node" in cache  # built, but not bound


def test_node_tier_serves_the_deterministic_children_of_a_random_router(planes_on):
    graph = {"name": "r", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
             "parameters": [_param("ratioA", 0.5, "FLOAT")],
             "children": [_mlp("a", 0), _mlp("b", 1)]}
    row = {"data": {"ndarray": [[0.25] * 16]}}

    async def go():
        app = await _engine(graph)
        try:
            comps = dict(app.service.walker.iter_components())
            replies = [await _send(app, row) for _ in range(12)]
            steps = {n: comps[n].queue.steps for n in ("a", "b")}
            more = [await _send(app, row) for _ in range(6)]
            steps_after = {n: comps[n].queue.steps for n in ("a", "b")}
            return replies + more, steps, steps_after, await _stats_cache(app)
        finally:
            await app.close()

    replies, steps, steps_after, cache = run(go())
    assert all(r[0] == 200 for r in replies)
    bodies = [json.loads(r[2]) for r in replies]
    paths = [b["meta"]["requestPath"] for b in bodies]
    served = {"a" if "a" in p else "b" for p in paths}
    assert served == {"a", "b"}  # the router still routes at random
    by_unit = {}
    for b, p in zip(bodies, paths):
        unit = "a" if "a" in p else "b"
        by_unit.setdefault(unit, []).append((p[unit], b["data"]))
    for unit, seen in by_unit.items():
        assert seen[0][0] != "cache"  # the first row computes
        assert all(path == "cache" for path, _ in seen[1:])  # repeats hit the node tier
        assert all(data == seen[0][1] for _, data in seen)
    assert steps_after == steps  # no device step for the repeats
    assert cache["node"]["hits"] == len(replies) - 2 and "response" in cache


def test_semantic_hit_on_the_tiny_preset(planes_on):
    async def go():
        app = await _engine(_gen(embed=("true", "BOOL")))
        try:
            m = _model(app)
            first = await _send(app, _body(max_new_tokens=6))
            app.service.response_cache.flush()
            steps = m.steps
            resent = await _send(app, _body(max_new_tokens=6))
            steps_after = m.steps
            return first, resent, steps, steps_after, await _stats_cache(app)
        finally:
            await app.close()

    first, resent, steps, steps_after, cache = run(go())
    assert resent[0] == 200 and resent[1].get("x-sct-cache") == "semantic"
    assert resent[2] == first[2] and steps_after == steps
    assert cache["semantic"]["hits"] == 1 and cache["semantic"]["last_similarity"] >= 0.95


# --------------------------------------------------------------------------
# C7: the semantic tier ignores every body field but the prompt (JAX)
# --------------------------------------------------------------------------

EMBED_SPEC = {"name": "emb", "graph": _gen(embed=("true", "BOOL"))}


def _jax_engine_replies(bodies):
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.engine.app import EngineApp as JaxEngine
    from seldon_core_tpu.engine.service import PredictionService as JaxService

    async def go():
        service = JaxService(JaxPredictorSpec.model_validate(EMBED_SPEC))
        client = TestClient(TestServer(JaxEngine(service).build()))
        await client.start_server()
        try:
            out = []
            for body in bodies:
                r = await client.post("/api/v0.1/predictions", json=body)
                out.append((r.status, r.headers.get("x-sct-cache"), await r.read()))
            return out
        finally:
            await client.close()

    return run(go())


def test_c7_the_jax_semantic_tier_serves_a_reply_made_with_other_options(monkeypatch):
    monkeypatch.setenv("SCT_SEMCACHE", "1")
    monkeypatch.setenv("ENGINE_WARMUP", "0")
    a, b, c = _body(max_new_tokens=4), _body(max_new_tokens=12), _body(max_new_tokens=4,
                                                                          adapter="beta")
    jax_a, jax_b, jax_c = _jax_engine_replies([a, b, c])
    tokens = lambda raw: json.loads(json.loads(raw)["strData"])["tokens"]  # noqa: E731
    # the JAX engine: B and C are served A's 4 tokens from the semantic tier
    assert jax_b[1] == jax_c[1] == "semantic"
    assert len(tokens(jax_b[2])) == 4 and jax_b[2] == jax_c[2] == jax_a[2]

    async def go():
        app = await _engine(_gen(embed=("true", "BOOL")))
        try:
            return [await _send(app, body) for body in (a, b, c, b)]
        finally:
            await app.close()

    port_a, port_b, port_c, port_b2 = run(go())
    assert port_a[0] == 200 and len(tokens(port_a[2])) == 4
    # the port: B misses and gets its 12 tokens; C names an adapter this
    # LoRA-off unit cannot serve (400), not another request's reply
    assert port_b[0] == 200 and port_b[1].get("x-sct-cache") is None
    assert len(tokens(port_b[2])) == 12 and tokens(port_b[2])[:4] == tokens(port_a[2])
    assert port_c[0] == 400 and port_c[1].get("x-sct-cache") is None
    assert port_b2[1].get("x-sct-cache") == "semantic" and port_b2[2] == port_b[2]


# --------------------------------------------------------------------------
# the usage meter over a mixed wave
# --------------------------------------------------------------------------


def test_meter_conserves_requests_tokens_and_device_seconds(planes_on, monkeypatch):
    """Completions, a hit, a queue shed, a deadline reap in the queue and one
    mid-decode: every request is counted once, decode tokens are the
    delivered ones (first tokens come from the prefill) plus the wasted
    ones, and the device seconds split over the blocks add up to them."""
    monkeypatch.setenv("SCT_QOS_PREDICTIVE", "0")
    monkeypatch.setenv("SCT_GEN_QUEUE_MAX", "3")

    async def go():
        app = await _engine(_gen(n_slots=(1, "INT")))
        try:
            m = _model(app)
            sched = dict(app.service.walker.iter_components())["gen"].scheduler
            gate, entered = threading.Event(), threading.Event()
            fetch = m.step_k_fetch

            def gated(handle):
                entered.set()
                gate.wait(10.0)
                return fetch(handle)

            m.step_k_fetch = gated
            blocks0 = m.block_seconds
            sent = []

            def send(body, headers=None):
                sent.append(body)
                return asyncio.ensure_future(_send(app, body, headers))

            holder = send(_body([1, 2, 3], max_new_tokens=20))  # holds the only slot
            await asyncio.to_thread(entered.wait, 10.0)
            queued = [send(_body([4, 5, i], max_new_tokens=3)) for i in range(2)]
            doomed = send(_body([6, 6], max_new_tokens=3), {qos.DEADLINE_HEADER: "30"})
            await _until(lambda: len(sched._waiting) == 3)
            shed = await send(_body([9, 9], max_new_tokens=3))  # the queue holds 3
            await asyncio.sleep(0.1)  # the 30 ms deadline passes in the queue
            gate.set()
            replies = [await holder] + [await q for q in queued] + [await doomed]
            hit = await send(_body([4, 5, 0], max_new_tokens=3))
            gate.clear()
            entered.clear()
            t_sent = time.monotonic()
            reaped = send(_body([3, 1, 4], max_new_tokens=30), {qos.DEADLINE_HEADER: "1500"})
            await asyncio.to_thread(entered.wait, 10.0)  # decoding: its first block is held
            await asyncio.sleep(max(0.0, t_sent + 1.6 - time.monotonic()))
            gate.set()
            reaped = await reaped
            return (sent, [shed, hit, reaped] + replies, m.block_seconds - blocks0,
                    METER.snapshot(), dict(sched.deadline_reaps))
        finally:
            await app.close()

    sent, replies, block_s, usage, reaps = run(go())
    shed, hit, reaped, holder, q0, q1, doomed = replies
    assert shed[0] == 429 and int(shed[1]["Retry-After"]) >= 1
    assert (holder[0], q0[0], q1[0], doomed[0], reaped[0]) == (200, 200, 200, 504, 504)
    assert hit[1].get("x-sct-cache") == "hit"
    assert reaps == {"generation-queue": 1, "decode": 1}
    tot = usage["total"]
    n = lambda f: int(tot.get(f, 0))  # noqa: E731
    assert n("requests_completed") + n("requests_shed") + n("requests_reaped") \
        + n("requests_cached") == len(sent)
    assert (n("requests_completed"), n("requests_shed"), n("requests_reaped"),
            n("requests_cached")) == (3, 1, 2, 1)
    delivered = sum(len(json.loads(json.loads(r[2])["strData"])["tokens"])
                    for r in (holder, q0, q1))
    # each started request's first token came from its prefill, not a block
    started = 3 + 1  # the completed ones and the one reaped mid-decode
    assert n("tokens_decode") + started == delivered + n("tokens_wasted")
    assert n("tokens_wasted") >= 1
    assert tot["device_s"] == pytest.approx(block_s, rel=0.01)


def test_an_embed_arriving_during_an_embed_wave_never_takes_a_slot():
    """The semantic tier embeds every request's prompt beside generation: an
    embed that arrives while a wave is being embedded waits for the next
    wave (it was once popped into the admissions and prefilled as a
    one-token generation)."""
    from seldon_core_tpu_torch.models.registry import build_generative_component

    comp = build_generative_component("llama", preset="tiny", n_slots=2, decode_block=4,
                                      embed=True, device="cpu")
    model, sched = comp.model, comp.scheduler
    gate, entered = threading.Event(), threading.Event()
    fetch = model.embed_fetch

    def held(vecs):
        if not entered.is_set():
            entered.set()
            gate.wait(10.0)
        return fetch(vecs)

    model.embed_fetch = held

    async def go():
        a = asyncio.create_task(sched.submit_embed(np.asarray([5, 9, 2], np.int32)))
        await asyncio.to_thread(entered.wait, 10.0)
        b = asyncio.create_task(sched.submit_embed(np.asarray([7, 7, 1], np.int32)))
        await asyncio.sleep(0.05)
        gate.set()
        out = await a, await b
        await comp.close()
        return out

    va, vb = run(go())
    assert va.shape == vb.shape == (model.cfg.hidden,)
    assert model.prefills == 0 and model.embeds == 2
