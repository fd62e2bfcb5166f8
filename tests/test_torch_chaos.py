"""The port's chaos plane and live drain on the CPU, against the JAX
package and inside the port.

* Plan parity: the same plan text and seed fire at the same arrivals in
  both packages' chaos planes (``hits``, ``only``, ``times`` and
  probabilistic rules), unknown sites, kinds and selectors give the same
  errors, a disarmed plane records nothing, and ``act`` tears, delays
  and raises as the JAX plane does, with one arrival a call.
* Drain bit identity: a generation drained mid-stream from one port
  scheduler and imported by a second that adopts the source's seed
  counter finishes, greedy, with the JAX package's uninterrupted tokens;
  seeded top-k, int8 KV and a salted adapter finish with the port's own
  uninterrupted tokens; the streaming hook sees each token once; the
  source's store is empty and its blocks are back.  A drain with no peer
  parks until it is lifted; a refused or torn migration re-parks and
  resumes locally, bit-identical.
* Over the port's engine: ``/admin/drain`` to a peer moves the live
  streams with equal tokens, one torn by ``disagg.handoff.send:torn:only=1``
  fails its migration and resumes locally with equal tokens, and
  ``/stats/chaos`` counts it; a repeated ``/admin/drain`` answers 409 with
  the drain's phase, ``/admin/undrain`` is refused while a drain
  quiesces, a parked drain resumes on ``/admin/undrain``; the peer's
  ``/disagg/import`` passes QoS admission and adopts the source's seed
  counter from ``x-sct-drain-seed``.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from seldon_core_tpu import chaos as jax_chaos
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import chaos
from seldon_core_tpu_torch.disagg.handoff import HandoffError, decode_handoff
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

run = asyncio.run

PROMPT = [5, 9, 2, 17, 3]
MAX_NEW = 24
LORA_KW = dict(lora_rank=2, lora_slots=4, lora_adapters="alpha,beta")


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    chaos.reset()
    jax_chaos.reset()


def _port(tiny, **kw):
    kw.setdefault("n_slots", 2)
    return GenerativeModel(tiny[2], tiny[3], decode_block=4, seq_impl="dense", device="cpu",
                           **kw)


# ------------------------------------------------------------ plan parity


def _fired(mod, plan, seed=0, site="gw.forward", n=32):
    mod.configure(plan, seed=seed)
    out = [mod.check(site) is not None for _ in range(n)]
    return out, mod.snapshot()


@pytest.mark.parametrize("plan,seed", [
    ("gw.forward:reset:hits=3", 0),
    ("gw.forward:reset:only=2", 0),
    ("gw.forward:reset:times=2", 0),
    ("gw.forward:reset:p=0.5", 7),
    ("gw.forward:reset:p=0.5", 8),
    ("gw.forward:timeout:p=0.3:times=4;gw.forward:slow:hits=20", 3),
    ("kube.request:reset", 0),  # a rule bound to another site: never fires here
])
def test_plans_fire_at_the_same_arrivals_as_the_jax_plane(plan, seed):
    got, want = _fired(chaos, plan, seed), _fired(jax_chaos, plan, seed)
    assert got == want
    fired, snap = got
    assert snap["enabled"] is True and snap["arrivals"]["gw.forward"] == 32
    if "only=2" in plan:
        assert fired[:4] == [False, True, False, False] and sum(fired) == 1
    if "hits=3" in plan:
        assert fired[:5] == [False, False, True, True, True]
    if "times=2" in plan:
        assert sum(fired) == 2
    if "p=0.5" in plan:
        assert any(fired) and not all(fired)


def test_a_seed_replays_its_fault_sequence():
    a, b = (_fired(chaos, "gw.forward:reset:p=0.5", 7)[0] for _ in range(2))
    assert a == b and _fired(chaos, "gw.forward:reset:p=0.5", 8)[0] != a


@pytest.mark.parametrize("plan", [
    "gw.fwrward:reset", "gw.forward:explode", "gw.forward:reset:hits=soon",
    "gw.forward:reset:when=3", "gw.forward", "gw.forward:reset:hits",
])
def test_bad_plans_give_the_jax_errors(plan):
    with pytest.raises(chaos.PlanError) as got:
        chaos.parse_plan(plan)
    with pytest.raises(jax_chaos.PlanError) as want:
        jax_chaos.parse_plan(plan)
    assert str(got.value) == str(want.value)


def test_sites_and_kinds_are_the_jax_planes():
    assert chaos.SITES == jax_chaos.SITES and chaos.KINDS == jax_chaos.KINDS
    chaos.configure("gw.forward:reset")
    with pytest.raises(chaos.PlanError, match="unregistered"):
        chaos.check("gw.not_a_site")


def test_a_disarmed_plane_is_inert_and_records_nothing():
    chaos.reset()
    assert chaos.ENABLED is False and chaos.check("gw.forward") is None
    chaos.fire("gw.forward")
    assert chaos.mangle("disagg.handoff.send", b"frame") == b"frame"
    assert run(chaos.act("disagg.handoff.send", b"frame")) == b"frame"
    assert chaos.snapshot() == {"enabled": False, "arrivals": {}, "fired": {}, "rules": []}
    chaos.configure("")
    assert chaos.ENABLED is False


def test_configure_from_env(monkeypatch):
    monkeypatch.setenv("SCT_CHAOS_PLAN", "disagg.prefix.pull:reset:only=1")
    monkeypatch.setenv("SCT_CHAOS_SEED", "5")
    chaos.configure_from_env()
    assert chaos.ENABLED and chaos.snapshot()["rules"] == [
        {"site": "disagg.prefix.pull", "kind": "reset", "fired": 0}]


@pytest.mark.parametrize("plan,expect", [
    ("disagg.handoff.send:torn:frac=0.5", b"x" * 5),
    ("disagg.handoff.send:torn:frac=0.01", b"x"),  # never empty
    ("disagg.handoff.send:drop", b"x" * 10),  # a kind act passes through
    ("disagg.handoff.send:reset", ConnectionResetError),
    ("disagg.handoff.send:timeout", TimeoutError),
    ("disagg.handoff.send:ioerror", OSError),
])
def test_act_interprets_a_kind_as_the_jax_plane(plan, expect):
    outs = []
    for mod in (chaos, jax_chaos):
        mod.configure(plan)
        try:
            outs.append(run(mod.act("disagg.handoff.send", b"x" * 10)))
        except OSError as e:
            outs.append(type(e))
        assert mod.snapshot()["arrivals"] == {"disagg.handoff.send": 1}  # one per call
    assert outs == [expect, expect]


def test_slow_delays_then_passes_through_and_mangle_tears():
    chaos.configure("gw.forward:slow:delay_ms=30;disagg.handoff.send:torn:frac=0.25")

    async def go():
        t0 = time.perf_counter()
        out = await chaos.act("gw.forward", b"payload")
        return out, time.perf_counter() - t0

    out, dt = run(go())
    assert out == b"payload" and dt >= 0.025
    assert chaos.mangle("disagg.handoff.send", b"y" * 8) == b"yy"
    assert chaos.snapshot()["fired"] == {"gw.forward": 1, "disagg.handoff.send": 1}


# ----------------------------------------------------- drain, scheduler side


def _uninterrupted(model, *, seed, temperature=0.0, adapter=None, sched_cls=GenerationScheduler):
    sched = sched_cls(model)
    sched._seed = seed
    kw = {"adapter": adapter} if adapter else {}

    async def go():
        try:
            return await sched.submit(np.asarray(PROMPT, np.int32), max_new_tokens=MAX_NEW,
                                      temperature=temperature, **kw)
        finally:
            await sched.close()

    return run(go()).tolist()


def _draining(model, seed, after=3):
    """A scheduler whose one request begins a drain after ``after`` tokens;
    returns it, its submit coroutine factory and the hook's tokens."""
    sched = GenerationScheduler(model)
    sched._seed = seed
    seen: list = []

    def hook(tok):
        seen.append(tok)
        if len(seen) == after:
            sched.drain_begin()

    def submit(**kw):
        return sched.submit(np.asarray(PROMPT, np.int32), max_new_tokens=MAX_NEW, on_token=hook,
                            **kw)

    return sched, submit, seen


def _drained(src_model, dst_model, *, seed, temperature=0.0, adapter=None):
    """Drain the source mid-stream, import the frame on a fresh peer
    scheduler that adopts the source's seed counter, relay the peer's
    tokens back; returns the one stream the client saw."""
    src, submit, seen = _draining(src_model, seed)
    kw = {"adapter": adapter} if adapter else {}
    free0 = src_model.free_block_count

    async def go():
        dst = GenerationScheduler(dst_model)
        try:
            task = asyncio.ensure_future(submit(temperature=temperature, **kw))
            assert await src.drain_wait_quiesced(30.0), "the drain never quiesced"
            pairs = src.drain_take()
            assert len(pairs) == 1
            assert src._suspend_store.bytes == 0 and src_model.free_block_count >= free0
            dst.adopt_seed(src._seed)
            for req, frame in pairs:
                p = decode_handoff(frame)
                out = await dst.submit_imported(
                    p["prompt"], first_token=int(p["first_token"]), k=p["k"], v=p["v"],
                    max_new_tokens=int(p["max_new_tokens"]),
                    temperature=float(p.get("temperature", 0.0)), k_scale=p.get("k_scale"),
                    v_scale=p.get("v_scale"), adapter=p.get("adapter"))
                src.complete_migrated(req, [int(t) for t in out])
            src.drain_finish()
            return (await asyncio.wait_for(task, 30)).tolist()
        finally:
            await asyncio.wait_for(src.close(), 20)
            await asyncio.wait_for(dst.close(), 20)

    got = run(go())
    assert seen == got  # ONE stream across the migration
    assert src.drains == 1 and src.drained_out == 1
    assert src_model.free_block_count == src_model.kv_blocks - 1
    return got


def test_drained_greedy_equals_the_jax_uninterrupted_run(tiny):
    cfg, jparams = tiny[:2]
    want = _uninterrupted(JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4), seed=123,
                          sched_cls=JaxScheduler)
    assert _drained(_port(tiny), _port(tiny), seed=123) == want


@pytest.mark.parametrize("case", ["top_k", "int8", "adapter"])
def test_drained_equals_the_uninterrupted_run(tiny, case):
    kw, run_kw = {}, {"seed": 4242}
    if case == "top_k":
        kw, run_kw["temperature"] = {"top_k": 4}, 0.9
    elif case == "int8":
        kw = {"kv_cache_dtype": "int8"}
    else:
        kw, run_kw["adapter"] = LORA_KW, "alpha"
    want = _uninterrupted(_port(tiny, **kw), **run_kw)
    assert _drained(_port(tiny, **kw), _port(tiny, **kw), **run_kw) == want
    if case == "adapter":  # the salt was live
        assert want != _uninterrupted(_port(tiny, **LORA_KW), seed=4242)


@pytest.mark.parametrize("path", ["no_peer", "aborted", "torn"])
def test_a_failed_or_absent_migration_resumes_locally(tiny, path):
    want = _uninterrupted(_port(tiny), seed=123)
    sched, submit, seen = _draining(_port(tiny), 123)
    if path == "torn":
        chaos.configure("disagg.handoff.send:torn:frac=0.5")

    async def go():
        try:
            task = asyncio.ensure_future(submit())
            assert await sched.drain_wait_quiesced(30.0)
            assert sched._draining and len(sched._suspended) == 1
            if path == "no_peer":  # parked, not progressing, until lifted
                n = len(seen)
                await asyncio.sleep(0.05)
                assert not task.done() and len(seen) == n
            else:
                pairs = sched.drain_take()
                if path == "torn":
                    torn = await chaos.act("disagg.handoff.send", pairs[0][1])
                    with pytest.raises((HandoffError, ValueError)):
                        decode_handoff(torn)  # the peer refuses it
                sched.drain_abort(pairs)  # the original frame survives
                assert len(sched._suspended) == 1
            sched.drain_finish()
            return (await asyncio.wait_for(task, 30)).tolist()
        finally:
            await asyncio.wait_for(sched.close(), 20)

    got = run(go())
    assert got == want and seen == got
    assert sched.suspends == 1 and sched._suspend_store.bytes == 0
    if path == "torn":
        assert chaos.snapshot()["fired"]["disagg.handoff.send"] == 1


def test_an_idle_drain_quiesces_at_once(tiny):
    sched = GenerationScheduler(_port(tiny))

    async def go():
        sched.drain_begin()
        assert await sched.drain_wait_quiesced(1.0)
        assert sched.drain_take() == [] and sched.packing_snapshot()["draining"]
        sched.drain_finish()
        out = await sched.submit(np.asarray(PROMPT, np.int32), max_new_tokens=4)
        await sched.close()
        return out

    assert len(run(go())) == 4


# --------------------------------------------------------- over the engine


def _graph(**extra):
    params = {"family": ("llama", "STRING"), "preset": ("tiny", "STRING"),
              "n_slots": (2, "INT"), "decode_block": (4, "INT"), **extra}
    return PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": [{"name": k, "value": str(v), "type": t} for k, (v, t) in params.items()],
    }})


def _call(port, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _gen(port, prompt, max_new):
    code, body = _call(port, "/api/v0.1/predictions", {
        "strData": json.dumps({"tokens": prompt, "max_new_tokens": max_new})})
    assert code == 200, body
    return json.loads(body["strData"])["tokens"]


async def _engines(n):
    apps = []
    for _ in range(n):
        app = EngineApp(PredictionService(_graph(), device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        apps.append(app)
    return apps


def _slow_blocks(app, seconds=0.05):
    """Each fetched decode block of ``app``'s unit takes ``seconds`` more,
    so a stream stays live long enough to be drained."""
    model = app.service.walker.component.model
    fetch = model.step_k_fetch

    def slow(*a, **kw):
        time.sleep(seconds)
        return fetch(*a, **kw)

    model.step_k_fetch = slow


async def _live(app, prompts, max_new):
    """Send ``prompts`` to ``app`` together and wait until they decode."""
    model = app.service.walker.component.model
    blocks0 = model.decode_blocks
    tasks = [asyncio.ensure_future(asyncio.to_thread(_gen, app.port, p, max_new))
             for p in prompts]
    for _ in range(2000):
        if model.decode_blocks - blocks0 >= 2:
            return tasks
        await asyncio.sleep(0.005)
    raise AssertionError("the streams never went live")


PROMPTS = [[5, 9, 2, 17, 3], [30, 7, 1]]
LIVE_NEW = 48


def test_engine_drains_to_a_peer_and_a_torn_frame_resumes_locally(tiny):
    async def go():
        src, peer = await _engines(2)
        try:
            want = [await asyncio.to_thread(_gen, peer.port, p, LIVE_NEW) for p in PROMPTS]
            qos0 = peer.qos.snapshot()["admitted_total"]
            seeds = {"adopted": []}
            src_sched = src.service.walker.component.scheduler
            peer_sched = peer.service.walker.component.scheduler
            take, adopt = src_sched.drain_take, peer_sched.adopt_seed

            def logged_take():
                seeds["source"] = src_sched._seed
                return take()

            def logged_adopt(seed):
                seeds["adopted"].append(seed)
                adopt(seed)

            src_sched.drain_take, peer_sched.adopt_seed = logged_take, logged_adopt
            _slow_blocks(src)
            tasks = await _live(src, PROMPTS, LIVE_NEW)
            chaos.configure("disagg.handoff.send:torn:only=1")
            drain = await asyncio.to_thread(
                _call, src.port, "/admin/drain", {"peer": f"127.0.0.1:{peer.port}"})
            got = [await t for t in tasks]
            out = {"want": want, "got": got, "drain": drain,
                   "chaos": (await asyncio.to_thread(_call, src.port, "/stats/chaos"))[1],
                   "peer": (await asyncio.to_thread(_call, peer.port, "/stats/disagg"))[1],
                   "admitted": peer.qos.snapshot()["admitted_total"] - qos0,
                   "seeds": seeds}
            model = src.service.walker.component.model
            out["free"] = (model.free_block_count, model.kv_blocks - 1)
            out["packing"] = (await asyncio.to_thread(_call, src.port, "/stats/breakdown"))[1][
                "generation"][model.name]["packing"]
            return out
        finally:
            for app in (src, peer):
                await app.close()

    out = run(go())
    code, drain = out["drain"]
    assert code == 200 and drain["quiesced"] and drain["peer"]
    assert (drain["migrated"], drain["failed"]) == (1, 1)  # the torn one failed
    assert out["got"] == out["want"]  # migrated and resumed alike: equal tokens
    assert out["chaos"]["chaos"]["fired"] == {"disagg.handoff.send": 1}
    assert out["chaos"]["chaos"]["arrivals"] == {"disagg.handoff.send": 2}
    assert out["peer"]["disagg"]["imports_failed"] == 1  # the torn frame: 400
    assert out["peer"]["disagg"]["imports_ok"] == 1
    assert out["admitted"] == 2  # each /disagg/import passed admission
    # the migrated frame carried the source's seed counter and the peer took it
    assert out["seeds"]["adopted"] == [out["seeds"]["source"]]
    assert out["free"][0] == out["free"][1]
    pk = out["packing"]
    assert pk["drains"] == 1 and pk["drained_out"] == 2 and not pk["draining"]
    assert pk["suspend_store"]["bytes"] == 0 and pk["resumes"] == 1


def test_engine_drain_is_idempotent_and_undrain_waits_for_it(tiny):
    async def go():
        app, = await _engines(1)
        try:
            want = await asyncio.to_thread(_gen, app.port, PROMPTS[0], LIVE_NEW)
            sched = app.service.walker.component.scheduler
            _slow_blocks(app)
            task, = await _live(app, PROMPTS[:1], LIVE_NEW)
            gate, entered = threading.Event(), threading.Event()
            orig = sched.drain_wait_quiesced

            async def gated(timeout_s):
                entered.set()
                await asyncio.to_thread(gate.wait)
                return await orig(timeout_s)

            sched.drain_wait_quiesced = gated
            first = asyncio.ensure_future(asyncio.to_thread(_call, app.port, "/admin/drain", {}))
            await asyncio.to_thread(entered.wait, 10)
            out = {"repeat": await asyncio.to_thread(_call, app.port, "/admin/drain", {}),
                   "early_undrain": await asyncio.to_thread(_call, app.port, "/admin/undrain",
                                                            {})}
            gate.set()
            out["first"] = await first
            sched.drain_wait_quiesced = orig
            out["parked_repeat"] = await asyncio.to_thread(_call, app.port, "/admin/drain", {})
            await asyncio.sleep(0.1)
            out["held"] = not task.done()
            out["undrain"] = await asyncio.to_thread(_call, app.port, "/admin/undrain", {})
            out["got"] = await task
            out["cycle"] = [await asyncio.to_thread(_call, app.port, p, {})
                            for p in ("/admin/drain", "/admin/undrain", "/admin/undrain")]
            out["get"] = await asyncio.to_thread(_call, app.port, "/admin/drain")
            out["want"] = want
            return out
        finally:
            await app.close()

    out = run(go())
    code, body = out["repeat"]
    assert code == 409 and body["drain"]["phase"] == "quiescing"
    assert "elapsed_ms" in body["drain"]
    code, body = out["early_undrain"]
    assert code == 409 and "in flight" in body["status"]["info"]
    code, body = out["first"]
    assert code == 200 and body["quiesced"] and body["peer"] is None and body["parked"] == 1
    code, body = out["parked_repeat"]
    assert code == 409 and body["drain"]["phase"] == "parked" and body["drain"]["parked"] == 1
    assert out["held"]  # parked until the undrain
    assert out["undrain"] == (200, {"draining": False, "resuming": True})
    assert out["got"] == out["want"]  # resumed in place, bit-exactly
    assert [c for c, _ in out["cycle"]] == [200, 200, 409]
    assert "not draining" in out["cycle"][2][1]["status"]["info"]
    assert out["get"][0] == 405
