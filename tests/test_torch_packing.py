"""Chip packing in the port on the CPU: the device arbiter, the suspend
store and the host ledger against the JAX package, and preemption with
suspend and resume inside the port.

* The port's :class:`DeviceArbiter` and the JAX package's, driven through
  the same scripts over the same stub schedulers (pressures, classes,
  arrivals), give the same grant order, preemptions, resumes and
  snapshots: the sole-tenant fast path, rotation, interactive before
  batch, pressure within a class, hysteresis, ``poll`` off grant edges,
  an unregister resolving waiters and victims, name collisions.
* The port's :class:`SuspendStore` and the JAX package's give the same
  results and snapshots for the same operations.
* A generation suspended mid-stream (its KV exported into the suspend
  store, its blocks freed) and resumed gives, greedy, the JAX package's
  uninterrupted tokens for the same float32 weights; inside the port,
  greedy, seeded top-k, int8 KV, a salted adapter and prefix reuse give
  the port's uninterrupted tokens bit for bit, with no block leaked and
  the store empty after the resume.
* Packed schedulers: a hot interactive co-tenant preempts a batch
  scheduler and its cooling resumes it (``arbiter-yield`` counted); two
  schedulers interleave whole blocks with every device call under the
  caller's grant; queue pressure decays; ``register_packed`` (a draft
  model too); closing a component releases its host-ledger bytes.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.cache import tiers as jax_tiers
from seldon_core_tpu.executor import arbiter as jax_arbiter
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.cache import tiers
from seldon_core_tpu_torch.executor import arbiter
from seldon_core_tpu_torch.executor.generation import (
    GenerationScheduler,
    GenerativeComponent,
    GenerativeModel,
)
from seldon_core_tpu_torch.executor.memory import MemoryManager, host_memory
from seldon_core_tpu_torch.graph.spec import Implementation
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

run = asyncio.run

PROMPT = [5, 9, 2, 17, 3]
MAX_NEW = 24
LORA_KW = dict(lora_rank=2, lora_slots=4, lora_adapters="alpha,beta")
REUSE_PROMPT = list(range(7, 39)) + [50]  # 2 full 16-token blocks + a suffix


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _port(tiny, **kw):
    kw.setdefault("n_slots", 2)
    return GenerativeModel(tiny[2], tiny[3], decode_block=4, seq_impl="dense", device="cpu",
                           **kw)


# ---------------------------------------------------------------- arbiter


class _Stub:
    """A scheduler stand-in: queue pressure in SECONDS and the verbs the
    arbiter calls, logged."""

    def __init__(self, name, log, pressure=0.0):
        self.name, self.log, self.pressure = name, log, pressure

    def queue_pressure(self):
        return self.pressure

    def request_preempt(self):
        self.log.append(("preempt", self.name))

    def request_resume(self):
        self.log.append(("resume", self.name))


async def _grant(arb, name, log):
    await arb.acquire(name)
    log.append(("granted", name))


async def _sole_tenant(mod, log):
    arb = mod.DeviceArbiter()
    arb.register("a", scheduler=_Stub("a", log))
    await arb.acquire("a")  # returns at once, parks nothing
    log.append(("contended", arb.contended("a")))
    arb.release("a")
    arb.release("a")  # idempotent
    await arb.acquire("ghost")  # unregistered: a no-op
    return arb


async def _rotate(mod, log):
    arb = mod.DeviceArbiter()
    for n in ("a", "b"):
        arb.register(n, scheduler=_Stub(n, log))
    await _grant(arb, "a", log)
    t = asyncio.ensure_future(_grant(arb, "b", log))
    await asyncio.sleep(0)
    log.append(("parked", not t.done(), arb.contended("a"), arb.contended("b")))
    arb.release("a")
    await t
    log.append(("holder", arb.snapshot()["holder"]))
    arb.release("b")
    return arb


async def _interactive_first(mod, log):
    arb = mod.DeviceArbiter()
    arb.register("hold", scheduler=_Stub("hold", log))
    arb.register("bat", scheduler=_Stub("bat", log), priority="batch")
    arb.register("inter", scheduler=_Stub("inter", log), priority="interactive")
    await _grant(arb, "hold", log)
    t_bat = asyncio.ensure_future(_grant(arb, "bat", log))
    await asyncio.sleep(0)  # batch parks first
    t_int = asyncio.ensure_future(_grant(arb, "inter", log))
    await asyncio.sleep(0)
    arb.release("hold")
    await t_int  # ... but interactive is granted first
    arb.release("inter")
    await t_bat
    arb.release("bat")
    return arb


async def _pressure_order(mod, log):
    arb = mod.DeviceArbiter()
    arb.register("hold", scheduler=_Stub("hold", log))
    arb.register("calm", scheduler=_Stub("calm", log, 0.01))
    arb.register("hot", scheduler=_Stub("hot", log, 0.2))
    await _grant(arb, "hold", log)
    t_calm = asyncio.ensure_future(_grant(arb, "calm", log))
    await asyncio.sleep(0)
    t_hot = asyncio.ensure_future(_grant(arb, "hot", log))
    await asyncio.sleep(0)
    arb.release("hold")
    await t_hot  # the worst pressure first, despite arriving later
    arb.release("hot")
    await t_calm
    arb.release("calm")
    return arb


async def _hysteresis(mod, log):
    arb = mod.DeviceArbiter()
    inter = _Stub("inter", log, 0.3)  # 300 ms >= the 250 ms band
    arb.register("inter", scheduler=inter, slo_ms=250.0)
    arb.register("bat", scheduler=_Stub("bat", log), priority="batch")
    for pressure in (0.3, 0.2, 0.1, 0.4):  # over, inside the band, under, over
        inter.pressure = pressure
        await _grant(arb, "inter", log)
        arb.release("inter")
        log.append(("counts", arb.preemptions, arb.resumes))
    return arb


async def _poll(mod, log):
    arb = mod.DeviceArbiter()
    inter = _Stub("inter", log, 10.0)
    arb.register("inter", scheduler=inter, slo_ms=50.0)
    arb.register("bat", scheduler=_Stub("bat", log), priority="batch")
    arb.poll()
    inter.pressure = 0.0  # the interactive side goes quiet: no grant edge
    arb.poll()
    return arb


async def _unregister(mod, log):
    arb = mod.DeviceArbiter()
    arb.register("inter", scheduler=_Stub("inter", log, 10.0), slo_ms=50.0)
    arb.register("bat", scheduler=_Stub("bat", log), priority="batch")
    arb.poll()
    await _grant(arb, "inter", log)
    t = asyncio.ensure_future(_grant(arb, "bat", log))
    await asyncio.sleep(0)
    log.append(("parked", not t.done()))
    arb.unregister("inter")  # below two registrants: waiter resolved, victim resumed
    await t
    arb.release("bat")
    return arb


async def _collision(mod, log):
    arb = mod.DeviceArbiter()
    keys = [arb.register("llama:tiny", scheduler=_Stub(f"s{i}", log)) for i in range(3)]
    log.append(("keys", keys))
    arb.register("x", scheduler=_Stub("x", log), priority="batch", slo_ms=99.0)
    arb.unregister(keys[1])
    return arb


SCRIPTS = {"sole_tenant": _sole_tenant, "rotate": _rotate,
           "interactive_first": _interactive_first, "pressure_order": _pressure_order,
           "hysteresis": _hysteresis, "poll": _poll, "unregister": _unregister,
           "collision": _collision}
EXPECT = {
    "sole_tenant": [("contended", False)],
    "rotate": [("granted", "a"), ("parked", True, True, False), ("granted", "b"),
               ("holder", "b")],
    "interactive_first": [("granted", "hold"), ("granted", "inter"), ("granted", "bat")],
    "pressure_order": [("granted", "hold"), ("granted", "hot"), ("granted", "calm")],
    # the policy runs at the grant edge, before the grant lands
    "hysteresis": [("preempt", "bat"), ("granted", "inter"), ("counts", 1, 0),
                   ("granted", "inter"), ("counts", 1, 0),
                   ("resume", "bat"), ("granted", "inter"), ("counts", 1, 1),
                   ("preempt", "bat"), ("granted", "inter"), ("counts", 2, 1)],
    "poll": [("preempt", "bat"), ("resume", "bat")],
    "unregister": [("preempt", "bat"), ("granted", "inter"), ("parked", True),
                   ("resume", "bat"), ("granted", "bat")],
    "collision": [("keys", ["llama:tiny", "llama:tiny#2", "llama:tiny#3"])],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_arbiter_decisions_equal_the_jax_arbiter(script):
    traces = {}
    for name, mod in (("port", arbiter), ("jax", jax_arbiter)):
        log: list = []
        arb = run(SCRIPTS[script](mod, log))
        traces[name] = (log, arb.snapshot(), arb.grants, arb.preemptions, arb.resumes)
    assert traces["port"] == traces["jax"]
    assert traces["port"][0] == EXPECT[script]
    snap = traces["port"][1]
    assert set(snap) == {"multi", "holder", "waiting", "grants", "preemptions", "resumes",
                         "deployments"}
    if script == "collision":
        dep = snap["deployments"]["x"]
        assert dep["priority"] == qos.PRIO_BATCH and dep["slo_ms"] == 99.0
        assert not dep["preempted"] and "llama:tiny#2" not in snap["deployments"]
    if script == "sole_tenant":
        # below two registrants the holder mark is bookkeeping only (the
        # JAX arbiter's too): nothing ever waits on it
        assert snap["multi"] is False and snap["holder"] == "ghost"


def test_arbiter_knobs_read_the_environment(monkeypatch):
    monkeypatch.setenv("SCT_PACK_PREEMPT", "2.0")
    monkeypatch.setenv("SCT_PACK_RESUME", "0.25")
    monkeypatch.setenv("SCT_PACK_SLO_MS", "80")
    arb = arbiter.DeviceArbiter()
    assert (arb.high, arb.low) == (2.0, 0.25)
    arb.register("a", scheduler=_Stub("a", []))
    assert arb.snapshot()["deployments"]["a"]["slo_ms"] == 80.0
    monkeypatch.delenv("SCT_PACK_SLO_MS")
    arb.register("b", scheduler=_Stub("b", []))
    assert arb.snapshot()["deployments"]["b"]["slo_ms"] == 250.0


# ---------------------------------------------------------- suspend store


def _store_ops(mod):
    seen: list = []
    st = mod.SuspendStore(100, on_bytes=seen.append)
    out = [st.put("a", b"x" * 60), st.bytes, len(st),
           st.put("b", b"y" * 50),  # over the budget: refused, nothing evicted
           st.put("a", b"z"),  # a key collision: refused
           st.put("c", b"w" * 40), st.snapshot(),
           st.take("a"), st.take("a"), st.bytes]
    st.flush()
    return out, seen, st.snapshot()


def test_suspend_store_equals_the_jax_store():
    got, want = _store_ops(tiers), _store_ops(jax_tiers)
    assert got == want
    out, seen, final = got
    assert out[:6] == [True, 60, 1, False, False, True]
    assert out[6] == {"records": 2, "bytes": 100, "budget_bytes": 100, "puts": 2,
                      "takes": 0, "rejected": 2}
    assert out[7:] == [b"x" * 60, None, 40]
    assert seen == [60, 100, 40, 0] and final["records"] == 0


# ------------------------------------------------------- suspend and resume


def _uninterrupted(model, *, seed, prompt=PROMPT, temperature=0.0, adapter=None,
                   sched_cls=GenerationScheduler):
    sched = sched_cls(model)
    sched._seed = seed
    kw = {"adapter": adapter} if adapter else {}

    async def go():
        try:
            return await sched.submit(np.asarray(prompt, np.int32), max_new_tokens=MAX_NEW,
                                      temperature=temperature, **kw)
        finally:
            await sched.close()

    return run(go()).tolist()


def _suspended(model, *, seed, prompt=PROMPT, temperature=0.0, adapter=None, after=3):
    """The same request preempted after ``after`` tokens and resumed once
    its record is parked; returns its tokens, what its hook saw and the
    scheduler."""
    sched = GenerationScheduler(model)
    sched._seed = seed
    kw = {"adapter": adapter} if adapter else {}
    seen: list = []

    def hook(tok):
        seen.append(tok)
        if len(seen) == after:
            sched.request_preempt()

    free0 = model.free_block_count  # a reuse chain keeps blocks across requests

    async def go():
        try:
            task = asyncio.ensure_future(sched.submit(
                np.asarray(prompt, np.int32), max_new_tokens=MAX_NEW, temperature=temperature,
                on_token=hook, **kw))
            for _ in range(20_000):
                if sched._suspended:
                    break
                await asyncio.sleep(0.001)
            assert sched._suspended, "the preemption never suspended the slot"
            assert model.free_block_count >= free0  # the parked stream holds no block
            store = sched._suspend_store
            assert store.bytes > 0 and len(store) == 1
            assert model.memory_snapshot()["host"]["suspend_dram"] == store.bytes
            n = len(seen)
            await asyncio.sleep(0.02)
            assert not task.done() and len(seen) == n  # parked, not progressing
            sched.request_resume()
            out = await task
            assert sched.suspends == 1 and sched.resumes == 1
            assert store.bytes == 0 and len(store) == 0
            return out.tolist()
        finally:
            await sched.close()

    out = run(go())
    assert seen == out  # the hook saw each token once, in order
    return out, sched


def test_suspended_greedy_equals_the_jax_uninterrupted_run(tiny):
    cfg, jparams = tiny[:2]
    want = _uninterrupted(JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4),
                          seed=123, sched_cls=JaxScheduler)
    model = _port(tiny)
    got, sched = _suspended(model, seed=123)
    assert got == want
    assert model.free_block_count == model.kv_blocks - 1  # no leak
    assert sched.overlap_breaks["arbiter-yield"] >= 1
    assert model.memory_snapshot()["host"] == {"suspend_dram": 0}


@pytest.mark.parametrize("case", ["greedy", "top_k", "int8", "adapter", "reuse"])
def test_suspended_equals_the_uninterrupted_run(tiny, case):
    kw, run_kw = {}, {"seed": 4242}
    if case == "top_k":
        kw, run_kw["temperature"] = {"top_k": 4}, 0.9
    elif case == "int8":
        kw = {"kv_cache_dtype": "int8"}
    elif case == "adapter":
        kw, run_kw["adapter"] = LORA_KW, "alpha"
    elif case == "reuse":
        kw, run_kw["prompt"] = {"prefix_reuse": True}, REUSE_PROMPT
    want_model, model = _port(tiny, **kw), _port(tiny, **kw)
    if case == "reuse":  # the first request of each seeds the chain
        first = _uninterrupted(want_model, seed=31, prompt=REUSE_PROMPT)
        assert _uninterrupted(model, seed=31, prompt=REUSE_PROMPT) == first
    want = _uninterrupted(want_model, **run_kw)
    got, _ = _suspended(model, **run_kw)
    assert got == want
    if case == "reuse":
        assert model.prefills_reused >= 1
    else:
        assert model.free_block_count == model.kv_blocks - 1
    if case == "adapter":  # the salt was live
        assert got != _uninterrupted(_port(tiny, **LORA_KW), seed=4242)


def test_store_refusal_keeps_the_slot_running(tiny, monkeypatch):
    monkeypatch.setenv("SCT_PACK_SUSPEND_GB", "1e-9")  # ~1 byte: every record refused
    want = _uninterrupted(_port(tiny), seed=5)
    model = _port(tiny)
    sched = GenerationScheduler(model)
    sched._seed = 5
    seen: list = []

    def hook(tok):
        seen.append(tok)
        if len(seen) == 3:
            sched.request_preempt()

    async def go():
        try:
            out = await sched.submit(np.asarray(PROMPT, np.int32), max_new_tokens=MAX_NEW,
                                     on_token=hook)
            return out.tolist()
        finally:
            await sched.close()

    assert run(go()) == want  # refused: ran to its end resident
    assert sched.suspends == 0 and sched.suspend_rejected >= 1


def test_deadline_reaps_a_suspended_request(tiny):
    model = _port(tiny)
    sched = GenerationScheduler(model)
    seen: list = []

    def hook(tok):
        seen.append(tok)
        if len(seen) == 3:
            sched.request_preempt()

    async def go():
        try:
            task = asyncio.ensure_future(sched.submit(
                np.asarray(PROMPT, np.int32), max_new_tokens=MAX_NEW, on_token=hook))
            for _ in range(20_000):
                if sched._suspended:
                    break
                await asyncio.sleep(0.001)
            # its deadline passes while it is parked: the park tick reaps it
            sched._suspended[0]["req"].deadline = time.monotonic() - 1.0
            with pytest.raises(qos.DeadlineExceeded, match="suspended"):
                await asyncio.wait_for(task, 10)
            return sched._suspend_store.snapshot()
        finally:
            await sched.close()

    snap = run(go())
    assert snap["bytes"] == 0 and snap["takes"] == 1
    assert sched.deadline_reaps["suspended"] == 1
    assert model.free_block_count == model.kv_blocks - 1


# -------------------------------------------------------- packed schedulers


def test_arbiter_preempts_and_resumes_a_batch_scheduler(tiny):
    want = _uninterrupted(_port(tiny), seed=55)
    model = _port(tiny)
    arb = arbiter.DeviceArbiter()
    sched = GenerationScheduler(model)
    sched._seed = 55
    hot = _Stub("hot", [], pressure=10.0)

    async def go():
        try:
            sched.attach_arbiter(arb, priority=qos.PRIO_BATCH)
            arb.register("hot", scheduler=hot, priority="interactive", slo_ms=50.0)
            task = asyncio.ensure_future(sched.submit(np.asarray(PROMPT, np.int32),
                                                      max_new_tokens=MAX_NEW))
            for _ in range(20_000):
                if sched._suspended:
                    break
                await asyncio.sleep(0.001)
            assert sched._suspended and sched._preempt, "the arbiter never preempted"
            snap = sched.packing_snapshot()
            assert snap["preempted"] and snap["suspended"] == 1
            hot.pressure = 0.0  # the burst is over: the park tick's poll resumes it
            out = await task
            assert not sched._preempt and sched.suspends == 1 and sched.resumes == 1
            return out.tolist()
        finally:
            await sched.close()

    assert run(go()) == want
    assert arb.preemptions == 1 and arb.resumes == 1
    assert model.name not in arb.snapshot()["deployments"]  # close unregistered it


def test_two_schedulers_interleave_under_the_grant(tiny):
    """Two co-resident deployments (their own models, pools and graphs)
    complete under one arbiter; every device call each makes runs while
    it holds the grant; the holder yields its overlap to a waiter."""
    models = [_port(tiny), _port(tiny)]
    arb = arbiter.DeviceArbiter()
    scheds = [GenerationScheduler(m) for m in models]
    scheds[0]._seed, scheds[1]._seed = 1, 2
    outside: list = []

    def guard(model, sched, name):
        fn = getattr(model, name)

        def call(*a, **kw):
            if arb.snapshot()["holder"] != sched._arb_key:
                outside.append((model.name, name))
            return fn(*a, **kw)

        setattr(model, name, call)

    for m, s in zip(models, scheds):
        for name in ("admit_dispatch", "step_k_dispatch", "step_k_continue", "step_k_fetch"):
            guard(m, s, name)

    async def go():
        try:
            scheds[0].attach_arbiter(arb, priority=qos.PRIO_INTERACTIVE)
            scheds[1].attach_arbiter(arb, priority=qos.PRIO_BATCH)
            return [o.tolist() for o in await asyncio.gather(*(
                s.submit(np.asarray(PROMPT, np.int32), max_new_tokens=20) for s in scheds))]
        finally:
            for s in scheds:
                await s.close()

    out = run(go())
    assert outside == []
    assert arb.grants >= 2 and arb.snapshot()["holder"] is None
    assert sum(s.overlap_breaks["arbiter-yield"] for s in scheds) >= 1
    want = _uninterrupted(_port(tiny), seed=1)[:20]
    assert out == [want, want]  # greedy: each as on a sole card
    for m in models:  # one host sync per block, no block leaked
        assert m.host_syncs == m.decode_blocks and m.free_block_count == m.kv_blocks - 1


def test_queue_pressure_decays_and_skips_resumed_records(tiny):
    sched = GenerationScheduler(_port(tiny))
    sched._qwait_ewma = 1.0
    sched._qwait_stamp = time.perf_counter()
    p0 = sched.queue_pressure()
    sched._qwait_stamp = time.perf_counter() - 2.0  # two half-lives ago
    assert p0 > 0.9 and sched.queue_pressure() < 0.3

    class _Req:
        t0 = time.perf_counter() - 5.0
        imported = {"resumed": True}

    sched._note_queue_wait(_Req())  # a resumed record's wait is its suspension
    assert sched._qwait_ewma == 1.0
    _Req.imported = None
    sched._note_queue_wait(_Req())
    assert sched._qwait_ewma == pytest.approx(0.8 + 0.2 * 5.0, rel=1e-3)
    run(sched.close())


def test_component_register_packed(tiny):
    model = _port(tiny)
    comp = GenerativeComponent(model, pack_class="batch", pack_slo_ms=75.0)
    arb = arbiter.DeviceArbiter()
    comp.register_packed(arb)
    dep = arb.snapshot()["deployments"][model.name]
    assert dep["priority"] == qos.PRIO_BATCH and dep["slo_ms"] == 75.0
    comp.register_packed(arbiter.DeviceArbiter())  # a second call: no re-register
    assert comp.scheduler._arbiter is arb
    run(comp.close())
    assert model.name not in arb.snapshot()["deployments"]


def test_sct_pack_attaches_a_sole_deployment(tiny, monkeypatch):
    monkeypatch.setenv("SCT_PACK", "1")
    comp = GenerativeComponent(_port(tiny))
    try:
        assert comp.scheduler._arbiter is arbiter.get_arbiter()
        assert not arbiter.get_arbiter().multi  # sole: the fast path
    finally:
        run(comp.close())
    assert comp.model.name not in arbiter.get_arbiter().snapshot()["deployments"]


def test_packed_draft_speculation_raises_by_name(tiny):
    # a packed draft model once raised here; every packing route
    # (register_packed, SCT_PACK=1, the engine's co-resident boot) goes
    # through attach_arbiter, which now registers its draft prefills as a
    # second, batch-class registrant (tests/test_torch_draft_packing.py)
    model = _port(tiny, spec_draft=2, spec_method="draft", spec_draft_model="truncate:1")
    comp = GenerativeComponent(model, pack_class="batch")
    arb = arbiter.DeviceArbiter()
    try:
        comp.register_packed(arb)
        assert comp.scheduler._arbiter is arb and model.defer_draft_prefill
        deps = arb.snapshot()["deployments"]
        assert deps[model.name]["priority"] == qos.PRIO_BATCH
        assert deps[f"{model.name}/draft"]["priority"] == qos.PRIO_BATCH
    finally:
        run(comp.close())
    assert arb.snapshot()["deployments"] == {} and not model.defer_draft_prefill


@pytest.mark.parametrize("name,value,check", [
    ("pack_class", "batch", lambda c: c.pack_class == qos.PRIO_BATCH),
    ("pack_slo_ms", 75, lambda c: c.pack_slo_ms == 75.0 and c.pack_class is None),
])
def test_pack_parameters_are_served(name, value, check):
    comp = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", name: value},
                          device="cpu")
    try:
        assert check(comp) and comp.scheduler._arbiter is None  # registered at boot only
    finally:
        run(comp.close())


# ------------------------------------------------------- the host ledger


def test_close_releases_host_ledger_bytes(tiny):
    model = _port(tiny)
    model.note_suspend_bytes(4096)
    model._note_dram_bytes(2048)
    owner = model._mem_key
    assert host_memory().snapshot()["owners"][owner] == {"suspend_dram": 4096,
                                                         "prefix_dram": 2048}
    model.release_memory()
    assert owner not in host_memory().snapshot()["owners"]


def test_build_close_twice_under_an_enforced_budget(tiny):
    """Host-ledger bytes must not outlive a close, nor device-ledger ones."""
    probe = _port(tiny, memory=MemoryManager(budget_bytes=1 << 40))
    need = probe.memory.reserved_bytes
    probe.release_memory()
    mm = MemoryManager(budget_bytes=need + need // 2, enforce=True)  # fits ONE
    for _ in range(2):
        model = _port(tiny, memory=mm, name="dep-cycle")
        comp = GenerativeComponent(model)
        model.note_suspend_bytes(1 << 20)
        model._note_dram_bytes(1 << 20)
        run(comp.close())
        assert mm.reserved_bytes == 0
        assert model._mem_key not in host_memory().snapshot()["owners"]


def test_memory_snapshot_names_both_ledgers(tiny):
    model = _port(tiny, prefix_reuse=True, prefix_dram_gb=0.001)
    model.note_suspend_bytes(512)
    snap = model.memory_snapshot()
    assert snap["owner"] == model._mem_key
    assert snap["hbm"]["kv_pool"] > 0
    assert snap["host"] == {"suspend_dram": 512}
    assert model.spec_snapshot()["memory"]["owner"] == model._mem_key
    model.host_store.flush()  # the prefix tier reports into the same row
    assert model.memory_snapshot()["host"] == {"suspend_dram": 512, "prefix_dram": 0}
    model.release_memory()
    assert host_memory().snapshot()["budget_bytes"] > 0


# ------------------------------------------------------- the packed engine


def _unit_spec(name, **extra):
    params = {"preset": ("tiny", "STRING"), "n_slots": (2, "INT"),
              "decode_block": (4, "INT"), **extra}
    return {"name": name, "graph": {
        "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": [{"name": k, "value": str(v), "type": t} for k, (v, t) in params.items()]}}


def test_co_predictor_specs_from_the_environment():
    import base64
    import json

    from seldon_core_tpu_torch.engine.service import load_co_predictor_specs

    assert load_co_predictor_specs({}) == []
    raw = base64.b64encode(json.dumps([_unit_spec("bulk")]).encode()).decode()
    (spec,) = load_co_predictor_specs({"ENGINE_CO_PREDICTORS": raw})
    assert spec.name == "bulk" and spec.graph.implementation.value == "JAX_GENERATIVE"
    with pytest.raises(ValueError, match="JSON list"):
        load_co_predictor_specs({"ENGINE_CO_PREDICTORS": base64.b64encode(b"{}").decode()})


def test_a_packed_engine_registers_warms_reports_and_closes_its_co_services():
    import json
    import urllib.request

    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    arb = arbiter.get_arbiter()

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return json.loads(r.read())

    async def go():
        co = PredictionService(PredictorSpec.from_dict(
            _unit_spec("bulk", pack_class=("batch", "STRING"))), device="cpu")
        app = EngineApp(PredictionService(PredictorSpec.from_dict(
            _unit_spec("chat", pack_slo_ms=(50, "FLOAT"))), device="cpu"), co_services=[co])
        await app.start("127.0.0.1", 0)
        await app.boot()
        try:
            chat, bulk = app.service.walker.component, co.walker.component
            out = {"deployments": arb.snapshot()["deployments"],
                   "warmup": dict(app.warmup_report),
                   "bulk": (await bulk.scheduler.submit(np.asarray(PROMPT, np.int32),
                                                        max_new_tokens=6)).tolist(),
                   "breakdown": await asyncio.to_thread(get, app.port, "/stats/breakdown"),
                   "chaos": await asyncio.to_thread(get, app.port, "/stats/chaos"),
                   "models": (chat.model, bulk.model)}
        finally:
            await app.close()
        out["after"] = arb.snapshot()["deployments"]
        return out

    out = run(go())
    deps = out["deployments"]
    assert [(d["priority"], d["slo_ms"]) for d in deps.values()] == [
        (qos.PRIO_INTERACTIVE, 50.0), (qos.PRIO_BATCH, 250.0)]
    assert len(out["warmup"]) == 2 and any(k.startswith("bulk/") for k in out["warmup"])
    assert len(out["bulk"]) == 6
    bd = out["breakdown"]
    assert bd["packing"]["multi"] is True and bd["packing"]["grants"] >= 1
    assert set(bd["memory"]) == {"hbm", "host"}
    chat_m, bulk_m = out["models"]
    assert set(bd["generation"]) == {chat_m.name, f"bulk/{bulk_m.name}"}
    assert bd["generation"][chat_m.name]["packing"]["arbitrated"] is True
    assert bd["generation"][chat_m.name]["memory"]["owner"] == chat_m._mem_key
    assert out["chaos"]["chaos"]["enabled"] is False
    assert out["after"] == {}  # closing unregistered both
