"""Per-request lifecycle timelines (``obs/timeline.py``) in the port, on the
CPU, against the JAX package.

* the ledger: bounds, the collapse of repeated events, the first terminal
  winning, the disabled ledger, ``note`` on the newest entry; the same
  calls give the same entries as the JAX ledger (times aside);
* the scheduler: for the same prompts (``tiny``, float32 weights carried
  by ``params_from_jax``), the port's scheduler writes the JAX
  scheduler's event kinds in the JAX order with equal host-bookkeeping
  attributes (only the times and the device milliseconds of the terminal's
  ``usage`` are left out): budget and eos terminals, prefix reuse depth,
  speculation's draft and accept split, a shed; a deadline reap and a
  chunked admission are held to the same terminal and events;
* the host-sync audit stays green with the ledger on: one fetch a block;
* one trace id stitches a prefill engine's and a decode engine's spans and
  timelines over HTTP (the handoff frame carries the trace);
* preempt, suspend and resume events on a preempted scheduler.
"""

import asyncio
import json
import urllib.request

import jax
import numpy as np
import pytest

from seldon_core_tpu import qos as jqos
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.obs.timeline import TIMELINE as JAX_TIMELINE
from seldon_core_tpu.obs.timeline import TimelineLedger as JaxLedger
from seldon_core_tpu.utils import tracectx as jtc
from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax
from seldon_core_tpu_torch.obs import RECORDER, TIMELINE, host_sync_snapshot, spans
from seldon_core_tpu_torch.obs.timeline import TimelineLedger

run = asyncio.run


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


@pytest.fixture(autouse=True)
def _fresh_context():
    """No trace, deadline or priority, and no pool role: an engine booted
    earlier in this process leaves its role as the process's."""
    from seldon_core_tpu.obs import spans as jspans

    spans.set_traceparent(None)
    jtc.set_traceparent(None)
    for s in (spans, jspans):
        s.set_engine_role(None)
        s.set_process_role(None)
    for q in (qos, jqos):
        q.set_deadline(None)
        q.set_priority(q.PRIO_INTERACTIVE)
    yield


def _strip(entry: dict) -> dict:
    """An entry without its times: the kinds, attributes and repeats of its
    events, the terminal's usage without its device milliseconds."""
    events = []
    for e in entry["events"]:
        attrs = dict(e["attrs"])
        if "usage" in attrs:
            attrs["usage"] = {k: v for k, v in attrs["usage"].items() if k != "device_ms"}
        events.append((e["name"], attrs, e.get("n", 1)))
    return {"model": entry["model"], "role": entry["role"], "attrs": entry["attrs"],
            "done": entry["done"], "dropped": entry["dropped"], "events": events}


# ------------------------------------------------------------------ ledger


def _ledger_script(led):
    for i in range(5):
        led.begin(f"trace-{i}", model="m", role="unified")
    t = led.begin("t", model="m", role="unified", leg="first")
    for i in range(20):
        t.event("e", i=i)
    u = led.begin("t", model="m", role="unified", leg="second")
    for _ in range(50):
        u.event("paused", cause="externals-pinned")
    u.event("admit", slot=0)
    u.end("deadline-reap")
    u.end("budget")
    assert led.note("t", "handoff-export", bytes=10) is True
    assert led.note("missing", "x") is False
    return ([_strip(d) for d in led.by_trace("t")], [_strip(d) for d in led.recent(3)],
            led.snapshot())


def test_the_ledger_gives_the_jax_ledgers_entries():
    mine = _ledger_script(TimelineLedger(max_requests=4, max_events=8, enabled=True))
    theirs = _ledger_script(JaxLedger(max_requests=4, max_events=8, enabled=True))
    assert mine == theirs
    legs, _, snap = mine
    assert snap["held"] == 4 and snap["begun"] == 7
    assert legs[0]["dropped"] == 12 and len(legs[0]["events"]) == 8
    assert legs[1]["events"][0] == ("paused", {"cause": "externals-pinned"}, 50)
    assert legs[1]["done"] == "deadline-reap"
    assert [e[0] for e in legs[1]["events"]][-2:] == ["terminal", "handoff-export"]


def test_a_disabled_ledger_records_nothing():
    led = TimelineLedger(max_requests=4, max_events=8, enabled=False)
    assert led.begin("t", model="m") is None
    assert led.note("t", "e") is False
    assert led.snapshot()["begun"] == 0


# --------------------------------------------------------------- scheduler


def _models(tiny, **kw):
    cfg, jparams, tcfg, tparams = tiny
    base = dict(n_slots=2, decode_block=4)
    base.update(kw)
    jm = JaxGenerativeModel(cfg, jparams, seq_impl="flash", decode_kernel=True, name="tl", **base)
    pm = GenerativeModel(tcfg, tparams, device="cpu", name="tl", **base)
    return jm, pm


def _traced(scenario, tiny, **model_kw):
    """Run ``scenario(sched, submit)`` on the JAX scheduler and on the port's;
    ``submit(prompt, trace=True, **kw)`` submits under a fresh traceparent
    whose trace id it records.  -> (JAX entries, port entries) per traced
    submit, stripped."""
    out = []
    for sched_cls, model, setter, ledger in (
            (JaxScheduler, _models(tiny, **model_kw)[0], jtc.set_traceparent, JAX_TIMELINE),
            (GenerationScheduler, _models(tiny, **model_kw)[1], spans.set_traceparent,
             TIMELINE)):
        sched = sched_cls(model)
        tids = []

        async def submit(prompt, trace=True, _s=sched, _set=setter, _t=tids, **kw):
            if trace:
                tp = spans.new_traceparent()
                _t.append(tp.split("-")[1])
                _set(tp)
            else:
                _set(None)
            return (await _s.submit(np.asarray(prompt, np.int32), **kw)).tolist()

        async def go(_s=sched, _m=model):
            try:
                return await scenario(_s, _m, submit)
            finally:
                await _s.close()

        result = run(go())
        out.append((result, [[_strip(d) for d in ledger.by_trace(t)] for t in tids]))
    return out


def test_budget_terminals_equal_the_jax_schedulers(tiny):
    async def scenario(sched, model, submit):
        return await asyncio.gather(*(submit(p, max_new_tokens=n) for p, n in
                                      (([5, 9, 2, 17, 3], 6), ([30, 7], 9), ([1, 2, 3], 3))))

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny)
    assert pout == jout
    assert ptl == jtl
    names = [e[0] for e in ptl[0][0]["events"]]
    assert names[0] == "queued" and "admit" in names and "block" in names
    assert names[-1] == "terminal" and ptl[0][0]["done"] == "budget"


def test_eos_terminal_equals_the_jax_schedulers(tiny):
    async def scenario(sched, model, submit):
        first = await submit([5, 9, 2], trace=False, max_new_tokens=8)
        return await submit([5, 9, 2], max_new_tokens=8, eos_id=int(first[1]))

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny)
    assert pout == jout and len(pout) == 2
    assert ptl == jtl
    term = ptl[0][0]["events"][-1][1]
    assert term["reason"] == "eos" and term["tokens"] == 2
    assert term["usage"] == {"tokens_in": 3, "tokens_out": 2}


def test_prefix_reuse_depth_on_admit_equals_the_jax_schedulers(tiny):
    shared = list(range(1, 33))  # 2 full 16-token blocks

    async def scenario(sched, model, submit):
        await submit(shared + [40, 41], trace=False, max_new_tokens=4)
        return await submit(shared + [50, 51], max_new_tokens=4)

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny, prefix_reuse=True)
    assert pout == jout
    assert ptl == jtl
    admit = next(e[1] for e in ptl[0][0]["events"] if e[0] == "admit")
    assert admit["blocks_reused"] == 2 and admit["prefix_tokens"] == 32 and admit["tier"] == "hbm"
    assert ptl[0][0]["events"][-1][1]["usage"]["tokens_saved"] == 32


def test_speculation_block_events_equal_the_jax_schedulers(tiny):
    async def scenario(sched, model, submit):
        return await asyncio.gather(submit([5, 9, 2, 5, 9, 2, 5, 9], max_new_tokens=10),
                                    submit([30, 7, 30, 7], max_new_tokens=7))

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny, spec_draft=2)
    assert pout == jout
    assert ptl == jtl
    blocks = [e[1] for e in ptl[0][0]["events"] if e[0] == "block"]
    assert blocks and all(b["drafted"] == 2 * b["passes"] for b in blocks)


def test_a_shed_leaves_the_jax_schedulers_terminal_only_entry(tiny):
    async def scenario(sched, model, submit):
        sched._maxsize, sched._batch_cap = 1, 1
        stream = asyncio.create_task(submit([3, 1], trace=False, max_new_tokens=30))
        while not model.steps:
            await asyncio.sleep(0.01)
        filler = asyncio.create_task(submit([7, 7], trace=False, max_new_tokens=2))
        await asyncio.sleep(0)
        with pytest.raises((qos.QueueFull, jqos.QueueFull)):
            await submit([8, 8], max_new_tokens=2)
        return [await stream, await filler]

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny, n_slots=1)
    assert ptl == jtl
    (entry,) = ptl[0]
    assert entry["done"] == "shed" and [e[0] for e in entry["events"]] == ["terminal"]
    assert entry["events"][0][1]["depth"] == 1 and entry["events"][0][1]["cap"] == 1


def test_a_deadline_reap_ends_as_the_jax_schedulers(tiny):
    async def scenario(sched, model, submit):
        q = jqos if isinstance(sched, JaxScheduler) else qos
        q.set_budget_ms(30.0)  # expires mid-generation
        try:
            with pytest.raises((qos.DeadlineExceeded, jqos.DeadlineExceeded)):
                await submit([5, 9, 2], max_new_tokens=56)
        finally:
            q.set_deadline(None)

    (_, jtl), (_, ptl) = _traced(scenario, tiny)
    for tl_ in (jtl, ptl):
        (entry,) = tl_[0]
        assert entry["done"] == "deadline-reap"
        assert entry["events"][-1][1]["stage"] in ("queue", "decode", "prefill")
    assert ptl[0][0]["events"][0] == jtl[0][0]["events"][0]  # queued at depth 0


def test_a_chunked_admission_writes_one_chunk_event_a_sync_point(tiny):
    async def scenario(sched, model, submit):
        stream = asyncio.create_task(submit([3, 1, 4], trace=False, max_new_tokens=40))
        while not model.steps:  # decoding: the long admission is paced
            await asyncio.sleep(0.01)
        out = await submit(list(range(1, 41)), max_new_tokens=6)
        await stream
        return out

    (jout, jtl), (pout, ptl) = _traced(scenario, tiny, prefill_chunk=16, spec_draft=2)
    assert pout == jout
    for tl_ in (jtl, ptl):
        (entry,) = tl_[0]
        names = [e[0] for e in entry["events"]]
        admit = next(e[1] for e in entry["events"] if e[0] == "admit")
        chunks = [e[1] for e in entry["events"] if e[0] == "chunk"]
        assert admit["chunked"] is True and len(chunks) == admit["chunks"] == 3
        assert [c["i"] for c in chunks] == [0, 1, 2] and chunks[-1]["last"] is True
        assert names.index("admit") < names.index("chunk") < names.index("block")
        assert entry["done"] == "budget"
    strip = lambda tl_: {k: v for k, v in  # noqa: E731
                         next(e[1] for e in tl_[0][0]["events"] if e[0] == "admit").items()}
    assert strip(ptl) == strip(jtl)


def test_the_host_sync_audit_stays_green_with_the_ledger_on(tiny):
    assert TIMELINE.enabled
    _, pm = _models(tiny, n_slots=4, decode_block=8)
    sched = GenerationScheduler(pm, overlap=True)
    before = host_sync_snapshot().get("tl", 0)

    async def go():
        try:
            return await asyncio.gather(*(sched.submit(np.asarray([5 + i, 9, 2], np.int32),
                                                       max_new_tokens=24) for i in range(3)))
        finally:
            await sched.close()

    outs = run(go())
    assert all(len(o) == 24 for o in outs)
    assert pm.host_syncs == pm.decode_blocks
    assert host_sync_snapshot()["tl"] - before == pm.decode_blocks
    assert pm.host_syncs < 72 / 2, "a per-token sync pattern"


# ------------------------------------------------------ stitched over HTTP


def _graph():
    p = lambda n, v, t="STRING": {"name": n, "value": str(v), "type": t}  # noqa: E731
    return {"name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [p("preset", "tiny"), p("n_slots", 2, "INT"),
                           p("decode_block", 4, "INT"), p("max_seq", 64, "INT")]}


def _post(port, path, body, headers):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, {k.lower(): v for k, v in r.headers.items()}, json.loads(r.read())


def test_one_trace_id_stitches_the_prefill_and_decode_engines():
    tid = "5" * 32
    tp = f"00-{tid}-{'6' * 16}-01"

    async def go():
        apps = []
        for role, ups in (("decode", None), ("prefill", True)):
            spec = PredictorSpec.from_dict({"name": f"p-{role}", "graph": _graph()})
            kw = {"role": role}
            if ups:
                kw["decode_upstreams"] = [f"127.0.0.1:{apps[0].port}"]
            app = EngineApp(PredictionService(spec, device="cpu"), **kw)
            await app.start("127.0.0.1", 0)
            await app.boot()
            apps.append(app)
        try:
            return await asyncio.to_thread(_post, apps[1].port, "/disagg/generate",
                                           {"tokens": [5, 9, 2, 17, 3], "max_new_tokens": 6},
                                           {"traceparent": tp})
        finally:
            for app in apps:
                await app.close()

    status, headers, body = run(go())
    assert status == 200 and body["mode"] == "disagg" and len(body["tokens"]) == 6
    assert headers["x-sct-trace-id"] == tid
    trace = next(t for t in RECORDER.recent_traces(200) if t["trace_id"] == tid)
    by_name = {s["name"]: s for s in trace["spans"]}
    for name in ("disagg.prefill", "handoff.export", "handoff.relay", "disagg.import"):
        assert name in by_name, name
    export, imp = by_name["handoff.export"], by_name["disagg.import"]
    assert imp["parent_id"] == export["span_id"]
    assert imp["attrs"]["origin_span_id"] == export["span_id"]
    assert export["attrs"]["engine.role"] == "prefill" and imp["attrs"]["engine.role"] == "decode"
    legs = TIMELINE.by_trace(tid)
    kinds = [leg["attrs"]["kind"] for leg in legs]
    assert kinds == ["prefill", "imported"]
    prefill, decode = legs
    assert prefill["role"] == "prefill" and decode["role"] == "decode"
    assert [e["name"] for e in prefill["events"]][-2:] == ["terminal", "handoff-export"]
    assert prefill["done"] == "exported"
    names = [e["name"] for e in decode["events"]]
    assert names[:2] == ["queued", "admit"] and names[-1] == "terminal"
    assert next(e for e in decode["events"] if e["name"] == "admit")["attrs"]["imported"]
    assert decode["done"] == "budget"


# ----------------------------------------------------------------- packing


def test_preempt_suspend_and_resume_events(tiny):
    _, pm = _models(tiny)
    sched = GenerationScheduler(pm)
    tp = spans.new_traceparent()
    tid = tp.split("-")[1]

    async def go():
        try:
            spans.set_traceparent(tp)
            task = asyncio.create_task(sched.submit(np.asarray([5, 9, 2], np.int32),
                                                    max_new_tokens=40))
            while pm.decode_blocks < 2:
                await asyncio.sleep(0.005)
            sched.request_preempt()
            while not sched.suspends:
                await asyncio.sleep(0.005)
            sched.request_resume()
            return await task
        finally:
            await sched.close()

    out = run(go())
    assert len(out) == 40
    (entry,) = TIMELINE.by_trace(tid)
    names = [e["name"] for e in entry["events"]]
    order = [names.index(n) for n in ("preempt", "suspend", "resume-queued", "resume")]
    assert order == sorted(order)
    suspend = next(e["attrs"] for e in entry["events"] if e["name"] == "suspend")
    assert suspend["victim"] == "tl" and suspend["blocks_freed"] >= 1 and suspend["bytes"] > 0
    resume = next(e["attrs"] for e in entry["events"] if e["name"] == "resume")
    assert resume["tokens"] == suspend["tokens"]
    assert entry["done"] == "budget" and names[-1] == "terminal"

