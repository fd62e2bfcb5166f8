"""The port's QoS plane on the CPU, against the JAX package.

* ``AdmissionController`` and ``TokenBucket``: one fake clock drives the
  JAX and the port controllers through the JAX package's cases (the token
  bucket, the concurrency cap, batch headroom, a predictive shed from the
  recorder's EWMAs, an expired budget, the rate limit, brownout with its
  clamp, a disabled controller, ``from_env``): the decisions, reasons,
  ``Retry-After`` values and snapshots are equal;
* ``GenerationScheduler`` on the tiny preset, the JAX scheduler and the
  port's on the same weights, each block's fetch held at a gate so the
  sequences are exact: the bounded queue and its batch sub-cap, the
  priority-ordered pop, an expired request failed without a prefill,
  cancel-on-disconnect, the brownout clamp, and a deadline reap mid-decode
  after which the surviving request's greedy tokens equal the JAX ones;
* ROADMAP C8: the JAX scheduler records no queue-wait stage, so the
  predictive shed of a generative engine never has an estimate; the port
  records it at admission;
* the engine over the port's HTTP front: 429 with ``Retry-After``, a 504
  from the queue, the stream route shedding, and a client that leaves
  releasing its ticket.
"""

import asyncio
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest

from seldon_core_tpu import qos as jqos
from seldon_core_tpu.executor import generation as jgen
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.obs import SpanRecorder as JaxRecorder
from seldon_core_tpu.utils.metrics import MetricsRegistry
from seldon_core_tpu_torch import qos as tqos
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor import generation as tgen
from seldon_core_tpu_torch.executor.batcher import BatchQueue
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax
from seldon_core_tpu_torch.obs import METER, STAGE_DEVICE_STEP, STAGE_QUEUE_WAIT
from seldon_core_tpu_torch.obs import SpanRecorder as PortRecorder

run = asyncio.run


class Side:
    """One package's QoS plane behind one interface."""

    def __init__(self, qos, recorder_cls, extra):
        self.qos, self.recorder_cls, self.extra = qos, recorder_cls, extra

    def ctl(self, clock, recorder=None, **kw):
        rec = recorder or self.recorder_cls(max_spans=16, sample=0.0)
        return self.qos.AdmissionController("t", recorder=rec, clock=lambda: clock[0],
                                            **self.extra(), **kw)


JAX = Side(jqos, JaxRecorder, lambda: {"metrics": MetricsRegistry()})
PORT = Side(tqos, PortRecorder, dict)


def _decide(side, ctl, *args, **kw):
    """One admission -> ("admit", ticket) or the shed's type, reason, status
    and Retry-After header."""
    try:
        return ("admit", ctl.admit(*args, **kw))
    except side.qos.QosRejection as e:
        return (type(e).__name__, e.reason, e.status, e.retry_after_header())


def _log(decisions):
    return [d[0] if d[0] == "admit" else d for d in decisions]


# --------------------------------------------------------------------------
# the controller: the JAX package's cases, both packages, one fake clock
# --------------------------------------------------------------------------


def _bucket(side, clock):
    b = side.qos.TokenBucket(rate=10.0, burst=2, clock=lambda: clock[0])
    out = [b.try_take(), b.try_take(), round(b.try_take(), 9)]
    clock[0] += 0.1
    out.append(b.try_take())
    clock[0] += 0.05
    return out + [round(b.try_take(), 9)]


def _cap(side, clock):
    c = side.ctl(clock, max_inflight=1, max_queue=1)
    d = [_decide(side, c), _decide(side, c), _decide(side, c)]
    d[0][1].release()
    d[0][1].release()  # idempotent
    d.append(_decide(side, c))
    d[-1][1].release()
    d[1][1].release()
    return _log(d), c.snapshot()


def _headroom(side, clock):
    c = side.ctl(clock, max_inflight=1, max_queue=4, interactive_reserve=0.5)
    d = [_decide(side, c, side.qos.PRIO_BATCH) for _ in range(4)]
    d += [_decide(side, c, side.qos.PRIO_INTERACTIVE) for _ in range(3)]
    return _log(d), c.snapshot()


def _predictive(side, clock):
    rec = side.recorder_cls(max_spans=16, sample=0.0)
    for i in range(8):
        rec.record_stage(STAGE_QUEUE_WAIT, 0.08 + 0.001 * i)
        rec.record_stage(STAGE_DEVICE_STEP, 0.04)
    c = side.ctl(clock, recorder=rec, predictive=True, max_inflight=1, max_queue=0)
    d = [_decide(side, c, budget_s=0.05), _decide(side, c, budget_s=10.0)]
    d += [_decide(side, c), _decide(side, c, budget_s=0.5)]  # full: the drain estimate
    return _log(d), round(c.estimate_s(), 12), c.snapshot()


def _expired(side, clock):
    c = side.ctl(clock)
    return _log([_decide(side, c, budget_s=-0.01), _decide(side, c, budget_s=0.0)]), c.snapshot()


def _rate(side, clock):
    c = side.ctl(clock, rate=1.0, burst=1)
    d = [_decide(side, c), _decide(side, c)]
    clock[0] += 0.4
    d.append(_decide(side, c))
    clock[0] += 0.7
    d.append(_decide(side, c))
    return _log(d), c.snapshot()


def _brownout(side, clock):
    c = side.ctl(clock, max_inflight=1, max_queue=0, brownout_shed_rate=0.5,
                 brownout_window_s=10.0, brownout_cooldown_s=5.0, brownout_min_events=8,
                 brownout_clamp_tokens=4)
    hold = _decide(side, c)
    d = [_decide(side, c) for _ in range(16)]
    out = [c.brownout_active, c.clamp_max_new_tokens(64), c.clamp_max_new_tokens(3)]
    hold[1].release()
    clock[0] += 1.0
    d.append(_decide(side, c, side.qos.PRIO_BATCH))
    ok = _decide(side, c, side.qos.PRIO_INTERACTIVE)
    d.append(ok)
    ok[1].release()
    snap = c.snapshot()
    clock[0] += 5.0  # the cooldown passed
    out += [c.brownout_active, c.clamp_max_new_tokens(64)]
    d.append(_decide(side, c, side.qos.PRIO_BATCH))
    return _log(d), out, snap, c.snapshot()


def _disabled(side, clock):
    c = side.ctl(clock, enabled=False, max_inflight=1, max_queue=0)
    d = [_decide(side, c) for _ in range(50)]
    for x in d:
        x[1].release()
    return _log(d), c.snapshot(), c.clamp_max_new_tokens(64)


def _from_env(side, clock):
    envs = [
        ({"SCT_GW_QOS_MAX_INFLIGHT": "7"}, "SCT_GW_QOS", False),
        ({}, "SCT_GW_QOS", False),
        ({"SCT_QOS": "0"}, "SCT_QOS", True),
        ({"SCT_QOS_MAX_INFLIGHT": "8", "SCT_QOS_MAX_QUEUE": "8", "SCT_QOS_RATE": "5",
          "SCT_QOS_BROWNOUT_WINDOW_S": "0.5", "SCT_QOS_BROWNOUT_COOLDOWN_S": "1.5",
          "SCT_QOS_PREDICTIVE": "0", "SCT_QOS_DEFAULT_DEADLINE_MS": "250",
          "SCT_QOS_INTERACTIVE_RESERVE": "0.25", "SCT_QOS_BROWNOUT_CLAMP_TOKENS": "9"},
         "SCT_QOS", True),
        ({}, "SCT_QOS", True),
    ]
    out = []
    for env, prefix, default in envs:
        c = side.qos.AdmissionController.from_env("e", prefix=prefix, default_enabled=default,
                                                  environ=env)
        c.recorder = side.recorder_cls(max_spans=16, sample=0.0)  # not the process's stages
        out.append((c.enabled, c.max_inflight, c.predictive, c.brownout_window_s,
                    c.brownout_cooldown_s, c.brownout_clamp_tokens, c.snapshot()))
    return out


@pytest.mark.parametrize("case", [_bucket, _cap, _headroom, _predictive, _expired, _rate,
                                  _brownout, _disabled, _from_env],
                         ids=lambda f: f.__name__.strip("_"))
def test_controller_equals_the_jax_controller(case):
    want = case(JAX, [100.0])
    got = case(PORT, [100.0])
    assert got == want
    if case is _cap:
        assert want[0] == ["admit", "admit", ("QueueFull", "queue-full", 429, "1"), "admit"]
    if case is _brownout:
        assert want[1][:2] == [True, 4] and want[1][3:] == [False, 64]
        assert want[0][16][:2] == ("BrownoutShed", "brownout")


def test_process_wide_clamp_and_deadline_ledger_equal_the_jax_functions():
    def go(side):
        clock = [0.0]
        c = side.ctl(clock, brownout_clamp_tokens=3)
        out = [side.qos.clamp_max_new_tokens(40)]
        side.qos.set_active_controller(c)
        try:
            c._brownout_until = 10.0
            out.append(side.qos.clamp_max_new_tokens(40))
            side.qos.note_deadline_miss("decode", side.qos.PRIO_BATCH)
            out += [side.qos.active_controller() is c, c.snapshot()]
        finally:
            side.qos.set_active_controller(None)
        return out + [side.qos.clamp_max_new_tokens(40)]

    want = go(JAX)
    assert go(PORT) == want
    assert want[:2] == [40, 3] and want[3]["deadline_miss_total"] == 1


@pytest.mark.parametrize("kind", ["recorder", "meter"])
def test_stage_recorder_and_usage_meter_equal_the_jax_classes(kind):
    """The flight recorder's EWMAs, breakdown and histograms, and the usage
    meter's rows, LRU rollup and totals, for one sequence on both classes."""
    from seldon_core_tpu.obs.metering import UsageMeter as JaxMeter
    from seldon_core_tpu_torch.obs.metering import UsageMeter as PortMeter

    rng = np.random.default_rng(3)
    if kind == "recorder":
        samples = [(stage, float(v)) for stage in (STAGE_QUEUE_WAIT, STAGE_DEVICE_STEP, "ttft")
                   for v in rng.exponential(0.05, 100)]

        def run_side(cls):
            rec = cls(max_spans=16, max_stage_samples=64, sample=0.0)
            for stage, v in samples:
                rec.record_stage(stage, v)
            return ([rec.stage_ewma(s) for s in (STAGE_QUEUE_WAIT, STAGE_DEVICE_STEP, "x")],
                    [rec.stage_ewma(STAGE_QUEUE_WAIT, n=8, alpha=0.5)],
                    rec.breakdown(), rec.stage_histograms())

        assert run_side(PortRecorder) == run_side(JaxRecorder)
        return
    ops = [(f"dep{i % 4}", ("", "alpha")[i % 2], ("interactive", "batch")[i % 3 == 0],
            {"device_s": float(v), "tokens_decode": i % 5 + 1})
           for i, v in enumerate(rng.random(40))]

    def run_side(cls, enabled):
        m = cls(max_keys=3, enabled=enabled)
        for dep, adapter, prio, fields in ops:
            m.add(dep, adapter, prio, **fields)
        m.add("dep0")  # no fields: nothing
        return m.snapshot(), m.totals()

    for enabled in (True, False):
        got, want = run_side(PortMeter, enabled), run_side(JaxMeter, enabled)
        assert got[0]["keys"] == want[0]["keys"] and got[0]["evicted"] == want[0]["evicted"]
        assert got[1] == pytest.approx(want[1], rel=1e-12)
        assert got[0]["other"] == pytest.approx(want[0]["other"], rel=1e-12)


def test_controller_sheds_are_metered():
    METER.reset()
    c = tqos.AdmissionController("met-qos", max_inflight=1, max_queue=0)
    t0 = c.admit()
    with pytest.raises(tqos.QueueFull):
        c.admit()
    t0.release()
    assert METER.snapshot()["keys"]["met-qos||interactive"]["requests_shed"] == 1
    METER.reset()


# --------------------------------------------------------------------------
# the generation scheduler on the tiny preset, both packages
# --------------------------------------------------------------------------


class Gate:
    """Holds each decode block's fetch while closed."""

    def __init__(self, model):
        self.opened, self.entered = threading.Event(), threading.Event()
        self.opened.set()
        fetch = model.step_k_fetch

        def gated(handle):
            self.entered.set()
            assert self.opened.wait(20.0), "the gate never opened"
            return fetch(handle)

        model.step_k_fetch = gated

    def close(self):
        self.entered.clear()
        self.opened.clear()

    async def wait_entered(self):
        assert await asyncio.to_thread(self.entered.wait, 20.0)


@pytest.fixture(scope="module")
def models():
    """A one-slot and a two-slot model on the same weights per package,
    reused by every scheduler case (the JAX programs compile once)."""
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    out = {}
    for slots in (1, 2):
        jm = jgen.GenerativeModel(cfg, jparams, n_slots=slots, decode_block=4,
                                  seq_impl="flash", decode_kernel=True, name=f"jax{slots}")
        tm = tgen.GenerativeModel(tcfg, tparams, n_slots=slots, decode_block=4, device="cpu",
                                  name=f"port{slots}")
        out[slots] = {"jax": (jm, Gate(jm), jgen.GenerationScheduler, jqos),
                      "port": (tm, Gate(tm), tgen.GenerationScheduler, tqos)}
    return out


def _submit(sched, q, prompt, order, tag, priority=None, budget_ms=None, **kw):
    async def inner():
        q.set_priority(priority or q.PRIO_INTERACTIVE)
        q.set_budget_ms(budget_ms)
        try:
            out = await sched.submit(np.asarray(prompt, np.int32), **kw)
        except q.QosRejection as e:
            order.append(tag)
            return (type(e).__name__, e.status)
        order.append(tag)
        return out.tolist()

    return asyncio.create_task(inner())


async def _settle():
    await asyncio.sleep(0.05)


def _bounded_and_subcap(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model, maxsize=4)  # the batch sub-cap is 2
        order: list = []
        gate.close()
        a = _submit(sched, q, [1, 2, 3], order, "A", max_new_tokens=8)
        await gate.wait_entered()  # A holds the only slot
        waiting = [_submit(sched, q, [4, i], order, f"B{i}", q.PRIO_BATCH, max_new_tokens=2)
                   for i in range(2)]
        await _settle()
        third = _submit(sched, q, [5], order, "B2", q.PRIO_BATCH, max_new_tokens=2)
        shed = await third
        extra = _submit(sched, q, [6, 7], order, "I", max_new_tokens=2)
        await _settle()
        gate.opened.set()
        outs = await asyncio.gather(a, *waiting, extra)
        await sched.close()
        return shed, outs, order

    return run(go())


def _priority_pop(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model, maxsize=16)
        order: list = []
        gate.close()
        a = _submit(sched, q, [1, 2, 3], order, "A", max_new_tokens=8)
        await gate.wait_entered()
        b1 = _submit(sched, q, [8, 1], order, "B1", q.PRIO_BATCH, max_new_tokens=1)
        await _settle()
        b2 = _submit(sched, q, [8, 2], order, "B2", q.PRIO_BATCH, max_new_tokens=1)
        await _settle()
        i1 = _submit(sched, q, [8, 3], order, "I1", max_new_tokens=1)
        await _settle()
        gate.opened.set()
        outs = await asyncio.gather(a, b1, b2, i1)
        await sched.close()
        return outs, order

    return run(go())


def _expired_in_queue(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model)
        order: list = []
        p0 = model.prefills
        gate.close()
        a = _submit(sched, q, [1, 2], order, "A", max_new_tokens=9)
        await gate.wait_entered()
        doomed = _submit(sched, q, [3], order, "D", budget_ms=20.0, max_new_tokens=4)
        await asyncio.sleep(0.08)  # the deadline passes in the queue
        gate.opened.set()
        outs = await asyncio.gather(a, doomed)
        prefills = model.prefills - p0
        await sched.close()
        return outs, order, prefills

    return run(go())


def _cancel_in_queue(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model)
        order: list = []
        p0 = model.prefills
        gate.close()
        a = _submit(sched, q, [1], order, "A", max_new_tokens=9)
        await gate.wait_entered()
        ghost = _submit(sched, q, [2], order, "G", max_new_tokens=9)
        await _settle()
        ghost.cancel()
        await _settle()
        withdrawn = not sched._waiting
        gate.opened.set()
        out = await a
        prefills = model.prefills - p0
        await sched.close()
        return out, ghost.cancelled(), withdrawn, prefills

    return run(go())


def _brownout_clamp(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model)
        order: list = []
        full = await _submit(sched, q, [1, 2], order, "F", max_new_tokens=12)
        clock = [0.0]
        side = JAX if q is jqos else PORT
        ctl = side.ctl(clock, brownout_clamp_tokens=2)
        ctl._brownout_until = 100.0  # a brownout, forced
        q.set_active_controller(ctl)
        try:
            clamped = await _submit(sched, q, [1, 2], order, "C", max_new_tokens=50)
        finally:
            q.set_active_controller(None)
        await sched.close()
        return full, clamped

    return run(go())


def _reap_mid_decode(model, gate, sched_cls, q):
    async def go():
        sched = sched_cls(model)
        order: list = []
        gate.close()
        r = _submit(sched, q, [9, 8, 7], order, "R", budget_ms=300.0, max_new_tokens=30)
        s = _submit(sched, q, [1, 2, 3, 4], order, "S", max_new_tokens=30)
        await gate.wait_entered()  # both decode; the first block's fetch is held
        await asyncio.sleep(0.4)  # R's deadline passes mid-decode
        gate.opened.set()
        outs = await asyncio.gather(r, s)
        solo = await _submit(sched, q, [1, 2, 3, 4], order, "solo", max_new_tokens=30)
        await sched.close()
        return outs, solo, order

    return run(go())


@pytest.mark.parametrize("case,slots", [
    (_bounded_and_subcap, 1), (_priority_pop, 1), (_expired_in_queue, 1),
    (_cancel_in_queue, 1), (_brownout_clamp, 1), (_reap_mid_decode, 2),
], ids=["bounded_queue_and_batch_subcap", "priority_ordered_pop",
        "expired_request_fails_without_prefill", "cancel_withdraws_from_queue",
        "brownout_clamps_generation", "deadline_reap_mid_decode"])
def test_scheduler_qos_equals_the_jax_scheduler(models, case, slots):
    want = case(*models[slots]["jax"])
    got = case(*models[slots]["port"])
    assert got == want
    if case is _bounded_and_subcap:
        assert want[0] == ("QueueFull", 429)
        assert want[2] == ["B2", "A", "I", "B0", "B1"]  # interactive past the batch cap
    elif case is _priority_pop:
        assert want[1] == ["A", "I1", "B1", "B2"]
    elif case is _expired_in_queue:
        assert want[0][1] == ("DeadlineExceeded", 504) and want[2] == 1  # no prefill spent
    elif case is _cancel_in_queue:
        assert want[1:] == (True, True, 1)
    elif case is _brownout_clamp:
        full, clamped = want
        assert len(clamped) == 2 and clamped == full[:2]
    else:
        (reaped, survivor), solo, _ = want
        assert reaped == ("DeadlineExceeded", 504)
        assert len(survivor) == 30 and survivor == solo


# --------------------------------------------------------------------------
# C8: the generative path's queue wait
# --------------------------------------------------------------------------


def test_c8_jax_scheduler_never_records_queue_wait_the_port_does(models, monkeypatch):
    recs = {"jax": JaxRecorder(max_spans=16, sample=0.0),
            "port": PortRecorder(max_spans=16, sample=0.0)}
    monkeypatch.setattr(jgen, "RECORDER", recs["jax"])
    monkeypatch.setattr(tgen, "RECORDER", recs["port"])
    for name in ("jax", "port"):
        model, _, sched_cls, _ = models[1][name]

        async def go():
            sched = sched_cls(model)
            await sched.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=9)
            await sched.close()

        run(go())
    side_ctl = {"jax": JAX.ctl([0.0], recorder=recs["jax"]),
                "port": PORT.ctl([0.0], recorder=recs["port"])}
    # both record the decode blocks
    assert all(r.stage_ewma(STAGE_DEVICE_STEP) is not None for r in recs.values())
    # the JAX generative path leaves the queue-wait stage empty: no estimate
    assert recs["jax"].stage_ewma(STAGE_QUEUE_WAIT) is None
    assert side_ctl["jax"].estimate_s() is None
    assert recs["port"].stage_ewma(STAGE_QUEUE_WAIT) is not None
    assert side_ctl["port"].estimate_s() is not None


# --------------------------------------------------------------------------
# the engine over the port's HTTP front
# --------------------------------------------------------------------------


class HoldComponent:
    """Parks every request until released; counts the cancelled ones."""

    def __init__(self):
        self.evt = None
        self.cancelled = 0

    async def predict(self, X, names):
        if self.evt is None:
            self.evt = asyncio.Event()
        try:
            await self.evt.wait()
        except asyncio.CancelledError:
            self.cancelled += 1
            raise
        return np.asarray(X)


ONE_MODEL = {"name": "p", "graph": {"name": "m", "type": "MODEL"}}
BODY = json.dumps({"data": {"ndarray": [[1.0, 2.0, 3.0]]}}).encode()


def _request(port, path, body, headers=None):
    """-> (status, headers, body) over one connection."""
    head = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    with socket.create_connection(("127.0.0.1", port), timeout=20) as sock:
        sock.sendall((f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n"
                      f"{head}Connection: close\r\n\r\n").encode() + body)
        data = b""
        while chunk := sock.recv(65536):
            data += chunk
    top, _, payload = data.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:] if ": " in ln)}
    return int(lines[0].split(" ")[1]), hdrs, payload


async def _engine(component, ctl):
    app = EngineApp(PredictionService(PredictorSpec.from_dict(ONE_MODEL), device="cpu",
                                      components={"m": component}), qos_controller=ctl)
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


def _port_ctl(**kw):
    return tqos.AdmissionController("eng", recorder=PortRecorder(max_spans=16, sample=0.0), **kw)


def test_engine_sheds_429_with_retry_after_and_serves_stats_qos():
    async def go():
        comp = HoldComponent()
        app = await _engine(comp, _port_ctl(max_inflight=1, max_queue=0, predictive=False))
        try:
            first = asyncio.ensure_future(asyncio.to_thread(
                _request, app.port, "/api/v0.1/predictions", BODY))
            await asyncio.sleep(0.1)
            t0 = time.perf_counter()
            shed = await asyncio.to_thread(_request, app.port, "/api/v0.1/predictions", BODY)
            shed_s = time.perf_counter() - t0
            stream = await asyncio.to_thread(_request, app.port, "/api/v0.1/predictions/stream",
                                             json.dumps({"tokens": [1, 2]}).encode())
            comp.evt.set()
            done = await first
            stats = await asyncio.to_thread(_request, app.port, "/stats/qos", b"")
            return shed, shed_s, stream, done, json.loads(stats[2])["qos"]
        finally:
            await app.close()

    shed, shed_s, stream, done, snap = run(go())
    # answered at once, not after the held request (held until after this)
    assert shed[0] == 429 and int(shed[1]["retry-after"]) >= 1 and shed_s < 5.0
    assert json.loads(shed[2])["status"]["code"] == 429
    assert stream[0] == 429 and "retry-after" in stream[1]  # the stream route sheds too
    assert done[0] == 200
    assert snap["shed_by_reason"] == {"queue-full": 2}
    assert snap["admitted_total"] == 1 and snap["inflight"] == 0


def test_engine_answers_504_from_the_queue_without_a_device_step():
    class Gated:
        def __init__(self):
            self.gate, self.rows = threading.Event(), 0

        def __call__(self, batch):
            assert self.gate.wait(10.0)
            self.rows += batch.shape[0]
            return batch

    runner = Gated()

    class Batched:
        def __init__(self):
            self.q = BatchQueue(runner, max_batch=1, max_delay_ms=1.0, name="eng-bq")

        async def predict(self, X, names):
            return await self.q.submit(np.asarray(X, float))

        async def close(self):
            await self.q.close()

    async def go():
        comp = Batched()
        app = await _engine(comp, _port_ctl(max_inflight=8, max_queue=8, predictive=False))
        try:
            first = asyncio.ensure_future(asyncio.to_thread(
                _request, app.port, "/api/v0.1/predictions", BODY))
            await asyncio.sleep(0.1)
            second = asyncio.ensure_future(asyncio.to_thread(
                _request, app.port, "/api/v0.1/predictions", BODY, {tqos.DEADLINE_HEADER: "30"}))
            await asyncio.sleep(0.15)  # the deadline passes in the queue
            runner.gate.set()
            return await first, await second, app.qos.snapshot()
        finally:
            await app.close()

    r1, r2, snap = run(go())
    assert (r1[0], r2[0]) == (200, 504) and "retry-after" not in r2[1]
    assert runner.rows == 1  # the expired request never ran
    assert snap["deadline_miss_total"] == 1 and snap["shed_total"] == 0


def test_a_client_that_leaves_releases_its_ticket_and_cancels_its_request():
    async def go():
        comp = HoldComponent()
        ctl = _port_ctl(max_inflight=4, max_queue=0, predictive=False)
        app = await _engine(comp, ctl)
        try:
            def leave():
                sock = socket.create_connection(("127.0.0.1", app.port), timeout=20)
                sock.sendall((f"POST /api/v0.1/predictions HTTP/1.1\r\nHost: x\r\n"
                              f"Content-Length: {len(BODY)}\r\n\r\n").encode() + BODY)
                time.sleep(0.1)
                sock.close()

            await asyncio.to_thread(leave)
            deadline = time.monotonic() + 10.0
            while ctl.inflight and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            return ctl.inflight, ctl.admitted_total, comp.cancelled
        finally:
            await app.close()

    assert run(go()) == (0, 1, 1)


def _stream_engine(ctl):
    """A one-slot tiny generative unit behind the HTTP front, its block
    fetches held at a gate."""
    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": [{"name": k, "value": str(v), "type": t} for k, v, t in (
            ("preset", "tiny", "STRING"), ("n_slots", 1, "INT"),
            ("decode_block", 4, "INT"), ("max_new_tokens", 8, "INT"))]}})

    async def go():
        app = EngineApp(PredictionService(spec, device="cpu"), qos_controller=ctl)
        await app.start("127.0.0.1", 0)
        await app.boot()
        comp = app.service.walker.component
        return app, comp.model, comp.scheduler, Gate(comp.model)

    return go()


def _sse_events(reply) -> list[dict]:
    return [json.loads(chunk[len(b"data: "):]) for chunk in reply[2].split(b"\n\n")
            if chunk.startswith(b"data: ")]


def _stream_bg(port, tokens, max_new, headers=None):
    body = json.dumps({"tokens": tokens, "max_new_tokens": max_new}).encode()
    return asyncio.ensure_future(asyncio.to_thread(
        _request, port, "/api/v0.1/predictions/stream", body, headers))


def test_stream_route_queues_by_the_request_priority():
    """A ``batch`` stream waits behind an interactive one queued after it."""
    async def go():
        app, model, sched, gate = await _stream_engine(_port_ctl(predictive=False))
        try:
            gate.close()
            hold = _stream_bg(app.port, [1, 2, 3], 8)
            await gate.wait_entered()  # the only slot decodes, its fetch held
            batch = _stream_bg(app.port, [4] * 5, 1, {tqos.PRIORITY_HEADER: "batch"})
            await asyncio.sleep(0.15)
            inter = _stream_bg(app.port, [5] * 7, 1)
            await asyncio.sleep(0.15)
            queued = [r.priority for r in sched._waiting]
            gate.opened.set()
            replies = [await hold, await batch, await inter]
            return queued, [n for n, _ in sched.ttft], replies
        finally:
            await app.close()

    queued, admitted, replies = run(go())
    assert queued == [tqos.PRIO_BATCH, tqos.PRIO_INTERACTIVE]
    assert admitted == [3, 7, 5]  # the interactive stream took the slot first
    assert [r[0] for r in replies] == [200, 200, 200]
    assert all("done" in _sse_events(r)[-1] for r in replies)


def test_stream_route_fails_an_expired_request_in_the_queue_without_a_prefill():
    async def go():
        ctl = _port_ctl(predictive=False)
        app, model, sched, gate = await _stream_engine(ctl)
        try:
            gate.close()
            hold = _stream_bg(app.port, [1, 2, 3], 8)
            await gate.wait_entered()
            p0 = model.prefills
            doomed = _stream_bg(app.port, [6, 6], 4, {tqos.DEADLINE_HEADER: "30"})
            await asyncio.sleep(0.2)  # the deadline passes in the queue
            gate.opened.set()
            held, reply = await hold, await doomed
            return held, reply, model.prefills - p0, dict(sched.deadline_reaps), ctl.snapshot()
        finally:
            await app.close()

    held, reply, prefills, reaps, snap = run(go())
    assert held[0] == 200 and "done" in _sse_events(held)[-1]
    events = _sse_events(reply)
    assert reply[0] == 200 and len(events) == 1  # headers went out; no token came
    assert events[0]["error"].startswith("DeadlineExceeded")
    assert prefills == 0
    assert reaps == {"generation-queue": 1}
    assert snap["deadline_miss_total"] == 1
