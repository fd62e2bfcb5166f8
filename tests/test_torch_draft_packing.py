"""Packed draft speculation in the port on the CPU: a ``spec_method='draft'``
deployment beside another under one :class:`DeviceArbiter`, against the
JAX package's scheduler and against the unpacked run.

* Attaching registers ``{name}`` and a batch-class ``{name}/draft`` and
  turns the deferral on; detaching (and closing) removes both.
* Admission defers every draft-model prefill: none runs inline, each runs
  from the deferral at a later sync point while the draft registrant
  holds the grant and the scheduler's own registrant holds none.
* The packed deployment's greedy streams equal its unpacked run and the
  JAX package's packed run, and ``draft_prefills`` equals the JAX
  scheduler's on the same schedule (one a request); one host sync a block.
* The arbiter never picks a draft registrant as a victim of its own: a
  hot interactive co-tenant preempts the batch deployment once, through
  its first registrant, and an interactive deployment's draft registrant
  never suspends it.
"""

import asyncio

import jax
import numpy as np
import pytest

from seldon_core_tpu.executor import arbiter as jax_arbiter
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.executor import arbiter
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

run = asyncio.run

DRAFT = dict(spec_draft=2, spec_method="draft", spec_draft_model="truncate:1")
PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4], np.tile([3, 7, 11], 6).tolist()]
CHAT = [[8, 6, 4], [12, 14, 16, 18]]
MAX_NEW = 11


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _port(tiny, name, **kw):
    return GenerativeModel(tiny[2], tiny[3], n_slots=2, decode_block=4, seq_impl="dense",
                           device="cpu", name=name, **kw)


def _packed(arb, bulk_sched, chat_sched, *, bulk_prio=qos.PRIO_BATCH):
    """chat (interactive) and bulk (draft) submitted together under ``arb``:
    bulk's streams, chat's."""
    async def go():
        try:
            chat_sched.attach_arbiter(arb, priority=qos.PRIO_INTERACTIVE)
            bulk_sched.attach_arbiter(arb, priority=bulk_prio)
            bulk = [bulk_sched.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                    for p in PROMPTS]
            chat = [chat_sched.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
                    for p in CHAT]
            out = await asyncio.gather(*bulk, *chat)
            # the last admissions' draft prefills drain at the sync point
            # after their streams end: batch-class work, never inline
            for _ in range(20_000):
                if bulk_sched.model.draft_prefills >= len(PROMPTS):
                    break
                await asyncio.sleep(0.001)
            return [o.tolist() for o in out[:len(PROMPTS)]], [o.tolist() for o in out[len(PROMPTS):]]
        finally:
            await bulk_sched.close()
            await chat_sched.close()

    return run(go())


def test_attach_registers_a_batch_draft_registrant_and_detach_removes_both(tiny):
    model = _port(tiny, "bulk", **DRAFT)
    arb = arbiter.DeviceArbiter()
    sched = GenerationScheduler(model)
    sched.attach_arbiter(arb, priority=qos.PRIO_INTERACTIVE)
    deps = arb.snapshot()["deployments"]
    assert sched._arb_draft_key == "bulk/draft" and model.defer_draft_prefill
    assert deps["bulk/draft"]["priority"] == qos.PRIO_BATCH
    assert deps["bulk"]["priority"] == qos.PRIO_INTERACTIVE
    sched.detach_arbiter()
    assert arb.snapshot()["deployments"] == {} and sched._arb_draft_key is None
    assert not model.defer_draft_prefill
    plain = GenerationScheduler(_port(tiny, "chat"))
    plain.attach_arbiter(arb)
    assert list(arb.snapshot()["deployments"]) == ["chat"]  # no draft model, no registrant
    run(plain.close())
    assert arb.snapshot()["deployments"] == {}


def test_packed_draft_prefills_defer_to_sync_points_under_the_draft_grant(tiny):
    cfg, jparams = tiny[:2]
    # the unpacked run: every draft prefill inline at admission
    alone = _port(tiny, "bulk", **DRAFT)
    sched = GenerationScheduler(alone)

    async def solo():
        try:
            return [(await t).tolist() for t in [sched.submit(
                np.asarray(p, np.int32), max_new_tokens=MAX_NEW) for p in PROMPTS]]
        finally:
            await sched.close()

    want = run(solo())
    assert alone.draft_prefills == len(PROMPTS)
    # packed: every draft prefill from the deferral, under bulk/draft's grant
    model, chat = _port(tiny, "bulk", **DRAFT), _port(tiny, "chat")
    arb = arbiter.DeviceArbiter()
    bulk_sched, chat_sched = GenerationScheduler(model), GenerationScheduler(chat)
    runs: list = []
    draining = []
    drain, exec_ = model.drain_draft_prefills, model._exec_draft_prefill

    def logged_drain():
        draining.append(True)
        try:
            return drain()
        finally:
            draining.pop()

    def logged_exec(payload):
        runs.append((bool(draining), arb.snapshot()["holder"]))
        return exec_(payload)

    model.drain_draft_prefills, model._exec_draft_prefill = logged_drain, logged_exec
    got, chat_out = _packed(arb, bulk_sched, chat_sched)
    assert got == want
    assert model.draft_prefills == len(PROMPTS) == len(runs)
    assert runs == [(True, "bulk/draft")] * len(PROMPTS)  # none inline at admission
    assert not model._pending_draft_prefill
    assert model.host_syncs == model.decode_blocks > 0
    assert arb.snapshot()["deployments"] == {}  # close removed all three registrants
    # the JAX package on the same schedule: the same streams and count
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4, name="bulk", **DRAFT)
    jchat = JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4, name="chat")
    jgot, jchat_out = _packed(jax_arbiter.DeviceArbiter(), JaxScheduler(jm), JaxScheduler(jchat))
    assert (got, chat_out) == (jgot, jchat_out)
    assert model.draft_prefills == jm.draft_prefills


class _Hot:
    """An interactive co-tenant whose pressure is over its SLO band."""

    def queue_pressure(self):
        return 10.0

    def request_preempt(self):
        raise AssertionError("an interactive tenant is never a victim")

    def request_resume(self):
        pass


def test_a_draft_registrant_is_no_victim_of_its_own(tiny):
    arb = arbiter.DeviceArbiter()
    inter = GenerationScheduler(_port(tiny, "chat", **DRAFT))
    bulk = GenerationScheduler(_port(tiny, "bulk", **DRAFT))
    inter.attach_arbiter(arb, priority=qos.PRIO_INTERACTIVE, slo_ms=50.0)
    bulk.attach_arbiter(arb, priority=qos.PRIO_BATCH)
    arb.register("hot", scheduler=_Hot(), priority=qos.PRIO_INTERACTIVE, slo_ms=50.0)
    for _ in range(3):  # grant edges while the co-tenant stays hot
        arb.poll()
    snap = arb.snapshot()
    assert arb.preemptions == 1 and bulk._preempt and not inter._preempt
    assert snap["deployments"]["bulk"]["preempted"]
    assert not snap["deployments"]["bulk/draft"]["preempted"]
    assert not snap["deployments"]["chat/draft"]["preempted"]
    arb.unregister("hot")  # cool: one resume for the one victim
    arb.poll()
    assert arb.resumes == 1 and not bulk._preempt
    for s in (inter, bulk):
        run(s.close())
