"""Per-device arbitration: N co-resident deployments time-share one card.

The port's copy of the JAX package's ``executor/arbiter.py``.  A
:class:`DeviceArbiter` owns a device's step budget: every
:class:`~seldon_core_tpu_torch.executor.generation.GenerationScheduler`
attached to it (``attach_arbiter``) acquires the device grant before it
dispatches device work at a sync point (prefills, a decode block and the
blocks chained from its carry) and releases it once that work is fetched,
so co-resident deployments interleave whole decode blocks.  Each keeps its
own captured graphs and KV pool, and the one-host-sync-per-block audit
holds per deployment because arbitration happens between blocks, never
inside one.

Grant order is QoS-aware: waiters are served by ``(priority class,
deadline pressure, arrival)``; an interactive deployment's block outranks
a batch deployment's, and within a class the deployment whose queue-wait
pressure is worst goes first.

Preemption is a verb: when an interactive deployment's queue-wait pressure
crosses its SLO band (``slo_ms`` x ``SCT_PACK_PREEMPT``), the arbiter
tells a batch victim to ``request_preempt()``; the victim's scheduler
exports its active slots' KV through the handoff codec into the host-DRAM
suspend store, frees the blocks and parks.  When every interactive
deployment's pressure is back under the hysteresis floor (``slo_ms`` x
``SCT_PACK_RESUME``), the arbiter issues ``request_resume()`` and the
victim re-imports its suspended generations bit-exactly.

With fewer than two registrants ``acquire`` is a synchronous no-op: a sole
deployment pays nothing for the machinery.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time

from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.obs.metering import METER

log = logging.getLogger(__name__)

PACK_ENV = "SCT_PACK"  # "1": every generative component attaches itself
PACK_PREEMPT_ENV = "SCT_PACK_PREEMPT"  # preempt at pressure >= slo * this
PACK_RESUME_ENV = "SCT_PACK_RESUME"  # resume at pressure < slo * this


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _Reg:
    """One registered deployment: its scheduler and packing policy."""

    __slots__ = ("name", "scheduler", "priority", "slo_ms", "grants", "preempted")

    def __init__(self, name, scheduler, priority, slo_ms):
        self.name = name
        self.scheduler = scheduler
        self.priority = priority
        self.slo_ms = float(slo_ms)
        self.grants = 0
        self.preempted = False


class DeviceArbiter:
    """SLO-arbitrated time-sharing of one device's step budget.

    Every method runs on the serving event loop (the schedulers' run loops
    and the engine's handlers share it), so the state needs no lock;
    ``acquire`` is the only suspension point and parks on a future that
    the next ``release`` resolves."""

    def __init__(self):
        self._regs: dict[str, _Reg] = {}
        # (seq, name, future): FIFO tiebreak inside a (priority, pressure)
        # class; the future resolves when the grant lands
        self._waiters: list[tuple[int, str, asyncio.Future]] = []
        self._seq = 0
        self._holder: str | None = None
        self._t_grant = 0.0  # perf_counter stamp of the current grant
        self.high = _env_float(PACK_PREEMPT_ENV, 1.0)
        self.low = _env_float(PACK_RESUME_ENV, 0.5)
        self.grants = 0
        self.preemptions = 0
        self.resumes = 0

    # -------------------------------------------------------- registration

    def register(self, name, *, scheduler, priority=None, slo_ms=None) -> str:
        """Attach one deployment; returns the key it was registered under
        (a name already held gets ``#2``, ``#3`` ..., so two co-tenants of
        one preset never replace each other).  ``priority`` is its QoS
        class (interactive outranks batch at every grant), ``slo_ms`` its
        queue-wait SLO band (an interactive deployment crossing it
        triggers the preemption of a batch victim)."""
        key, n = name, 1
        while key in self._regs:
            n += 1
            key = f"{name}#{n}"
        self._regs[key] = _Reg(
            key, scheduler,
            qos.parse_priority(priority) if priority else qos.PRIO_INTERACTIVE,
            slo_ms if slo_ms is not None else qos.pack_slo_ms(),
        )
        return key

    def unregister(self, name) -> None:
        reg = self._regs.pop(name, None)
        if reg is None:
            return
        if self._holder == name:
            self._set_holder(None)
        if len(self._regs) < 2:
            # back on the sole-tenant fast path: resolve every parked waiter
            # and lift any preemption
            for _seq, nm, fut in self._waiters:
                if not fut.done():
                    self._set_holder(nm)
                    fut.set_result(None)
            self._waiters.clear()
            for other in self._regs.values():
                if other.preempted:
                    other.preempted = False
                    other.scheduler.request_resume()
                    self.resumes += 1
            return
        self._policy()
        if self._holder is None:
            self._grant_next()

    @property
    def multi(self) -> bool:
        return len(self._regs) >= 2

    def _set_holder(self, name: str | None) -> None:
        """Every holder change goes through here, so the usage meter sees
        exact grant intervals: the outgoing holder is charged the wall
        seconds it held the device (a ``#2`` suffix strips back to the
        deployment)."""
        old = self._holder
        if old == name:
            return
        now = time.perf_counter()
        if old is not None and self._t_grant:
            reg = self._regs.get(old)
            METER.add(old.partition("#")[0], qos=reg.priority if reg is not None else "",
                      grant_s=now - self._t_grant)
        self._t_grant = now if name is not None else 0.0
        self._holder = name

    # -------------------------------------------------------------- grants

    async def acquire(self, name: str) -> None:
        """Take the device grant for a sync point's device work.  A
        synchronous no-op below two registrants; otherwise parks until
        the holder's next sync point releases."""
        reg = self._regs.get(name)
        if reg is None or not self.multi:
            self._set_holder(name)
            return
        if self._holder == name:
            return
        self._policy()
        if self._holder is None:
            self._set_holder(name)
            reg.grants += 1
            self.grants += 1
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._seq += 1
        self._waiters.append((self._seq, name, fut))
        try:
            await fut
        except asyncio.CancelledError:
            # torn down while parked: withdraw, or hand the grant straight
            # on if it landed between the resolve and this resume
            self._waiters[:] = [w for w in self._waiters if w[2] is not fut]
            if fut.done() and not fut.cancelled() and self._holder == name:
                self.release(name)
            raise
        reg.grants += 1
        self.grants += 1

    def release(self, name: str) -> None:
        """Give the device back (idempotent: every error path calls it);
        the best waiter by (priority class, pressure, arrival) is granted
        at once."""
        if self._holder != name:
            return
        self._set_holder(None)
        self._policy()
        self._grant_next()

    def poll(self) -> None:
        """Evaluate the preemption policy off a grant edge: a parked victim
        calls this on its park tick, since with the interactive side quiet
        there is no grant edge left to trigger its resume."""
        self._policy()
        if self._holder is None:
            self._grant_next()

    def contended(self, name: str) -> bool:
        """True when another deployment is parked on the grant: the
        holder's overlap pipeline breaks at the next block (cause
        ``arbiter-yield``) instead of chaining from the device carry."""
        return any(nm != name for _seq, nm, _fut in self._waiters)

    def _grant_next(self) -> None:
        while self._waiters and self._holder is None:
            self._waiters.sort(key=self._waiter_key)
            _seq, name, fut = self._waiters.pop(0)
            if fut.done():
                continue
            self._set_holder(name)
            fut.set_result(None)

    def _waiter_key(self, waiter) -> tuple:
        seq, name, _fut = waiter
        reg = self._regs.get(name)
        if reg is None:
            return (0, 0.0, seq)  # unregistered while parked: flush first
        return (qos.priority_rank(reg.priority), -self._pressure_ms(reg), seq)

    # -------------------------------------------------------------- policy

    def _pressure_ms(self, reg: _Reg) -> float:
        """The deployment's queue-wait pressure (its scheduler's EWMA or
        oldest waiter's age), in ms."""
        fn = getattr(reg.scheduler, "queue_pressure", None)
        try:
            return float(fn()) * 1e3 if fn is not None else 0.0
        except Exception:  # noqa: BLE001 - a broken stand-in must not wedge arbitration
            return 0.0

    def _policy(self) -> None:
        """The preemption policy, at every grant edge: interactive pressure
        at or above the SLO band suspends ONE batch victim; pressure below
        the hysteresis floor (``low`` x SLO) across every interactive
        deployment resumes all victims."""
        if not self.multi:
            return
        hot = False
        cool = True
        for reg in self._regs.values():
            if reg.priority != qos.PRIO_INTERACTIVE or reg.slo_ms <= 0:
                continue
            p = self._pressure_ms(reg)
            if p >= reg.slo_ms * self.high:
                hot = True
            if p >= reg.slo_ms * self.low:
                cool = False
        if hot:
            victim = next((r for r in self._regs.values()
                           if r.priority == qos.PRIO_BATCH and not r.preempted
                           and not self._covered(r)), None)
            if victim is not None:
                victim.preempted = True
                victim.scheduler.request_preempt()
                self.preemptions += 1
                log.info("arbiter: preempting %s (interactive pressure over SLO)", victim.name)
        elif cool:
            for reg in self._regs.values():
                if reg.preempted:
                    reg.preempted = False
                    reg.scheduler.request_resume()
                    self.resumes += 1
                    log.info("arbiter: resuming %s", reg.name)

    def _covered(self, reg: _Reg) -> bool:
        """A second registrant of one scheduler (a draft model's prefills,
        ``{name}/draft``) is no victim of its own: the scheduler is
        preempted through its first registrant, and an interactive
        deployment's draft work never suspends it."""
        return any(o is not reg and o.scheduler is reg.scheduler
                   and (o.preempted or o.priority != qos.PRIO_BATCH)
                   for o in self._regs.values())

    # ----------------------------------------------------------- telemetry

    def snapshot(self) -> dict:
        """The arbitration ledger (``GET /stats/breakdown`` ``packing``)."""
        return {
            "multi": self.multi,
            "holder": self._holder,
            "waiting": [nm for _seq, nm, _fut in self._waiters],
            "grants": self.grants,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "deployments": {
                reg.name: {
                    "priority": reg.priority,
                    "slo_ms": reg.slo_ms,
                    "grants": reg.grants,
                    "preempted": reg.preempted,
                    "pressure_ms": round(self._pressure_ms(reg), 3),
                }
                for reg in self._regs.values()
            },
        }


# one serving process drives one device, so one arbiter covers every
# co-resident deployment (tests build private ones)
ARBITER = DeviceArbiter()


def get_arbiter() -> DeviceArbiter:
    return ARBITER
