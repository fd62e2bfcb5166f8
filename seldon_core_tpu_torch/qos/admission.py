"""Admission control and SLO-aware load shedding: the port's copy of the
JAX package's ``qos/admission.py``.

The :class:`AdmissionController` turns an unbounded queue into a policy
decided at ingress in O(1):

* **concurrency cap and bounded queue**: beyond ``max_inflight`` running
  plus ``max_queue`` waiting requests it fails fast with
  :class:`QueueFull` (429 with ``Retry-After``);
* **token-bucket rate limit** (``rate``/``burst``), optional;
* **priority classes**: ``batch`` traffic may fill only part of the queue
  (``interactive_reserve``);
* **predictive shedding**: the flight recorder's queue-wait and
  device-step EWMAs estimate the time to completion; a request whose
  deadline budget cannot cover it is shed now (429), not timed out later
  (504) after spending device steps;
* **brownout**: while the shed ratio over a sliding window stays above
  ``brownout_shed_rate`` the controller rejects batch work outright for
  ``brownout_cooldown_s`` and clamps generative ``max_new_tokens``
  (:func:`clamp_max_new_tokens`): shorter answers before fewer answers.

The port has no Prometheus registry yet: every counter is in
:meth:`AdmissionController.snapshot` (``GET /stats/qos``).
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque

from seldon_core_tpu_torch.obs.metering import METER
from seldon_core_tpu_torch.obs.spans import STAGE_DEVICE_STEP, STAGE_QUEUE_WAIT
from seldon_core_tpu_torch.qos.context import PRIO_BATCH, PRIO_INTERACTIVE

# -- typed rejections --------------------------------------------------------


class QosRejection(Exception):
    """Every shed decision: the HTTP status the ingress answers with and a
    ``Retry-After`` hint."""

    status = 429
    reason = "shed"

    def __init__(self, msg: str, *, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = max(0.0, float(retry_after_s))

    def retry_after_header(self) -> str:
        """Whole seconds, at least 1 (RFC 9110 delta-seconds)."""
        return str(max(1, math.ceil(self.retry_after_s)))


class QueueFull(QosRejection):
    """A bounded queue or the concurrency cap overflowed -> 429."""

    reason = "queue-full"


class RateLimited(QosRejection):
    """The token bucket is empty -> 429."""

    reason = "rate-limited"


class PredictedSloMiss(QosRejection):
    """The estimated completion exceeds the deadline budget -> 429."""

    reason = "predicted-slo-miss"


class BrownoutShed(QosRejection):
    """Batch work rejected during a brownout -> 429."""

    reason = "brownout"


class DeadlineExceeded(QosRejection):
    """The deadline passed before (or while) the request waited for a
    device step -> 504, answered from the queue, no step spent on it."""

    status = 504
    reason = "deadline"


# -- token bucket ------------------------------------------------------------


class TokenBucket:
    """``try_take`` returns 0.0 on success, else the seconds until a token
    frees up (the Retry-After hint).  Thread-safe."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._t_last = clock()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            if self.rate <= 0.0:
                return 60.0
            return (n - self._tokens) / self.rate


# -- controller --------------------------------------------------------------


class _Ticket:
    """One admitted request's place; released once (later calls are
    no-ops, so an error path and a ``finally`` may both release)."""

    __slots__ = ("_ctl", "_released")

    def __init__(self, ctl: "AdmissionController | None"):
        self._ctl = ctl
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        if self._ctl is not None:
            self._ctl._release()

    def __enter__(self) -> "_Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class AdmissionController:
    """A deployment's admission policy; every transition is O(1) under one
    lock.  ``recorder`` (default the process's ``RECORDER``) feeds the
    predictive shed; ``clock`` times the token bucket and the brownout."""

    def __init__(
        self,
        name: str = "",
        *,
        enabled: bool = True,
        max_inflight: int = 256,
        max_queue: int = 512,
        rate: float = 0.0,
        burst: float = 0.0,
        interactive_reserve: float = 0.5,
        default_deadline_ms: float = 0.0,
        predictive: bool = True,
        brownout_shed_rate: float = 0.5,
        brownout_window_s: float = 5.0,
        brownout_cooldown_s: float = 5.0,
        brownout_min_events: int = 32,
        brownout_clamp_tokens: int = 16,
        recorder=None,
        clock=time.monotonic,
        metrics=None,
    ):
        if recorder is None:
            from seldon_core_tpu_torch.obs.spans import RECORDER as recorder
        if metrics is None:
            from seldon_core_tpu_torch.utils.metrics import DEFAULT as metrics
        self.metrics = metrics
        self.name = name or "engine"
        self.enabled = bool(enabled)
        self.max_inflight = max(1, int(max_inflight))
        self.max_queue = max(0, int(max_queue))
        self.interactive_reserve = min(1.0, max(0.0, float(interactive_reserve)))
        self.default_deadline_ms = max(0.0, float(default_deadline_ms))
        self.predictive = bool(predictive)
        self.bucket = TokenBucket(rate, burst or rate, clock=clock) if rate > 0 else None
        self.brownout_shed_rate = float(brownout_shed_rate)
        self.brownout_window_s = float(brownout_window_s)
        self.brownout_cooldown_s = float(brownout_cooldown_s)
        self.brownout_min_events = int(brownout_min_events)
        self.brownout_clamp_tokens = max(1, int(brownout_clamp_tokens))
        self.recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        self.inflight = 0
        self._brownout_until = 0.0
        # the brownout window's decisions: (ts, was_shed)
        self._events: deque[tuple[float, bool]] = deque(maxlen=4096)
        self.admitted_total = 0
        self.shed_total = 0
        self.shed_by_reason: dict[str, int] = {}
        self.deadline_miss_total = 0
        self.brownouts_entered = 0

    @classmethod
    def from_env(cls, name: str = "", prefix: str = "SCT_QOS", default_enabled: bool = True,
                 environ=None) -> "AdmissionController":
        """Build from the ``{prefix}_*`` knobs.  With ``default_enabled=False``
        the controller stays inert unless ``{prefix}=1`` or a
        ``{prefix}_*`` knob is set."""
        env = os.environ if environ is None else environ
        get = lambda k, d: env.get(f"{prefix}_{k}", d)  # noqa: E731
        flag = env.get(prefix)
        if flag is not None:
            enabled = flag not in ("0", "false", "off")
        else:
            enabled = default_enabled or any(k.startswith(f"{prefix}_") for k in env)
        return cls(
            name,
            enabled=enabled,
            max_inflight=int(get("MAX_INFLIGHT", "256")),
            max_queue=int(get("MAX_QUEUE", "512")),
            rate=float(get("RATE", "0")),
            burst=float(get("BURST", "0")),
            interactive_reserve=float(get("INTERACTIVE_RESERVE", "0.5")),
            default_deadline_ms=float(get("DEFAULT_DEADLINE_MS", "0")),
            predictive=get("PREDICTIVE", "1") not in ("0", "false", "off"),
            brownout_shed_rate=float(get("BROWNOUT_SHED_RATE", "0.5")),
            brownout_window_s=float(get("BROWNOUT_WINDOW_S", "5")),
            brownout_cooldown_s=float(get("BROWNOUT_COOLDOWN_S", "5")),
            brownout_clamp_tokens=int(get("BROWNOUT_CLAMP_TOKENS", "16")),
        )

    # -- admission -----------------------------------------------------------

    def admit(self, priority: str = PRIO_INTERACTIVE, budget_s: float | None = None) -> _Ticket:
        """Admit or shed one request: a ticket the caller releases when the
        request leaves (reply written or client gone), or a
        :class:`QosRejection`."""
        if not self.enabled:
            return _Ticket(None)
        now = self._clock()
        with self._lock:
            if budget_s is not None and budget_s <= 0.0:
                self._shed_locked(now, priority, DeadlineExceeded(
                    "deadline already expired at admission", retry_after_s=0.0))
            if now < self._brownout_until and priority == PRIO_BATCH:
                self._shed_locked(now, priority, BrownoutShed(
                    "batch traffic shed during brownout",
                    retry_after_s=self._brownout_until - now))
            if self.bucket is not None:
                wait = self.bucket.try_take()
                if wait > 0.0:
                    self._shed_locked(now, priority, RateLimited(
                        "rate limit exceeded", retry_after_s=wait))
            cap = self.max_inflight + self.max_queue
            if priority == PRIO_BATCH:
                cap = self.max_inflight + int(self.max_queue * (1.0 - self.interactive_reserve))
            if self.inflight >= cap:
                self._shed_locked(now, priority, QueueFull(
                    f"{self.inflight} requests in flight (cap {cap} for {priority})",
                    retry_after_s=self._drain_estimate_s()))
            if budget_s is not None and self.predictive:
                est = self.estimate_s()
                if est is not None and est > budget_s:
                    self._shed_locked(now, priority, PredictedSloMiss(
                        f"estimated completion {est * 1e3:.0f}ms exceeds "
                        f"budget {budget_s * 1e3:.0f}ms",
                        retry_after_s=max(1.0, est - budget_s)))
            self.inflight += 1
            self.admitted_total += 1
            self._events.append((now, False))
        self.metrics.qos_admitted.labels(self.name, priority).inc()
        self.metrics.qos_inflight.labels(self.name).set(self.inflight)
        return _Ticket(self)

    def _release(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)
        self.metrics.qos_inflight.labels(self.name).set(self.inflight)

    def _shed_locked(self, now: float, priority: str, exc: QosRejection):
        """Count the shed (reason, brownout window, usage meter) and raise
        it; the lock is held."""
        self.shed_total += 1
        self.shed_by_reason[exc.reason] = self.shed_by_reason.get(exc.reason, 0) + 1
        if exc.reason == "deadline":
            self.deadline_miss_total += 1
        self._events.append((now, True))
        self._maybe_enter_brownout(now)
        self.metrics.qos_shed.labels(self.name, exc.reason, priority).inc()
        METER.add(self.name, qos=priority, requests_shed=1)
        raise exc

    # -- estimates -----------------------------------------------------------

    def estimate_s(self) -> float | None:
        """The predicted time to completion of a request admitted now: the
        queue-wait plus the device-step EWMA (None until both have data)."""
        qw = self.recorder.stage_ewma(STAGE_QUEUE_WAIT)
        step = self.recorder.stage_ewma(STAGE_DEVICE_STEP)
        if qw is None or step is None:
            return None
        return qw + step

    def _drain_estimate_s(self) -> float:
        """Retry-After for a full queue: a device step for each request
        queued ahead, at least 1 s."""
        step = self.recorder.stage_ewma(STAGE_DEVICE_STEP) or 0.0
        return max(1.0, step * max(1, self.inflight - self.max_inflight + 1))

    # -- brownout ------------------------------------------------------------

    def _maybe_enter_brownout(self, now: float) -> None:
        """The sliding window's shed ratio; the lock is held."""
        if now < self._brownout_until:
            return
        horizon = now - self.brownout_window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()
        total = len(self._events)
        if total < self.brownout_min_events:
            return
        if sum(1 for _, s in self._events if s) / total >= self.brownout_shed_rate:
            self._brownout_until = now + self.brownout_cooldown_s
            self.brownouts_entered += 1
            self.metrics.qos_brownout.labels(self.name).set(1)

    @property
    def brownout_active(self) -> bool:
        active = self._clock() < self._brownout_until
        if not active and self._brownout_until:
            self.metrics.qos_brownout.labels(self.name).set(0)
        return active

    def clamp_max_new_tokens(self, requested: int) -> int:
        """During a brownout a generative request gets a shorter answer."""
        if self.enabled and self.brownout_active:
            return min(int(requested), self.brownout_clamp_tokens)
        return int(requested)

    def note_deadline_miss(self, stage: str, priority: str = PRIO_INTERACTIVE) -> None:
        """A queue downstream dropped an expired request (its 504 came from
        that queue): count it against this deployment."""
        with self._lock:
            self.deadline_miss_total += 1

    def snapshot(self) -> dict:
        """The ``GET /stats/qos`` payload."""
        est = self.estimate_s() if self.enabled else None
        qw = self.recorder.stage_ewma(STAGE_QUEUE_WAIT)
        return {
            "name": self.name,
            "enabled": self.enabled,
            "queue_wait_ewma_ms": round(qw * 1e3, 3) if qw is not None else None,
            "inflight": self.inflight,
            "max_inflight": self.max_inflight,
            "max_queue": self.max_queue,
            "interactive_reserve": self.interactive_reserve,
            "rate_limit": self.bucket.rate if self.bucket else None,
            "default_deadline_ms": self.default_deadline_ms or None,
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "shed_by_reason": dict(self.shed_by_reason),
            "deadline_miss_total": self.deadline_miss_total,
            "predicted_completion_ms": round(est * 1e3, 3) if est is not None else None,
            "brownout": {
                "active": self.brownout_active,
                "entered_total": self.brownouts_entered,
                "clamp_max_new_tokens": self.brownout_clamp_tokens,
                "shed_rate_threshold": self.brownout_shed_rate,
            },
        }


# -- the process-wide controller ---------------------------------------------
#
# The engine registers its controller here, so the generation scheduler's
# brownout clamp and the queues' deadline drops reach the same policy
# without the controller passed through every constructor.

_active: AdmissionController | None = None


def set_active_controller(ctl: AdmissionController | None) -> None:
    global _active
    _active = ctl


def active_controller() -> AdmissionController | None:
    return _active


def clamp_max_new_tokens(requested: int) -> int:
    """The brownout clamp of the active controller (identity without one)."""
    ctl = _active
    return int(requested) if ctl is None else ctl.clamp_max_new_tokens(requested)


def note_deadline_miss(stage: str, priority: str = PRIO_INTERACTIVE) -> None:
    ctl = _active
    if ctl is not None:
        ctl.note_deadline_miss(stage, priority)
