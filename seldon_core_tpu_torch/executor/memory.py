"""Device memory ledger: a per-card byte ledger arbitrating base weights,
adapter pool, paged-KV pool and KV scales across the deployments one
engine process puts on one card.

The port's copy of the JAX package's ``executor/memory.py``.  Every
:class:`~seldon_core_tpu_torch.executor.generation.GenerativeModel`
reserves its byte classes here at build; with enforcement on
(``SCT_HBM_ENFORCE=1``) an over-committing build fails at once with
:class:`HBMOverCommit` instead of an out-of-memory error at first traffic.

The ledger is host-side accounting (PyTorch's allocator owns the
allocations): its job is arbitration and attribution, and its snapshot
rides ``GenerativeModel.spec_snapshot()``.  The budget is ``SCT_HBM_GB``
GiB when that is set; unset, it is the card's ``total_memory`` on CUDA,
and the JAX package's default of 16 GiB on the CPU.

A second, process-wide ledger (:func:`host_memory`) counts host DRAM: the
prefix tier's demoted blocks (class ``prefix_dram``) and the suspend
records of preempted or drained generations (``suspend_dram``), so that
neither eats the card's budget or trips ``SCT_HBM_ENFORCE``.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

log = logging.getLogger(__name__)

#: byte classes the ledgers recognise (free-form keys are allowed; these
#: are the ones the generative plane reports); ``prefix_dram`` and
#: ``suspend_dram`` live in the HOST ledger (:func:`host_memory`)
CLASSES = (
    "weights", "kv_pool", "kv_scales", "adapter_pool",
    "spec_heads", "draft_weights", "draft_kv",
    "prefix_dram", "suspend_dram",
)

# the two settings the ledger reads, with the JAX package's defaults
_DEFAULT_HBM_GB = 16.0
_FALSY = ("", "0", "false", "no", "off")


def hbm_budget_bytes(device: "str | torch.device | None" = None) -> int:
    """``SCT_HBM_GB`` GiB when set, else the card's memory on CUDA, else
    16 GiB."""
    env = os.environ.get("SCT_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(_DEFAULT_HBM_GB * (1 << 30))


def hbm_enforce() -> bool:
    """``SCT_HBM_ENFORCE``: anything but a falsy value turns enforcement on."""
    return os.environ.get("SCT_HBM_ENFORCE", "0").strip().lower() not in _FALSY


class HBMOverCommit(RuntimeError):
    """A build-time reservation would exceed the card's memory budget
    (only raised when enforcement is on)."""


class MemoryManager:
    """Byte ledger for one card's memory.

    ``budget_bytes`` defaults to :func:`hbm_budget_bytes` of ``device``;
    ``enforce`` to ``SCT_HBM_ENFORCE`` (off by default: the ledger still
    tracks and reports, it warns instead of raising).
    """

    def __init__(self, budget_bytes: int | None = None, *, enforce: bool | None = None,
                 device: "str | torch.device | None" = None):
        if budget_bytes is None:
            budget_bytes = hbm_budget_bytes(device)
        if enforce is None:
            enforce = hbm_enforce()
        self.budget_bytes = int(budget_bytes)
        self.enforce = bool(enforce)
        self._owners: dict[str, dict[str, int]] = {}
        self._lock = threading.Lock()
        self.rejections = 0

    # ------------------------------------------------------------- ledger

    def reserve(self, owner: str, classes: dict[str, int]) -> None:
        """Reserve ``owner``'s byte classes (replacing any prior
        reservation under the same key: a rebuild re-reserves, it never
        double-counts).  Raises :class:`HBMOverCommit` when enforcement is
        on and the total would exceed the budget; otherwise the over-commit
        is recorded and logged."""
        classes = {str(k): max(0, int(v)) for k, v in classes.items()}
        with self._lock:
            prior = sum(self._owners.get(owner, {}).values())
            total = self.reserved_bytes_locked() - prior + sum(classes.values())
            if total > self.budget_bytes:
                self.rejections += 1
                if self.enforce:
                    raise HBMOverCommit(
                        f"HBM reservation for {owner!r} ({sum(classes.values())} bytes) "
                        f"would put the card at {total} of {self.budget_bytes} budget bytes"
                    )
                log.warning("HBM ledger over budget: %d of %d bytes after %r "
                            "(SCT_HBM_ENFORCE=1 makes this a build failure)",
                            total, self.budget_bytes, owner)
            self._owners[owner] = classes

    def release(self, owner: str) -> None:
        with self._lock:
            self._owners.pop(owner, None)

    def reserved_bytes_locked(self) -> int:
        return sum(sum(c.values()) for c in self._owners.values())

    @property
    def reserved_bytes(self) -> int:
        with self._lock:
            return self.reserved_bytes_locked()

    def headroom_bytes(self) -> int:
        return max(0, self.budget_bytes - self.reserved_bytes)

    def snapshot(self) -> dict:
        """The ledger: budget, reserved and headroom bytes, enforcement,
        rejections, bytes by class and by owner."""
        with self._lock:
            by_class: dict[str, int] = {}
            for classes in self._owners.values():
                for k, v in classes.items():
                    by_class[k] = by_class.get(k, 0) + v
            reserved = sum(by_class.values())
            return {
                "budget_bytes": self.budget_bytes,
                "reserved_bytes": reserved,
                "headroom_bytes": max(0, self.budget_bytes - reserved),
                "enforce": self.enforce,
                "rejections": self.rejections,
                "by_class": by_class,
                "owners": {k: dict(v) for k, v in self._owners.items()},
            }


_MEMORY: dict[str, MemoryManager] = {}
_LOCK = threading.Lock()


def device_memory(device: "str | torch.device") -> MemoryManager:
    """The process-wide ledger of ``device`` (one per card; the CPU has its
    own), built at first use so that a test's ``SCT_HBM_*`` settings made
    before it apply."""
    key = str(torch.device(device))
    with _LOCK:
        if key not in _MEMORY:
            _MEMORY[key] = MemoryManager(device=device)
        return _MEMORY[key]



_HOST_MEMORY: MemoryManager | None = None


def suspend_budget_bytes() -> int:
    """A deployment's suspend-store bound: ``SCT_PACK_SUSPEND_GB``, default 1."""
    return int(float(os.environ.get("SCT_PACK_SUSPEND_GB", "1") or 1) * (1 << 30))


def host_memory() -> MemoryManager:
    """The process-wide HOST-DRAM ledger, apart from the card's: its budget
    is the sum of the two host tiers' own, ``SCT_PREFIX_DRAM_GB`` (default
    0: the DRAM prefix tier is opt-in) and :func:`suspend_budget_bytes`,
    and it never enforces.  Built at first use, so that a test's settings
    made before it apply."""
    global _HOST_MEMORY
    with _LOCK:
        if _HOST_MEMORY is None:
            prefix = int(float(os.environ.get("SCT_PREFIX_DRAM_GB", "0") or 0) * (1 << 30))
            _HOST_MEMORY = MemoryManager(prefix + suspend_budget_bytes(), enforce=False)
        return _HOST_MEMORY
