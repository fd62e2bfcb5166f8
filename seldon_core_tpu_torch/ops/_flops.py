"""FLOP formulas of the hand-written kernels, for ``FlopCounterMode``.

``torch.utils.flop_counter.FlopCounterMode`` counts ATen ops; it cannot
see inside a kernel launched through ``ctypes``, and on the CPU it would
count the plain version's einsums instead.  Inside :func:`counting` each
kernel's wrapper adds its formula (from its shapes, the plain version's
dense count: ``4 * rows * keys * D`` a head) and runs with every dispatch
mode paused, so a model's count is the same whichever route ran.
"""

from __future__ import annotations

import collections
import contextlib

from torch.utils._python_dispatch import _disable_current_modes

_scopes: list[collections.Counter] = []


@contextlib.contextmanager
def counting():
    """Collect the kernels' formula FLOPs by kernel name (a Counter)."""
    c: collections.Counter = collections.Counter()
    _scopes.append(c)
    try:
        yield c
    finally:
        _scopes.remove(c)


def active() -> bool:
    return bool(_scopes)


def add(name: str, flops: int) -> None:
    for c in _scopes:
        c[name] += int(flops)


def paused():
    """Pause the dispatch modes (a FlopCounterMode) around a kernel whose
    formula was added."""
    return _disable_current_modes()


def attention_flops(batch: int, heads: int, rows: int, keys: int, head_dim: int) -> int:
    """QK^T and PV, dense: ``2 * 2 * batch * heads * rows * keys * head_dim``."""
    return 4 * batch * heads * rows * keys * head_dim
