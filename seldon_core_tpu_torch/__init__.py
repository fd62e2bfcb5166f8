"""seldon-core-tpu's serving plane on PyTorch and CUDA.

A port of the JAX package (which stays beside it as the reference)
for an NVIDIA H100.  It keeps the JAX package's module names and graph
spec, so a deployment the JAX engine serves is served unchanged.  Every
entry point takes ``device`` and runs on ``"cuda"`` unless the caller asks
for ``"cpu"``; on a machine without CUDA it raises.  The attention kernels
are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built at first use.
"""

from __future__ import annotations

import contextlib
import gc
import threading

# one CUDA-graph capture at a time in the process, with the syncs and the
# allocator calls around it: a capture on one thread and a capture, a
# device-wide sync or an emptied allocator cache on another invalidate
# each other
CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def capture_section():
    """What every model's CUDA-graph capture runs under: the process-wide
    :data:`CAPTURE_LOCK`, with Python's automatic garbage collection paused
    (``torch.cuda.graph`` collects once before it begins).  A collection
    inside a capture would destroy the graphs of a model that became
    garbage meanwhile (a closed engine's) on the capturing thread, which
    invalidates the capture."""
    with CAPTURE_LOCK:
        paused = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if paused:
                gc.enable()


def resolve_device(device: "str | torch.device" = "cuda") -> "torch.device":
    """The device an entry point runs on; raises when CUDA is asked for but
    absent, so nothing quietly carries on on the CPU.  (torch is imported
    here, not with the package: the gateway's processes never load it.)"""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(device)!r}")
    return dev
