#!/usr/bin/env python3
"""Time the port's CUDA kernels of one or more checkouts on one NVIDIA GPU.

    python3 kernel_times.py [TREE ...]

Each TREE (default: this checkout) is a directory that holds a
``seldon_core_tpu_torch`` package, such as an older commit unpacked with
``git archive``.  Its kernels are built there and timed in a process of its
own, one tree after another in the order given, so that two commits are
compared on one card as ``OLD NEW NEW OLD``.  The shapes and the timings
are ``chip_smoke.py``'s (``kernel_times``): flash attention at the served
bucket (S=1024) and at S=2048, paged decode attention for the smoke's 8
served slots and for 8 slots near position 2000 (also over int8 pages, and
at 4 queries per slot as a speculative verify pass reads), each with ``ms`` (launches
replayed from a CUDA graph), ``eager_ms`` (launched one by one from
Python), ``host_ms``, the plain version, the library call and the bound.

Prints one JSON line per tree, then the card's name and power limit.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def time_tree(tree: str) -> dict:
    """This process's kernels come from ``tree``; shapes and timing from the
    ``chip_smoke.py`` beside this file."""
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)  # ahead of this checkout
    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")
    build = importlib.import_module("seldon_core_tpu_torch.ops._build")
    if not fa.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"{fa.__file__} is not under {tree}")
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    pos = [n + smoke.MAX_NEW // 2 for n in smoke.SERVE_LENGTHS]
    bucket = min(b for b in smoke.PREFILL_BUCKETS if b >= max(smoke.SERVE_LENGTHS))
    return {"tree": tree, "build_s": build_s, **smoke.kernel_times(fa, pa, bucket, pos)}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_tree(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    for tree in argv or [HERE]:
        code = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree]).returncode
        if code:
            return code
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
