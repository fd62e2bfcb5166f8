#!/usr/bin/env python3
"""Where a zoo step's device time goes, on one NVIDIA GPU.

    python3 zoo_profile.py

Builds ``chip_smoke.py``'s ``serve_zoo`` models at their largest bucket
(ResNet-50 at 32 uint8 images, BERT-base at 256 rows of 128 tokens; bf16,
seeded weights, perturbed as ``serve_zoo`` perturbs them), captures each
bucket's CUDA graph, times 20 replays (CUDA events), then profiles three
eager forwards of the same input under ``torch.profiler`` (the same
kernels a replay runs, launched one by one).  Prints one JSON line a
model: the replay ms a step, and the kernels by device time, with the
calls and the device microseconds a step of each, summed by kind
(convolution, matrix product, softmax, norm, elementwise, reduction,
copy, other).  Needs the repository beside it and CUDA.
"""

from __future__ import annotations

import json
import re
import sys

import chip_smoke as cs

KINDS = [  # first match wins, on the lower-cased kernel name
    ("convolution", r"conv|fprop|implicit|winograd|dgrad|wgrad|cudnn"),
    ("matrix product", r"gemm|nvjet|cutlass|cublas|matmul|xmma"),
    ("softmax", r"softmax"),
    ("norm", r"norm"),
    ("reduction", r"reduce"),
    ("copy", r"copy|memcpy|memset|cat|pad"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise"),
]


def _kind(name: str) -> str:
    low = name.lower()
    for kind, pattern in KINDS:
        if re.search(pattern, low):
            return kind
    return "other"


def _kernels(prof, steps: int, top: int = 25) -> tuple[list[dict], dict, float]:
    """The ``top`` kernels by device time, the device microseconds a step
    by kind, and the kernels launched a step."""
    rows, kinds = [], {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and not e.key.startswith("aten::") and not e.key.startswith("cuda"):
            rows.append((us, e.count, e.key))
            kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + us / steps
    rows.sort(reverse=True)
    return ([{"kernel": k[:100], "kind": _kind(k), "calls_per_step": c / steps,
              "us_per_step": us / steps} for us, c, k in rows[:top]],
            dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            sum(c for _, c, _ in rows) / steps)


def _profile(family: str, seed: int, steps: int = 3) -> dict:
    import copy

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.executor.compiled import BucketSpec, CompiledModel
    from seldon_core_tpu_torch.models import registry

    cfg = cs._zoo_cfg(family)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    module = registry.get_family(family).init_params(cfg, gen, device="cuda")
    cs._perturb(module, gen)
    bucket = cs.ZOO_BUCKETS[family][-1]
    model = CompiledModel(copy.deepcopy(module), buckets=BucketSpec((bucket,)),
                          dtype=torch.bfloat16, name=family)
    x = cs._zoo_rows(family, cfg, bucket, np.random.default_rng(seed))
    model.warmup(x.shape[1:], x.dtype)
    times = cs._zoo_times(model, x)
    xt = torch.from_numpy(x).cuda()
    model._forward(xt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model._forward(xt)
        torch.cuda.synchronize()
    kernels, kinds, launches = _kernels(prof, steps)
    return {"family": family, "preset": cs.ZOO_PRESETS[family], "bucket": bucket,
            "device": torch.cuda.get_device_name(0), "replay_ms": times["device_ms"],
            "eager_ms": times["eager_ms"], "kinds_us_per_step": kinds,
            "kernels_per_step": launches, "kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("zoo_profile: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    for seed, family in enumerate(("resnet", "bert")):
        print(json.dumps(_profile(family, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
