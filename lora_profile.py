#!/usr/bin/env python3
"""Where a multi-LoRA decode block's device time goes, on one NVIDIA GPU.

    python3 lora_profile.py

Boots ``chip_smoke.py``'s ``serve_lora`` engine (llama3-1b, bf16, seeded
weights, 8 slots, 16-step blocks, ``lora_rank=16``, ``lora_slots=8``,
``lora_targets=qkvo+mlp``, adapters alpha..delta), admits serve's 8
prompts through the mixed adapters ``[none, alpha, beta, none, gamma,
delta, alpha, none]`` and replays the same block from that one state
(``chip_smoke._on_off_blocks``: an untimed pair, which captures the off
graph, and a timed pair), then under ``torch.profiler``, three blocks with
the LoRA deltas on and three with them off.  Prints one JSON
line: each side's block ms (CUDA events) and its kernels by device time,
with the calls and the device microseconds per step of each.  Needs the
repository beside it and CUDA.
"""

from __future__ import annotations

import asyncio
import json
import sys

import chip_smoke as cs


def _kernels(prof, steps: int, top: int = 20) -> list[dict]:
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us and not e.key.startswith("aten::"):
            rows.append((us, e.count, e.key[:100]))
    rows.sort(reverse=True)
    return [{"kernel": k, "calls_per_step": c / steps, "us_per_step": us / steps}
            for us, c, k in rows[:top]]


async def _run(blocks: int = 3) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    prompts = [cs.VERIFY_PROMPT] + [rng.integers(0, 32000, n).tolist() for n in cs.SERVE_LENGTHS
                                    if n != len(cs.VERIFY_PROMPT)]
    app, _ = await cs._boot(cs._serve_spec(cs.SERVE_PRESET, 0, **cs._lora_extra()), "cuda")
    try:
        m = app.service.walker.component.model
        _, _, profiles = cs._on_off_blocks(m, prompts, cs._lora_switch(m), adapters=cs.LORA_MIX,
                                           pairs=1, profile_blocks=blocks)
        out = {"device": torch.cuda.get_device_name(0), "k": m.decode_block, "blocks": blocks,
               "adapters": cs.LORA_MIX}
        for on, side in profiles.items():
            out["on" if on else "off"] = {"block_ms": side["block_ms"],
                                          "kernels": _kernels(side["profile"],
                                                              blocks * m.decode_block)}
        return out
    finally:
        await app.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lora_profile: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    cs.phase_build()
    print(json.dumps(asyncio.run(_run())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
