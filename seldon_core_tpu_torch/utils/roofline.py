"""Roofline accounting on an NVIDIA card: the port's twin of the JAX
package's ``utils/roofline.py``.

Three numbers make a model's utilization (MFU): its FLOPs, its measured
device time and the card's peak.

- **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode`` over
  the unit's eager forward at the bucket's shape (the JAX package reads
  XLA's cost model of the compiled program).  The two hand-written
  kernels add their formulas (``ops/_flops.py``), so the count is the
  same on the kernel route and the plain one.
- **Device time** is K dispatches timed between two CUDA events on the
  card's stream (the host's clock on the CPU): dispatch is asynchronous,
  so the queue keeps the card busy and the mean is the device's step.
- **Peak** comes from the card's name (:data:`_PEAKS`); an unknown card,
  or the CPU, has none, and every MFU is then None.

CLI, one JSON object on stdout::

    python -m seldon_core_tpu_torch.utils.roofline --family resnet --preset resnet50 --batch 32
    python -m seldon_core_tpu_torch.utils.roofline --family llama --preset llama3-1b --generative
    python -m seldon_core_tpu_torch.utils.roofline --family llama --preset llama3-1b --sweep 8x16,16x16
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable

import numpy as np
import torch

# Dense bf16 tensor-core peak FLOP/s and memory bandwidth (bytes/s) by a
# substring of torch.cuda.get_device_name(), lowercased; more specific
# names first.  Figures from NVIDIA's datasheets: H100 SXM5 989.4 TFLOP/s
# and 3.35 TB/s; H100 PCIe 756 TFLOP/s and 2.0 TB/s; H200 SXM 989 TFLOP/s
# and 4.8 TB/s; A100 SXM4 and PCIe 312 TFLOP/s, 2.039 TB/s (80 GB SXM),
# 1.935 TB/s (80 GB PCIe), 1.555 TB/s (40 GB); L40S 362 TFLOP/s and
# 864 GB/s.
_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 80gb hbm3", 989e12, 3.35e12),  # H100 SXM5
    ("h100 sxm", 989e12, 3.35e12),
    ("h100 pcie", 756e12, 2.0e12),
    ("h200", 989e12, 4.8e12),
    ("a100-sxm4-80gb", 312e12, 2.039e12),
    ("a100 80gb pcie", 312e12, 1.935e12),
    ("a100", 312e12, 1.555e12),
    ("l40s", 362e12, 0.864e12),
)


def _card(device=None) -> str | None:
    """The CUDA card's name, lowercased, or None off a CUDA device."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(dev).lower()


def _lookup(device, col: int) -> float | None:
    name = _card(device)
    if name is None:
        return None
    for marker, *vals in _PEAKS:
        if marker in name:
            return vals[col]
    return None


def chip_peak_flops(device=None) -> float | None:
    """The card's dense bf16 peak FLOP/s, or None (the CPU, an unknown card)."""
    return _lookup(device, 0)


def chip_hbm_bandwidth(device=None) -> float | None:
    """The card's memory bandwidth in bytes/s, or None."""
    return _lookup(device, 1)


def _device_of(out) -> torch.device | None:
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (tuple, list)) and out:
        return _device_of(out[0])
    return None


def measure_step_time(dispatch: Callable[[Any], Any], example: Any, *, iters: int = 24,
                      warmup: int = 3, device=None) -> float:
    """Seconds a step: ``dispatch(example)`` enqueues one step; ``iters``
    of them run between two CUDA events on the current stream (the host's
    clock, after each call returns, off the card)."""
    out = None
    for _ in range(warmup):
        out = dispatch(example)
    dev = torch.device(device) if device is not None else _device_of(out)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dispatch(example)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        dispatch(example)
    return (time.perf_counter() - t0) / iters


def chained_step_time(fn: Callable[[Any], Any], x0: Any, *, iters: int = 24,
                      warmup: int = 3, device=None) -> float:
    """:func:`measure_step_time` of ``fn(x0)``.  The JAX package chains each
    call's output into the next input so that its lazy client runs every
    step; a CUDA stream runs every enqueued kernel, so no chain is needed."""
    return measure_step_time(lambda _x: fn(x0), None, iters=iters, warmup=warmup,
                             device=device)


def count_flops(fn: Callable[[], Any]) -> tuple[int, dict]:
    """``(FLOPs, by kernel)`` of one call of ``fn``: FlopCounterMode's ATen
    count plus the hand-written kernels' formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    from seldon_core_tpu_torch.ops import _flops

    with _flops.counting() as kernels, torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            fn()
    return int(counter.get_total_flops()) + sum(kernels.values()), dict(kernels)


def _round(x, nd):
    return round(x, nd) if x is not None else None


def model_roofline(family: str, *, preset: str | None = None, batch: int = 32,
                   seq: int | None = None, dtype: str | None = "bfloat16", iters: int = 16,
                   device: str = "cuda", **overrides) -> dict:
    """A zoo family at one bucket: FLOPs a step, device seconds a step (the
    captured graph's replays on the card, the eager forward on the CPU),
    rows/s, achieved TFLOP/s and MFU."""
    from seldon_core_tpu_torch.executor.compiled import BucketSpec
    from seldon_core_tpu_torch.models import registry

    tdtype = getattr(torch, dtype) if dtype else None
    cfg = registry.resolve_family_config(family, preset, **overrides)
    model = registry.build_compiled(family, preset=preset, cfg=cfg, dtype=tdtype,
                                    buckets=BucketSpec((batch,)), device=device)
    example = registry.example_input(family, cfg, batch)
    if seq is not None and example.ndim == 2 and example.dtype == np.int32:
        example = np.ones((batch, seq), np.int32)  # token models: serve at `seq`
    x = torch.from_numpy(np.ascontiguousarray(example)).to(model.device)
    flops, kernels = count_flops(lambda: model._forward(x))
    if model.device.type == "cuda":
        model.warmup(example.shape[1:], example.dtype)  # captures the bucket's graph
        with model._lock:
            graph = model._graph(batch, example.shape[1:], example.dtype)["graph"]
        sec = measure_step_time(lambda _x: graph.replay(), None, iters=iters,
                                device=model.device)
    else:
        sec = measure_step_time(lambda _x: model._forward(x), None, iters=iters)
    peak = chip_peak_flops(model.device)
    ok = np.isfinite(sec) and sec > 0
    achieved = flops / sec if flops and ok else None
    return {
        "family": family,
        "preset": preset or "default",
        "batch": batch,
        "seq": seq,
        "dtype": dtype or "float32",
        "measurement_failed": not ok,
        "device_s_per_step": _round(sec, 6) if ok else None,
        "device_ms_per_step": _round(sec * 1e3, 3) if ok else None,
        "rows_per_s_device": _round(batch / sec, 1) if ok else None,
        "flops_per_step": flops,
        "flops_per_row": round(flops / batch) if flops else None,
        "kernel_flops": kernels,
        "achieved_tflops": _round(achieved / 1e12, 2) if achieved else None,
        "peak_tflops": _round(peak / 1e12, 1) if peak else None,
        "mfu": _round(achieved / peak, 4) if achieved and peak else None,
        "device_kind": (torch.cuda.get_device_name(model.device)
                        if model.device.type == "cuda" else "cpu"),
    }


def generative_roofline(family: str = "llama", *, preset: str | None = None, n_slots: int = 8,
                        decode_block: int = 32, dtype: str | None = "bfloat16",
                        prompt_len: int = 8, iters: int = 8, device: str = "cuda",
                        **overrides) -> dict:
    """The decode loop's roofline at full slot occupancy: a block's device
    seconds (the captured block replayed on the card), tokens/s, MFU from
    about 2 x params FLOPs a token, and the bandwidth view (the weights and
    each slot's KV window read once a step), plus one prefill (the TTFT's
    floor)."""
    from seldon_core_tpu_torch.models import registry

    if family != "llama":
        raise ValueError(f"the generative roofline serves the llama family, not {family!r}")
    tdtype = getattr(torch, dtype) if dtype else None
    comp = registry.build_generative_component(
        family, preset=preset, n_slots=n_slots, decode_block=decode_block, dtype=tdtype,
        max_new_tokens=decode_block, device=device, **overrides)
    model = comp.model
    try:
        rng = np.random.default_rng(0)
        prompt = rng.integers(1, model.cfg.vocab_size, size=prompt_len).astype(np.int32)
        last = [int(model.admit(s, prompt, 0.0, s)) for s in range(n_slots)]
        S = n_slots
        active = np.ones(S, bool)
        window = model._window_for(active, decode_block)
        args = (np.asarray(last, np.int32), active, np.zeros(S, np.float32), 0,
                np.full(S, -1, np.int32), np.full(S, 1 << 30, np.int32), decode_block)

        def block(_x):
            return model.step_k_fetch(model.step_k_dispatch(*args, window=window))

        block(None)  # captures the window's graph on the card
        entry = model._graph(decode_block, window)
        if entry is not None:  # the replay alone, between two events
            sec = measure_step_time(lambda _x: entry["graph"].replay(), None, iters=iters,
                                    device=model.device)
        else:
            sec = measure_step_time(block, None, iters=iters)

        def prefill(_x):
            return model.fetch_tokens([model.admit_dispatch(0, prompt, 0.0, 0,
                                                            reserve_tokens=decode_block)])

        prefill_sec = measure_step_time(prefill, None, iters=max(2, iters // 2), warmup=1)
    finally:
        model.release_memory()
    tokens_per_step = n_slots * decode_block
    n_params = sum(p.numel() for p in model.params.parameters())
    flops = 2.0 * n_params * tokens_per_step
    peak = chip_peak_flops(model.device)
    ok = np.isfinite(sec) and sec > 0
    achieved = flops / sec if ok else None
    param_bytes = sum(p.nbytes for p in model.params.parameters())
    cache_itemsize = model._cache["k"].element_size()
    cfg = model.cfg
    kv_read = 2 * cfg.n_layers * n_slots * window * cfg.n_kv_heads * cfg.head_dim * cache_itemsize
    bw = chip_hbm_bandwidth(model.device)
    # a block of k steps reads the weights and the windows k times
    step_floor_s = (param_bytes + kv_read) / bw if bw else None
    hbm_tok_s = n_slots / step_floor_s if step_floor_s else None
    tok_s = tokens_per_step / sec if ok else None
    pf_ok = np.isfinite(prefill_sec) and prefill_sec > 0
    return {
        "family": family,
        "preset": preset or "default",
        "n_slots": n_slots,
        "decode_block": decode_block,
        "window": window,
        "measurement_failed": not ok,
        "device_s_per_block": _round(sec, 6) if ok else None,
        "tokens_per_s_device": _round(tok_s, 1) if ok else None,
        "n_params": n_params,
        "flops_per_token": round(2.0 * n_params),
        "achieved_tflops": _round(achieved / 1e12, 3) if achieved else None,
        "peak_tflops": _round(peak / 1e12, 1) if peak else None,
        "mfu": _round(achieved / peak, 4) if achieved and peak else None,
        "hbm_bytes_per_step": param_bytes + kv_read,
        "hbm_gb_s": _round(bw / 1e9, 0) if bw else None,
        "hbm_roofline_tok_s": _round(hbm_tok_s, 1) if hbm_tok_s else None,
        "hbm_frac": _round(tok_s / hbm_tok_s, 4) if ok and hbm_tok_s else None,
        "prefill_ms": _round(prefill_sec * 1e3, 3) if pf_ok else None,
        "ttft_floor_ms": (_round((prefill_sec + sec / decode_block) * 1e3, 3)
                          if ok and pf_ok else None),
        "block_ms": _round(sec * 1e3, 3) if ok else None,
        "kv_block_size": model.kv_block_size,
        "kv_blocks": model.kv_blocks,
        "decode_kernel": model.decode_kernel,
        "device_kind": (torch.cuda.get_device_name(model.device)
                        if model.device.type == "cuda" else "cpu"),
    }


def generative_sweep(family: str = "llama", *, preset: str | None = None,
                     points: "list[tuple[int, int]] | None" = None,
                     dtype: str | None = "bfloat16", prompt_len: int = 8, iters: int = 8,
                     device: str = "cuda", **overrides) -> list[dict]:
    """The operating points over ``(n_slots, decode_block)``: device tokens/s,
    the bandwidth fraction, block ms and the TTFT floor at each."""
    out = []
    for n_slots, decode_block in points or [(8, 16), (16, 16), (32, 16), (32, 32), (64, 32)]:
        r = generative_roofline(family, preset=preset, n_slots=n_slots,
                                decode_block=decode_block, dtype=dtype, prompt_len=prompt_len,
                                iters=iters, device=device, **overrides)
        out.append({k: r.get(k) for k in (
            "n_slots", "decode_block", "window", "tokens_per_s_device", "hbm_frac",
            "hbm_roofline_tok_s", "block_ms", "prefill_ms", "ttft_floor_ms",
            "measurement_failed")})
        gc.collect()  # the previous point's weights and pool
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--family", required=True)
    ap.add_argument("--preset", default=None)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--generative", action="store_true")
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--decode-block", type=int, default=32)
    ap.add_argument("--sweep", default=None,
                    help="operating points SLOTSxBLOCK,... (e.g. 8x16,16x16); prints "
                         "{'sweep': [...]}")
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    overrides = {"max_seq": args.max_seq} if args.max_seq else {}
    dtype = None if args.dtype in ("", "float32", "none") else args.dtype
    if args.sweep:
        points = [(int(s), int(b)) for s, b in (p.lower().split("x")
                                                for p in args.sweep.split(","))]
        print(json.dumps({"sweep": generative_sweep(
            args.family, preset=args.preset, points=points, dtype=dtype, iters=args.iters,
            device=args.device, **overrides)}))
        return
    if args.generative:
        out = generative_roofline(args.family, preset=args.preset, n_slots=args.n_slots,
                                  decode_block=args.decode_block, dtype=dtype,
                                  iters=args.iters, device=args.device, **overrides)
    else:
        out = model_roofline(args.family, preset=args.preset, batch=args.batch, seq=args.seq,
                             dtype=dtype, iters=args.iters, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
