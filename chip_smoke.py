#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``seldon_core_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: the CUDA kernels are compiled from ``seldon_core_tpu_torch/csrc``
   (one nvcc per source, all started together) and loaded.
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (llama3-1b: H=32, KV=8, D=64, 16-row
   pages) in bf16 and f32, plus ragged lengths, speculative query counts,
   position 0 and int8 pages.
3. ``reference``: a small model's logits and greedy tokens on the card
   against the same weights on the CPU (plain versions).
4. ``serve``: the engine boots in-process on 127.0.0.1 with a
   ``JAX_GENERATIVE`` llama3-1b bf16 graph (seeded weights, 8 slots,
   16-step decode blocks) and answers concurrent strData requests over
   HTTP; the kernels' launch counts are read around this phase.
5. ``kernel_times``: each kernel's time at the main path's shapes beside
   its plain version, one PyTorch library call where there is one, and the
   least time the card could take (its bound).

Then the card's name and power limit (nvidia-smi), one line listing the
kernels, and as the last line ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero before that line.  Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import importlib
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
# kernel vs plain, both f32 inside: (abs, rel).  Sums in another order
# only; in bf16 the kernel's output is also rounded once to bf16 (at most
# half an ulp, 2**-8 of the value) against the plain version run in f32 on
# the same bf16 inputs, so the relative limit sits just above 2**-8 and the
# absolute one covers f32 noise near zero.
F32_TOL = (2e-4, 2e-4)
BF16_TOL = (1e-4, 4e-3)
SERVE_PRESET = "llama3-1b"
SERVE_SLOTS = 8
SERVE_BLOCK = 16
MAX_NEW = 32
VERIFY_PROMPT = [5, 9, 2, 17, 3]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``arg_sets`` so that no launch finds its inputs in L2."""
    import torch

    for args in arg_sets[:3]:
        fn(*args)
    _sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, tol: tuple[float, float], **shape) -> dict:
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite at {shape}")
    err = (got.float() - want.float()).abs()
    limit = tol[0] + tol[1] * want.float().abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= limit).all())
    rec = {
        "kernel": name, **shape, "max_abs_err": max_abs,
        "max_rel_err": float((err / want.float().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0,
        "atol": tol[0], "rtol": tol[1], "ok": ok,
    }
    if not ok:
        emit({"phase": "kernel_check", **rec})
        raise AssertionError(f"{name} disagrees with its plain version at {shape}")
    return rec


# ----------------------------------------------------------------- phases


def phase_build() -> None:
    from seldon_core_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc_seconds": _build.build_seconds,
        "sources": [f"seldon_core_tpu_torch/csrc/{s}" for s in _build.SOURCES],
    })


def _flash_inputs(S, H, KV, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(1, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(1, S, KV, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(1, S, KV, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def _paged_inputs(S, L, H, KV, D, BS, NB, WB, dtype, seed, *, quant=False, pos=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(S, L, H, D, generator=g, device="cuda").to(dtype)
    table = torch.stack(
        [torch.randperm(NB - 1, generator=g, device="cuda")[:WB] + 1 for _ in range(S)]
    ).to(torch.int32)
    if pos is None:
        pos = torch.randint(0, WB * BS - L, (S,), generator=g, device="cuda")
    pos = torch.as_tensor(pos, device="cuda").to(torch.int32)
    kw = {}
    if quant:
        k = torch.randint(-127, 128, (NB, BS, KV, D), generator=g, device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (NB, BS, KV, D), generator=g, device="cuda").to(torch.int8)
        kw["k_scale"] = (torch.rand(NB, BS, KV, generator=g, device="cuda") * 0.02).to(dtype)
        kw["v_scale"] = (torch.rand(NB, BS, KV, generator=g, device="cuda") * 0.02).to(dtype)
    else:
        k = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    return (q, k, v, table, pos), kw


def _f32(x):
    return x.float() if x.is_floating_point() else x


def phase_kernel_check() -> dict:
    """Every kernel against its plain version, run in f32 on the kernel's
    own inputs; returns the bf16 main-path errors for the kernels line."""
    import torch

    # the submodules (the package re-exports functions of the same names)
    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []
    main_err = {}
    H, KV, D = 32, 8, 64
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dn = str(dtype).split(".")[-1]
        for S in (16, 100, 2048):
            q, k, v = _flash_inputs(S, H, KV, D, dtype, seed=S)
            got = fa.flash_causal_attention_blhd(q, k, v)
            want = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v), True)
            rec = compare("flash_attention", got, want, tol, S=S, H=H, KV=KV, D=D, dtype=dn)
            checks.append(rec)
            if S == 2048 and dtype == torch.bfloat16:
                main_err["flash_attention"] = rec["max_abs_err"]
        # K/V already repeated to H heads (the JAX adapter's contract), and
        # the (B, H, S, D) entry without a mask
        q, k, v = _flash_inputs(100, H, H, D, dtype, seed=7)
        got = fa.flash_causal_attention_blhd(q, k, v)
        want = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v), True)
        checks.append(compare("flash_attention", got, want, tol, S=100, H=H, KV=H, D=D, dtype=dn))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in _flash_inputs(100, H, KV, D, dtype, 8))
        got = fa.flash_attention(qt, kt, vt, causal=False)
        want = fa.flash_attention_plain(_f32(qt), _f32(kt), _f32(vt), causal=False)
        checks.append(compare("flash_attention", got, want, tol, S=100, H=H, KV=KV, D=D, dtype=dn, causal=False))
        for L, quant, pos in ((1, False, None), (3, False, None), (1, False, [0] * 8),
                              (1, True, None), (3, True, None)):
            args, kw = _paged_inputs(8, L, H, KV, D, 16, 1025, 64, dtype, seed=L + 10 * quant,
                                     quant=quant, pos=pos)
            got = pa.paged_decode_attention(*args, **kw)
            want = pa.paged_decode_attention_plain(
                *map(_f32, args), **{n: _f32(x) for n, x in kw.items()})
            rec = compare("paged_decode_attention", got, want, tol, S=8, L=L, H=H, KV=KV, D=D,
                          BS=16, WB=64, int8=quant, pos0=pos is not None, dtype=dn)
            checks.append(rec)
            if L == 1 and not quant and pos is None and dtype == torch.bfloat16:
                main_err["paged_decode_attention"] = rec["max_abs_err"]
    _sync()
    emit({"phase": "kernel_check", "cases": len(checks), "ok": True, "checks": checks})
    return main_err


def phase_reference(device: str = "cuda") -> None:
    """The model at llama3-1b head geometry (2 layers, f32) on ``device``
    against the same weights on the CPU, where the plain versions run:
    prefill logits, then teacher-forced decode logits and greedy tokens."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.models.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(llama.Config.llama3_1b(max_seq=256), n_layers=2)
    gen = torch.Generator(device="cpu").manual_seed(1)
    cpu = init_params(cfg, gen, dtype=torch.float32, device="cpu")
    dev = init_params(cfg, torch.Generator(device="cpu").manual_seed(1), device="cpu").to(device)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 100).astype(np.int32)
    padded = np.zeros((1, 128), np.int32)
    padded[0, :100] = prompt
    row = np.zeros(cfg.max_seq // 16, np.int32)
    row[:10] = np.arange(1, 11)
    caches = {d: llama.init_paged_cache(cfg, 2, 24, 16, device=d) for d in ("cpu", device)}
    logits = {}
    for d, params in (("cpu", cpu), (device, dev)):
        lg, _ = llama.prefill_slot_paged(
            params, torch.from_numpy(padded).to(d), 100, 0, row, caches[d], cfg
        )
        logits[d] = [lg.float().cpu()]
    toks = {"cpu": [], device: []}
    feed = int(torch.argmax(logits[device][0]))
    active = torch.tensor([True, False])
    for _ in range(8):
        for d, params in (("cpu", cpu), (device, dev)):
            lg, _ = llama.decode_slots_paged(
                params, torch.tensor([feed, 0], dtype=torch.int32, device=d), caches[d],
                active.to(d), cfg, window=256,
            )
            logits[d].append(lg[0].float().cpu())
            toks[d].append(int(torch.argmax(lg[0])))
        feed = toks[device][-1]  # both devices see the same tokens
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[device]))
    scale = max(float(a.abs().max()) for a in logits["cpu"])
    tol = 1e-3 * max(1.0, scale)
    rec = {"phase": "reference", "config": "llama3-1b heads, 2 layers, f32",
           "prefill_len": 100, "decode_steps": 8, "max_abs_logit_err": err,
           "logit_scale": scale, "tol": tol, "greedy_equal": toks["cpu"] == toks[device]}
    rec["ok"] = err <= tol and rec["greedy_equal"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the model on the card disagrees with the CPU reference")


def _post(port: int, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def phase_serve(device: str = "cuda", preset: str = SERVE_PRESET,
                lengths=(5, 17, 64, 100, 211, 333, 480, 600), seed: int = 0) -> dict:
    """Boot the engine in-process and answer concurrent strData requests over
    HTTP; returns what the kernel lines need (launch counts, main-path
    shapes)."""
    import numpy as np

    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec
    from seldon_core_tpu_torch.ops import _build

    spec = PredictorSpec.from_dict({
        "name": "smoke",
        "graph": {
            "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [
                {"name": "family", "value": "llama", "type": "STRING"},
                {"name": "preset", "value": preset, "type": "STRING"},
                {"name": "dtype", "value": "bfloat16", "type": "STRING"},
                {"name": "n_slots", "value": str(SERVE_SLOTS), "type": "INT"},
                {"name": "decode_block", "value": str(SERVE_BLOCK), "type": "INT"},
                {"name": "max_new_tokens", "value": str(MAX_NEW), "type": "INT"},
                {"name": "rng", "value": str(seed), "type": "INT"},
            ],
        },
    })
    rng = np.random.default_rng(seed)

    async def run() -> dict:
        app = EngineApp(PredictionService(spec, device=device))
        await app.start("127.0.0.1", 0)
        port = app.port
        t0 = time.perf_counter()
        boot = asyncio.create_task(app.boot())
        try:
            while await asyncio.to_thread(_get, port, "/ready") != 200:
                if boot.done():
                    boot.result()  # raises the boot failure
                await asyncio.sleep(0.2)
            boot_s = time.perf_counter() - t0
            model = app.service.walker.component.model
            vocab = model.cfg.vocab_size
            prompts = [VERIFY_PROMPT] + [
                rng.integers(0, vocab, n).tolist() for n in lengths if n != len(VERIFY_PROMPT)
            ]
            prompts.append(prompts[3])  # a repeat inside the concurrent wave
            _build.reset_launches()  # the main path's run starts here
            model_before = (model.decode_blocks, model.host_syncs)
            t1 = time.perf_counter()
            loop = asyncio.get_running_loop()
            with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
                replies = await asyncio.gather(*(
                    loop.run_in_executor(clients, _post, port, {"strData": json.dumps(
                        {"tokens": p, "max_new_tokens": MAX_NEW})})
                    for p in prompts
                ))
            wave_s = time.perf_counter() - t1
            again = await asyncio.to_thread(_post, port, {"strData": json.dumps(
                {"tokens": VERIFY_PROMPT, "max_new_tokens": MAX_NEW})})
            launches = dict(_build.LAUNCHES)
            blocks = model.decode_blocks - model_before[0]
            syncs = model.host_syncs - model_before[1]
            outs = []
            for (status, body), p in zip(replies + [again], prompts + [VERIFY_PROMPT]):
                toks = json.loads(body["strData"])["tokens"]
                if status != 200 or body["status"]["code"] != 200:
                    raise AssertionError(f"request failed: {body}")
                if len(toks) != MAX_NEW or not all(0 <= t < vocab for t in toks):
                    raise AssertionError(f"bad reply for a {len(p)}-token prompt: {toks}")
                outs.append(toks)
            if outs[-1] != outs[0] or outs[len(prompts) - 1] != outs[3]:
                raise AssertionError("a repeated greedy prompt gave other tokens")
            missing = [k for k, n in launches.items() if n == 0]
            if missing:
                raise AssertionError(f"the served path never launched {missing}")
            ttft = sorted(app.service.walker.component.scheduler.ttft_s)
            rec = {
                "phase": "serve", "preset": preset, "dtype": "bfloat16",
                "n_slots": SERVE_SLOTS, "decode_block": SERVE_BLOCK,
                "requests": len(prompts) + 1, "concurrent": len(prompts),
                "prompt_lens": [len(p) for p in prompts], "max_new_tokens": MAX_NEW,
                "boot_and_warmup_s": boot_s, "wave_s": wave_s,
                "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
                # end to end: every token the wave generated over its wall time
                "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
                # the model step alone: decode-block tokens over block time
                "decode_tokens_per_s": model.tokens_emitted / model.block_seconds,
                "decode_step_ms": 1e3 * model.block_seconds / max(1, model.steps),
                "decode_blocks": blocks, "host_syncs": syncs,
                "host_syncs_per_block": syncs / max(1, blocks),
                "launches": launches, "verify_prompt_tokens": outs[0][:8], "ok": True,
            }
            emit(rec)
            rec["pos"] = [min(len(p) + MAX_NEW // 2, model.cfg.max_seq - 1)
                          for p in prompts[:SERVE_SLOTS]]
            rec["bucket"] = model.fit_bucket(max(lengths))
            return rec
        finally:
            if not boot.done():
                boot.cancel()
            await app.close()

    return asyncio.run(run())


def phase_kernel_times(serve: dict) -> dict:
    """Each kernel at the main path's shapes: kernel, plain version, one
    library call where there is one, and the bound."""
    import torch

    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV, D, BS, layers = 32, 8, 64, 16, 16
    out = {}
    # K1: one prefill at the largest bucket the served prompts used, one
    # input set per layer so no launch finds its inputs in L2
    S = serve["bucket"]
    sets = [_flash_inputs(S, H, KV, D, torch.bfloat16, seed=100 + i) for i in range(layers)]
    bhsd = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    nbytes = 2 * (2 * S * H * D + 2 * S * KV * D)
    flops = 4 * D * H * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    out["flash_attention"] = {
        "shape": {"B": 1, "S": S, "H": H, "KV": KV, "D": D, "dtype": "bfloat16"},
        "ms": time_ms(fa.flash_causal_attention_blhd, sets),
        "plain_ms": time_ms(lambda q, k, v: fa._attention_blhd_plain(q, k, v, True), sets, 5),
        "library_ms": time_ms(
            lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), bhsd),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }
    # K2: one decode step's read for the served slots at their mid-answer
    # positions, over the window bucket the scheduler picked; one pool per
    # layer, as in the model
    pos = serve["pos"]
    window = 64  # the scheduler's window bucket for these positions
    while window < max(pos) + SERVE_BLOCK + 1:
        window *= 2
    WB = window // BS
    NB = 1 + SERVE_SLOTS * WB
    sets = []
    for i in range(layers):
        (q, k, v, table, p), _ = _paged_inputs(SERVE_SLOTS, 1, H, KV, D, BS, NB, WB,
                                               torch.bfloat16, seed=200 + i, pos=pos)
        sets.append((q, k, v, table, p))
    # the function needs rows [0, pos] of each slot and the table entries
    # of the pages that hold them
    rows = sum(p + 1 for p in pos)
    pages = sum(p // BS + 1 for p in pos)
    nbytes = (2 * 2 * SERVE_SLOTS * H * D + 2 * 2 * rows * KV * D
              + 4 * pages + 4 * SERVE_SLOTS)
    flops = sum(4 * H * D * (p + 1) for p in pos)
    b_ms, b_by = bound(nbytes, flops)
    out["paged_decode_attention"] = {
        "shape": {"S": SERVE_SLOTS, "L": 1, "H": H, "KV": KV, "D": D, "BS": BS, "WB": WB,
                  "pos": pos, "dtype": "bfloat16"},
        "ms": time_ms(pa.paged_decode_attention, sets),
        "plain_ms": time_ms(pa.paged_decode_attention_plain, sets, 5),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }
    emit({"phase": "kernel_times", **out})
    return out


# each kernel's source and the TPU kernel it replaces (provenance strings;
# nothing of the JAX package is imported)
KERNELS = {
    "flash_attention": ("seldon_core_tpu_torch/csrc/flash_attention.cu",
                        "seldon_core_tpu/ops/flash_attention.py:86"),
    "paged_decode_attention": ("seldon_core_tpu_torch/csrc/paged_attention.cu",
                               "seldon_core_tpu/ops/paged_attention.py:109"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    phase_build()
    errs = phase_kernel_check()
    phase_reference()
    serve = phase_serve()
    times = phase_kernel_times(serve)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": origin,
         "launches": serve["launches"][name], "max_abs_err": errs[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"]}
        for name, (src, origin) in KERNELS.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
