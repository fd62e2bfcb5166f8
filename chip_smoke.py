#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``seldon_core_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: the CUDA kernels are compiled from ``seldon_core_tpu_torch/csrc``
   (one nvcc per source, all started together) and loaded; the line lists
   each kernel's registers, shared memory and spills (``ptxas -v``) and its
   ``HGMMA``/``HMMA`` count (``cuobjdump -sass``).
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card, at the main path's shapes (llama3-1b: H=32, KV=8, D=64, 16-row
   pages): flash attention at every prefill bucket, ragged and prime
   lengths, grouped and repeated K/V, strided views, no mask, other head
   dims, in bf16, f16 and f32; paged attention at 1-4 queries per slot,
   int8 pages, position 0, positions on and off page boundaries, one split
   and many, slots whose later splits are empty and rows that see nothing,
   and at head dim 128 (llama3-8b) and 8- and 32-row pages; and every
   query j of a verify pass (L = 4) must give the bits of a decode step
   (L = 1) at pos + j.
3. ``reference``: a 2-layer model at llama3-1b width in f32 on the card
   against the same weights on the CPU (plain versions): prefill logits,
   teacher-forced decode logits and greedy tokens over a float pool and
   over an int8 pool (16 steps; the int8 pool bytes equal but for a stated
   share of one-step rounding ties); then, on the card, a prompt whose
   first 2 blocks are already in the prefix index against the same prompt
   cold, and ``prefill_chunk=64`` over a 300-token prompt against the
   monolithic prefill (first-token logits, 16 greedy tokens, and the
   reuse and chunk counts those two must show; the same in bf16 is
   reported, not gated); and speculative decoding at ``spec_draft=3``
   with each proposer (``ngram``, ``heads`` made from the ``lm_head``,
   ``draft`` with ``truncate:1``): greedy streams on the card equal to
   speculation off on the card and to speculation on on the CPU, with a
   non-empty acceptance ledger.
4. ``serve``: the engine boots in-process on 127.0.0.1 with a
   ``JAX_GENERATIVE`` llama3-1b bf16 graph (seeded weights, 8 slots,
   16-step decode blocks, float pool) and answers concurrent strData
   requests over HTTP; the kernels' launch counts are read around this
   phase, and it fails unless every decode block cost exactly one host
   sync.
5. ``serve_cached``: the same graph with ``kv_cache_dtype=int8``,
   ``kv_prefix_reuse=true`` and ``prefill_chunk=256``: one warm request (a
   512-token prefix + 24), then a wave of six requests sharing that prefix
   and, 0.2 s later while they decode, two unshared ones of 1500 and 1900
   tokens that the scheduler paces chunk by chunk.  It fails unless every
   reply is 200 with 32 valid tokens, six prefills reused the prefix, a
   chunk was paced while streams decoded (``chunks_paced``; chunks run
   back to back with no live stream are not counted), each decode block
   cost one host sync and both kernels
   launched; it prints TTFT of the shared and the long requests, the
   block time after a paced chunk and without one, and the pool's bytes
   per 2048-token slot, int8 and bf16.
6. ``serve_spec``: the ``serve`` graph with ``spec_draft=3``, once per
   proposer (``ngram``; ``heads``; ``draft`` with ``truncate:auto``, 2 of
   16 layers; and ``draft`` with ``preset:llama3-1b`` seeded as the served
   weights, the model drafting for itself), each answering a wave of the
   ``serve`` prompts plus a repetitive one.  It fails unless each decode
   block cost one host sync, the paged kernel ran verify passes (L = 4),
   for ``draft`` flash attention prefilled the draft pool, the
   self-draft had drafts accepted, and every greedy stream equals the
   ``serve`` phase's bit for bit (bf16; the verify pass runs the ops
   whose rows the card rounds otherwise at 32 rows than at 8 once per
   query position); it prints accepted tokens per verify pass, ms per
   pass, wave tokens/s, TTFT, each stream's agreement, and (``ngram``)
   each verify row against a plain step at pos + j and which ops of a
   layer keep a row's bits at 32 rows.
7. ``serve_disagg``: two engines in one process over loopback HTTP, the
   ``serve`` graph with explicit ``kv_blocks``: A in the ``prefill`` role
   (``SCT_DISAGG_DECODE`` naming B) and B in the ``decode`` role.  The
   serve wave's distinct prompts through A's ``/disagg/generate`` must
   all answer ``mode == "disagg"`` with ``serve``'s streams bit for bit,
   with flash attention launched on A only and paged attention on B only;
   again with int8 pools against a unified int8 wave on B.  B refuses a
   frame of 8-row pages (409); a third engine C pulls a prompt's
   512-token prefix chain from A (``SCT_PREFIX_PEER_PULL=1``, the
   ``x-sct-prefix-peer`` header) and serves it from the peer tier with
   A's tokens; with B stopped, A answers ``unified-fallback`` with the
   same tokens and its free-block count back where it was.  Then the
   DRAM tier: ``prefix_dram_gb`` with a 128-block pool in which a
   1500-token prompt evicts a warmed 512-token prefix, promoted back for
   a prompt sharing it, must give the streams of a pool with room for
   all of it.  It prints handoff bytes per request, export and import
   ms, TTFT (client send to the decode engine's first token) and wave
   tokens/s beside ``serve``'s, and the DRAM tier's counters.
8. ``kernel_times``: each kernel's time at the main path's shapes and at a
   long one (flash at S=2048, paged at 8 slots near position 2000; paged
   also over int8 pages with bf16 scales at both, and at 4 queries per
   slot as a verify pass reads, beside the K/V bytes it reads) beside its plain
   version, one PyTorch library call where there is one, and the least
   time the card could take (its bound).  ``ms`` replays the launches
   from a CUDA graph; ``eager_ms`` launches them from Python one by one,
   as the eager decode step does; ``host_ms`` is the host's cost of one
   call.

Then the card's name and power limit (nvidia-smi), one line listing the
kernels (launches summed over the serve phases), and as the last line
``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero before that line.  Without CUDA, or without
the repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import importlib
import json
import os
import statistics
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
# The 16-bit flash kernel also rounds each probability once to the input's
# type before P.V (wgmma takes 16-bit operands): at most u = 2**-8 (bf16)
# or 2**-11 (f16) of each p, so its output may move by u * (P.|V|) more,
# with P.|V| from the plain version in f32.
P_ROUNDING = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
SERVE_PRESET = "llama3-1b"
SERVE_SLOTS = 8
SERVE_BLOCK = 16
MAX_NEW = 32
VERIFY_PROMPT = [5, 9, 2, 17, 3]
SERVE_LENGTHS = (5, 17, 64, 100, 211, 333, 480, 600)  # the wave's prompt lengths
LONG_POS = [1990, 1995, 2000, 2001, 2007, 1999, 2010, 2015]  # K2's long timing: near a 2048 window
# serve_cached: a shared 512-token prefix, six shared prompts' suffix
# lengths, two unshared long prompts chunked by 256 (6 and 8 chunks)
CACHED_PREFIX = 512
CACHED_CHUNK = 256
SHARED_SUFFIXES = (8, 17, 24, 33, 47, 64)
LONG_LENGTHS = (1500, 1900)
LONG_DELAY_S = 0.2
# speculation: draft length, the proposers' graph parameters, and the
# repetitive prompt added to the serve wave (a 40-token cycle of 8 tokens)
SPEC_DRAFT = 3
SPEC_METHODS = {
    "ngram": {"spec_method": ("ngram", "STRING")},
    "heads": {"spec_method": ("heads", "STRING"), "spec_heads": (SPEC_DRAFT, "INT")},
    "draft": {"spec_method": ("draft", "STRING"), "spec_draft_model": ("truncate:auto", "STRING")},
    # a preset draft seeded as the served weights are (rng 0): the model
    # drafts for itself, so drafts are accepted on the card at full width
    # (not a deployment: the draft costs what the model does)
    "draft_self": {"spec_method": ("draft", "STRING"),
                   "spec_draft_model": ("preset:" + SERVE_PRESET, "STRING")},
}
REPEAT_CYCLE, REPEAT_LEN = 8, 40
# int8 pools on the card and the CPU quantize K/V rounded ~1e-6 apart; a
# row whose x / scale sits that close to a half step rounds the other way.
# A flipped byte moves that element by one step and the next layer's K/V
# by more, so ties multiply with depth: at most this share of the int8
# bytes may differ, each by exactly one step.
INT8_TIE_SHARE = 0.01


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``arg_sets`` so that no launch finds its inputs in L2.  The
    launches are captured in one CUDA graph and replayed, so the host's cost
    of a call (``host_ms``) does not leave the card idle between them.  The
    warm-up runs on the capture stream, so that nothing a wrapper keeps per
    stream is first allocated inside the capture."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in arg_sets[:3]:
            fn(*args)
    _sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    _sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, arg_sets, iters: int = 20) -> float:
    """Mean time per call of ``iters`` eager calls of ``fn`` launched back to
    back, CUDA events around them (PR 1's ``time_ms``): where a call's host
    cost exceeds its kernel's time, this is what the eager decode step
    pays per call, not the kernel's own time."""
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


def host_ms(fn, arg_sets, iters: int = 50) -> float:
    """Mean host time of one eager call of ``fn`` (checks, allocation and
    the launch's enqueue): 50 calls never fill the launch queue, so the
    card's own time does not enter."""
    for args in arg_sets[:3]:
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    t1 = time.perf_counter()
    _sync()
    return (t1 - t0) * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want, tol: tuple[float, float], extra=None, **shape) -> dict:
    """``got`` against ``want`` within ``tol[0] + tol[1] * |want|``, plus
    ``extra`` (a tensor like ``want``) where a kernel rounds more than once."""
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output not finite at {shape}")
    err = (got.float() - want.float()).abs()
    limit = tol[0] + tol[1] * want.float().abs()
    if extra is not None:
        limit = limit + extra
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= limit).all())
    rec = {
        "kernel": name, **shape, "max_abs_err": max_abs,
        "max_rel_err": float((err / want.float().abs().clamp_min(1e-6)).max()) if err.numel() else 0.0,
        "max_err_over_limit": float((err / limit).max()) if err.numel() else 0.0,
        "atol": tol[0], "rtol": tol[1], "p_rounding": extra is not None, "ok": ok,
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
    seconds = time.perf_counter() - t0
    emit({
        "phase": "build", "seconds": seconds, "nvcc_seconds": _build.build_seconds,
        "sources": [f"seldon_core_tpu_torch/csrc/{s}" for s in _build.SOURCES],
        "kernels": _build.kernel_report(),
    })


def _flash_inputs(S, H, KV, D, dtype, seed, B=1):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
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


PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)  # llama3-1b, max_seq 2048


def _flash_cases():
    """(dtype name, case) for every flash check: ``case`` holds the entry
    (``blhd`` or ``bhsd``), shapes and how q/k/v are laid out."""
    cases = []
    for dn in ("bfloat16", "float16", "float32"):
        lengths = PREFILL_BUCKETS + (100, 257) if dn == "bfloat16" else (16, 100, 257, 2048)
        for S in lengths:
            cases.append((dn, {"entry": "blhd", "S": S, "H": 32, "KV": 8, "D": 64}))
        cases += [
            (dn, {"entry": "blhd", "S": 257, "H": 32, "KV": 32, "D": 64}),  # K/V repeated to H
            (dn, {"entry": "blhd", "S": 257, "H": 32, "KV": 8, "D": 64, "fused": True}),
            (dn, {"entry": "bhsd", "S": 257, "Sk": 257, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "bhsd", "S": 100, "Sk": 257, "H": 32, "KV": 8, "D": 64}),
            (dn, {"entry": "blhd", "S": 300, "H": 16, "KV": 4, "D": 128, "B": 2}),
            (dn, {"entry": "blhd", "S": 150, "H": 8, "KV": 2, "D": 32}),
            (dn, {"entry": "blhd", "S": 70, "H": 4, "KV": 4, "D": 16}),
        ]
    return cases


def _flash_check(fa, dn, case, seed):
    """One flash case against the plain version in f32 on the same inputs."""
    import torch

    dtype = getattr(torch, dn)
    S, H, KV, D, B = case["S"], case["H"], case["KV"], case["D"], case.get("B", 1)
    if case["entry"] == "bhsd":  # (B, H, S, D), no mask, Sq may differ from Sk
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(B, H, S, D, generator=g, device="cuda").to(dtype)
        k = torch.randn(B, KV, case["Sk"], D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, KV, case["Sk"], D, generator=g, device="cuda").to(dtype)
        got = fa.flash_attention(q, k, v, causal=False)
        want = fa.flash_attention_plain(_f32(q), _f32(k), _f32(v), causal=False)
        pv = fa.flash_attention_plain(_f32(q), _f32(k), _f32(v).abs(), causal=False)
    else:
        if case.get("fused"):  # strided views into one (B, S, H + 2 KV, D) projection
            g = torch.Generator(device="cuda").manual_seed(seed)
            qkv = torch.randn(B, S, H + 2 * KV, D, generator=g, device="cuda").to(dtype)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
        else:
            q, k, v = _flash_inputs(S, H, KV, D, dtype, seed=seed, B=B)
        got = fa.flash_causal_attention_blhd(q, k, v)
        want = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v), True)
        pv = fa._attention_blhd_plain(_f32(q), _f32(k), _f32(v).abs(), True)
    if dn == "float32":
        return compare("flash_attention", got, want, F32_TOL, dtype=dn, **case)
    return compare("flash_attention", got, want, BF16_TOL, P_ROUNDING[dn] * pv, dtype=dn, **case)


def _paged_cases():
    """(dtype name, case) for every paged check: llama3-1b heads (H=32,
    KV=8, D=64) over 16-row pages unless ``case`` names another head dim
    (``D``, 128 is llama3-8b's) or page size (``BS``)."""
    boundary = [15, 16, 17, 31, 32, 0, 1, 47]  # on and off 16-row page edges
    mixed = [0, 3, 40, 300, 1000, 2040, 17, 2000]  # short slots leave later splits empty
    idle = [-1, 500, -1, 1000, 7, -1, 31, 2000]  # -1: an inactive slot sees nothing
    cases = []
    for dn in ("bfloat16", "float32"):  # llama3-8b's head dim
        cases += [
            (dn, {"L": 1, "WB": 64, "D": 128}),
            (dn, {"L": 3, "WB": 128, "D": 128, "pos": mixed}),
            (dn, {"L": 1, "WB": 64, "D": 128, "quant": True}),
            (dn, {"L": 1, "WB": 128, "D": 128, "pos": idle}),
        ]
    for BS, WB in ((32, 64), (8, 256)):  # other page sizes at D=64
        cases += [
            ("bfloat16", {"L": 1, "WB": WB, "BS": BS, "pos": mixed}),
            ("bfloat16", {"L": 2, "WB": 4, "BS": BS,
                          "pos": [BS - 1, BS, BS + 1, 2 * BS - 1, 2 * BS, 0, 1, 3 * BS - 1]}),
            ("bfloat16", {"L": 3, "WB": WB, "BS": BS, "pos": mixed, "quant": True}),
            ("float16", {"L": 1, "WB": WB, "BS": BS, "quant": True}),
            ("bfloat16", {"L": 1, "WB": WB, "BS": BS, "pos": idle}),
            ("float32", {"L": 2, "WB": WB, "BS": BS, "pos": [p if p >= 0 else -3 for p in idle]}),
        ]
    for dn in ("bfloat16", "float32", "float16"):
        cases += [(dn, {"L": L, "WB": 64}) for L in ((1, 2, 3, 4) if dn == "bfloat16" else (1, 3))]
        cases += [
            (dn, {"L": 1, "WB": 64, "quant": True}),
            (dn, {"L": 3, "WB": 64, "quant": True}),
            (dn, {"L": 1, "WB": 64, "pos": [0] * 8}),
            (dn, {"L": 2, "WB": 8, "pos": boundary}),
            (dn, {"L": 1, "WB": 2}),  # a window of 2 pages: one split
            (dn, {"L": 1, "WB": 128, "pos": mixed}),
            (dn, {"L": 4, "WB": 128, "pos": mixed, "quant": True}),
            (dn, {"L": 1, "WB": 128, "pos": idle}),
            (dn, {"L": 3, "WB": 128, "pos": [p if p >= 0 else -2 for p in idle]}),
        ]
    return cases


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
    for i, (dn, case) in enumerate(_flash_cases()):
        rec = _flash_check(fa, dn, case, seed=i)
        checks.append(rec)
        if dn == "bfloat16" and case == {"entry": "blhd", "S": 1024, "H": 32, "KV": 8, "D": 64}:
            main_err["flash_attention"] = rec["max_abs_err"]
    H, KV = 32, 8
    for i, (dn, case) in enumerate(_paged_cases()):
        dtype = getattr(torch, dn)
        WB, L, D, BS = case["WB"], case["L"], case.get("D", 64), case.get("BS", 16)
        args, kw = _paged_inputs(8, L, H, KV, D, BS, 1 + 8 * WB, WB, dtype, seed=1000 + i,
                                 quant=case.get("quant", False), pos=case.get("pos"))
        got = pa.paged_decode_attention(*args, **kw)
        want = pa.paged_decode_attention_plain(
            *map(_f32, args), **{n: _f32(x) for n, x in kw.items()})
        splits, per = pa.plan_splits(WB)
        rec = compare("paged_decode_attention", got, want, F32_TOL if dn == "float32" else BF16_TOL,
                      S=8, H=H, KV=KV, splits=splits, per=per, dtype=dn,
                      **{"D": D, "BS": BS, **case})
        checks.append(rec)
        if dn == "bfloat16" and case == {"L": 1, "WB": 64}:
            main_err["paged_decode_attention"] = rec["max_abs_err"]
    # a slot's result must not follow the window width (which follows the
    # batch's longest slot): the same pages under a 64- and a 128-entry
    # window give the same bits
    args, _ = _paged_inputs(8, 1, H, KV, 64, 16, 1 + 8 * 128, 128, torch.bfloat16, seed=999,
                            pos=[5, 100, 333, 500, 777, 900, 1000, 1015])
    q, k, v, table, pos = args
    narrow = pa.paged_decode_attention(q, k, v, table[:, :64].contiguous(), pos)
    wide = pa.paged_decode_attention(q, k, v, table, pos)
    if not torch.equal(narrow, wide):
        raise AssertionError("paged attention's result follows the window width")
    checks.append({"kernel": "paged_decode_attention", "window_invariant": True, "WB": [64, 128],
                   "max_abs_err": 0.0, "max_err_over_limit": 0.0})
    # every query j of a verify pass (chunk j of 4 at 4 query heads per KV
    # head) must give the bits of a decode step (L = 1) at pos + j, also
    # where pos + j starts another page or split: greedy speculation
    # equals speculation off on it
    for dn, quant in (("bfloat16", False), ("bfloat16", True), ("float32", False)):
        args, kw = _paged_inputs(8, 1 + SPEC_DRAFT, H, KV, 64, 16, 1 + 8 * 64, 64,
                                 getattr(torch, dn), seed=997, quant=quant,
                                 pos=[125, 126, 127, 13, 300, 511, 0, 1020])
        q, k, v, table, pos = args
        verify = pa.paged_decode_attention(q, k, v, table, pos, **kw)
        for j in range(1 + SPEC_DRAFT):
            one = pa.paged_decode_attention(q[:, j:j + 1].contiguous(), k, v, table,
                                            (pos + j).to(torch.int32), **kw)
            if not torch.equal(one[:, 0], verify[:, j]):
                raise AssertionError(f"paged attention's query {j} at L={1 + SPEC_DRAFT} is not "
                                     f"the L=1 result at pos+{j} ({dn}, int8 pages: {quant})")
        checks.append({"kernel": "paged_decode_attention", "rows_bit_equal": True, "dtype": dn,
                       "quant": quant, "L": [1, 1 + SPEC_DRAFT], "max_abs_err": 0.0,
                       "max_err_over_limit": 0.0})
    _sync()
    worst = max(checks, key=lambda r: r["max_err_over_limit"])
    # one short entry per case: the shape keys, the largest error, err/limit
    skip = {"kernel", "max_abs_err", "max_rel_err", "max_err_over_limit", "atol", "rtol",
            "p_rounding", "ok"}
    emit({"phase": "kernel_check", "cases": len(checks), "ok": True,
          "max_err_over_limit": worst["max_err_over_limit"], "worst_case": worst,
          "checks": [
              f"{r['kernel']} " + " ".join(f"{k}={v}" for k, v in r.items() if k not in skip)
              + f" err={r['max_abs_err']:.3g} err/limit={r['max_err_over_limit']:.3g}"
              for r in checks]})
    return main_err


def _card_vs_cpu(cfg, params: dict, prompt, device: str, steps: int,
                 kv_dtype: str | None = None) -> dict:
    """Prefill ``prompt`` and run ``steps`` decode steps on the CPU and on
    ``device`` with the same weights, both fed the card's greedy tokens;
    returns the logits of each, each side's greedy tokens and the pools."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    n = len(prompt)
    bucket = 16
    while bucket < n:
        bucket *= 2
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    row = np.zeros(cfg.max_seq // 16, np.int32)
    row[:10] = np.arange(1, 11)
    caches = {d: llama.init_paged_cache(cfg, 2, 24, 16, device=d, kv_dtype=kv_dtype)
              for d in ("cpu", device)}
    logits = {}
    for d in ("cpu", device):
        lg, _ = llama.prefill_slot_paged(
            params[d], torch.from_numpy(padded).to(d), n, 0, row, caches[d], cfg
        )
        logits[d] = [lg.float().cpu()]
    toks = {"cpu": [], device: []}
    feed = int(torch.argmax(logits[device][0]))
    active = torch.tensor([True, False])
    for _ in range(steps):
        for d in ("cpu", device):
            lg, _ = llama.decode_slots_paged(
                params[d], torch.tensor([feed, 0], dtype=torch.int32, device=d), caches[d],
                active.to(d), cfg, window=256,
            )
            logits[d].append(lg[0].float().cpu())
            toks[d].append(int(torch.argmax(lg[0])))
        feed = toks[device][-1]  # both devices see the same tokens
    err = max(float((a - b).abs().max()) for a, b in zip(logits["cpu"], logits[device]))
    scale = max(float(a.abs().max()) for a in logits["cpu"])
    return {"err": err, "scale": scale, "greedy_equal": toks["cpu"] == toks[device],
            "caches": caches}


def _first_and_greedy(model, slot: int, prompt, steps: int = 16):
    """Admit ``prompt`` into ``slot`` of a GenerativeModel and decode
    ``steps`` greedy tokens; returns the first token's logits (the last
    prefill call's, read where the model samples them) and the tokens."""
    import numpy as np

    caught = []
    sample = model._sample_first

    def keep(logits, payload):
        caught.append(logits.float().cpu())
        return sample(logits, payload)

    model._sample_first = keep
    try:
        first = model.admit(slot, np.asarray(prompt, np.int32), 0.0, 0, reserve_tokens=steps + 1)
    finally:
        del model._sample_first
    S = model.n_slots
    active = np.zeros(S, bool)
    active[slot] = True
    cur = np.zeros(S, np.int32)
    cur[slot] = first
    toks, _ = model.step_k(cur, active, np.zeros(S, np.float32), 0, np.full(S, -1, np.int32),
                           np.full(S, steps, np.int32), steps)
    return caught[-1], [first] + toks[:, slot].tolist()


def _reuse_and_chunk_checks(cfg, params, device: str) -> list[dict]:
    """On the card: a prompt whose first 2 blocks are in the prefix index
    against the same prompt cold, and ``prefill_chunk=64`` over a 300-token
    prompt against the monolithic prefill.  The cold and monolithic
    prefills run flash attention (K1), the suffix prefills torch matmuls.
    Each check also holds the model's counters to what it must have done
    (one reuse of 32 tokens; five 64-token chunks), so that a cold prefill
    is never compared with a cold prefill."""
    import numpy as np

    from seldon_core_tpu_torch.executor.generation import GenerativeModel

    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 32).tolist()  # 2 blocks of 16
    prompt = prefix + rng.integers(0, cfg.vocab_size, 68).tolist()  # 100 tokens
    long_prompt = rng.integers(0, cfg.vocab_size, 300).tolist()

    def model(**kw):
        return GenerativeModel(cfg, params, n_slots=2, decode_block=16, device=device, **kw)

    out = []
    cold = _first_and_greedy(model(), 1, prompt)
    warm_model = model(prefix_reuse=True)
    warm_model.admit(0, np.asarray(prefix + rng.integers(0, cfg.vocab_size, 9).tolist(),
                                   np.int32), 0.0, 0)
    warm_model.release_slot(0)  # its 2 full blocks go into the index
    warm = _first_and_greedy(warm_model, 1, prompt)
    out.append(("prefix_reuse", cold, warm,
                {"prefills_reused": warm_model.prefills_reused,
                 "tokens_reused": warm_model.prefix_snapshot()["tokens_reused"]},
                {"prefills_reused": 1, "tokens_reused": 32}))
    mono = _first_and_greedy(model(), 1, long_prompt)
    chunk_model = model(prefill_chunk=64)
    chunked = _first_and_greedy(chunk_model, 1, long_prompt)
    out.append(("chunked", mono, chunked, {"prefill_chunks": chunk_model.prefill_chunks},
                {"prefill_chunks": 5}))
    recs = []
    for name, (want_lg, want_toks), (got_lg, got_toks), counts, want_counts in out:
        err = float((want_lg - got_lg).abs().max())
        scale = float(want_lg.abs().max())
        tol = 1e-3 * max(1.0, scale)
        recs.append({"check": name, "first_logit_err": err, "logit_scale": scale, "tol": tol,
                     "greedy_equal": want_toks == got_toks, "tokens": got_toks[:8], **counts,
                     "counts_want": want_counts, "counts_ok": counts == want_counts,
                     "ok": err <= tol and want_toks == got_toks and counts == want_counts})
    return recs


def phase_reference(device: str = "cuda") -> None:
    """The model at llama3-1b head geometry (2 layers, f32) on ``device``
    against the same weights on the CPU, where the plain versions run:
    prefill logits, then teacher-forced decode logits and greedy tokens,
    over a float pool and an int8 pool; then prefix reuse against a cold
    prefill and chunked against monolithic prefill, on the card."""
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
    params = {"cpu": cpu, device: dev}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 100).astype(np.int32)
    flt = _card_vs_cpu(cfg, params, prompt, device, 8)
    tol = 1e-3 * max(1.0, flt["scale"])
    rec = {"phase": "reference", "config": "llama3-1b heads, 2 layers, f32",
           "prefill_len": 100, "decode_steps": 8, "max_abs_logit_err": flt["err"],
           "logit_scale": flt["scale"], "tol": tol, "greedy_equal": flt["greedy_equal"]}
    rec["ok"] = flt["err"] <= tol and rec["greedy_equal"]
    q = _card_vs_cpu(cfg, params, prompt, device, 16, kv_dtype="int8")
    qtol = 1e-3 * max(1.0, q["scale"])
    flips, written, worst = 0, 0, 0
    for key in ("k", "v"):
        a, b = (q["caches"][d][key].cpu().int() for d in ("cpu", device))
        flips += int((a != b).sum())
        worst = max(worst, int((a - b).abs().max()))
        written += int((a != 0).sum())
    scale_err = max(float((q["caches"]["cpu"][k] - q["caches"][device][k].cpu()).abs().max())
                    for k in ("k_scale", "v_scale"))
    rec["int8"] = {
        "prefill_len": 100, "decode_steps": 16, "max_abs_logit_err": q["err"],
        "logit_scale": q["scale"], "tol": qtol, "greedy_equal": q["greedy_equal"],
        "bytes_written": written, "bytes_differing": flips, "max_byte_diff": worst,
        "tie_share_limit": INT8_TIE_SHARE, "max_abs_scale_err": scale_err,
        "ok": (q["err"] <= qtol and q["greedy_equal"] and worst <= 1
               and flips <= INT8_TIE_SHARE * written),
    }
    rcfg = dataclasses.replace(cfg, max_seq=512)
    rec["card_only"] = _reuse_and_chunk_checks(rcfg, dev, device)
    rec["ok"] = rec["ok"] and rec["int8"]["ok"] and all(r["ok"] for r in rec["card_only"])
    # the same in bf16 (the served dtype), reported and not gated: K1 rounds
    # probabilities to bf16 where the suffix's matmuls do not
    bf16 = init_params(cfg, torch.Generator(device="cpu").manual_seed(1), device="cpu").to(
        device=device, dtype=torch.bfloat16)
    rec["card_only_bf16"] = [
        {**{k: v for k, v in r.items() if k != "ok"}, "within_tol": r["ok"], "gated": False}
        for r in _reuse_and_chunk_checks(rcfg, bf16, device)]
    del bf16
    rec["spec"] = _spec_reference(cfg, cpu, dev, device)
    rec["ok"] = rec["ok"] and all(r["ok"] for r in rec["spec"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the model on the card disagrees with its reference")


def _streams(model, prompts, max_new: int) -> list[list[int]]:
    """Greedy streams of ``prompts``, submitted together to a scheduler
    over ``model``."""
    import numpy as np

    from seldon_core_tpu_torch.executor.generation import GenerationScheduler

    sched = GenerationScheduler(model)

    async def go():
        try:
            return await asyncio.gather(*(
                sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new) for p in prompts))
        finally:
            await sched.close()

    return [o.tolist() for o in asyncio.run(go())]


def _spec_reference(cfg, cpu, dev, device: str) -> list[dict]:
    """Speculative decoding (``spec_draft=3``) with each proposer, f32:
    greedy streams on the card against speculation off on the card and
    against speculation on on the CPU.  The heads are made once on the CPU
    from the ``lm_head`` and carried to both devices."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.executor.generation import GenerativeModel
    from seldon_core_tpu_torch.models import llama

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 100).tolist(),
               np.tile(rng.integers(0, cfg.vocab_size, REPEAT_CYCLE),
                       REPEAT_LEN // REPEAT_CYCLE).tolist()]
    max_new = 24
    heads = llama.init_medusa_heads(torch.Generator().manual_seed(2), cfg, SPEC_DRAFT,
                                    base_head=cpu.head)
    methods = {"ngram": {}, "heads": {"spec_method": "heads", "medusa_heads": heads},
               "draft": {"spec_method": "draft", "spec_draft_model": "truncate:1"}}

    def model(params, d, **kw):
        return GenerativeModel(cfg, params, n_slots=2, decode_block=16, device=d, **kw)

    off = _streams(model(dev, device), prompts, max_new)
    recs = []
    for name, kw in methods.items():
        on_model = model(dev, device, spec_draft=SPEC_DRAFT, **kw)
        on = _streams(on_model, prompts, max_new)
        on_cpu = _streams(model(cpu, "cpu", spec_draft=SPEC_DRAFT, **kw), prompts, max_new)
        snap = on_model.spec_snapshot()
        recs.append({
            "method": name, "spec_draft": SPEC_DRAFT, "prompt_lens": [len(p) for p in prompts],
            "max_new_tokens": max_new, "equal_spec_off_card": on == off,
            "equal_spec_on_cpu": on == on_cpu, "tokens": [o[:8] for o in on],
            "spec_verify_passes": snap["spec_verify_passes"],
            "spec_emitted_tokens": snap["spec_emitted_tokens"],
            "accepted_tokens_per_step": snap["accepted_tokens_per_step"],
            "ok": (on == off and on == on_cpu and snap["spec_verify_passes"] > 0
                   and snap["spec_emitted_tokens"] >= snap["spec_verify_passes"]),
        })
    return recs


def _post(port: int, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v0.1/predictions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _call(port: int, path: str, body, headers: dict | None = None,
          timeout: float = 600.0) -> tuple[int, bytes]:
    """POST ``body`` (a dict as JSON, or bytes) to ``path`` -> (status, body)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def phase_serve(device: str = "cuda", preset: str = SERVE_PRESET,
                lengths=SERVE_LENGTHS, seed: int = 0) -> dict:
    """Boot the engine in-process and answer concurrent strData requests over
    HTTP; returns what the kernel lines need (launch counts, main-path
    shapes)."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build

    spec = _serve_spec(preset, seed)
    rng = np.random.default_rng(seed)

    async def run() -> dict:
        app, boot_s = await _boot(spec, device)
        port = app.port
        try:
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
            ttft = sorted(t for _, t in app.service.walker.component.scheduler.ttft)
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
                "launches": launches, "verify_prompt_tokens": outs[0][:8],
                # the decode contract: exactly one host sync per decode block
                "ok": blocks > 0 and syncs == blocks,
            }
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(
                    f"{syncs} host syncs over {blocks} decode blocks; the contract is one each")
            rec["pos"] = [min(len(p) + MAX_NEW // 2, model.cfg.max_seq - 1)
                          for p in prompts[:SERVE_SLOTS]]
            rec["bucket"] = model.fit_bucket(max(lengths))
            # the distinct prompts and their streams, for serve_spec
            rec["prompts"], rec["outs"] = prompts[:-1], outs[:len(prompts) - 1]
            return rec
        finally:
            await app.close()

    return asyncio.run(run())


def _serve_spec(preset: str, seed: int, **extra):
    """The smoke's ``JAX_GENERATIVE`` graph: llama ``preset`` in bf16 with
    seeded weights, 8 slots, 16-step blocks, 32 new tokens; ``extra`` adds
    graph parameters (name -> (value, type))."""
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    params = {"family": ("llama", "STRING"), "preset": (preset, "STRING"),
              "dtype": ("bfloat16", "STRING"), "n_slots": (SERVE_SLOTS, "INT"),
              "decode_block": (SERVE_BLOCK, "INT"), "max_new_tokens": (MAX_NEW, "INT"),
              "rng": (seed, "INT"), **extra}
    return PredictorSpec.from_dict({
        "name": "smoke",
        "graph": {
            "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [{"name": k, "value": str(v), "type": t}
                           for k, (v, t) in params.items()],
        },
    })


async def _boot(spec, device: str, **engine):
    """Start the engine (``engine``: its role and decode peers) on a free
    port and wait until it is ready (warmup included); returns the app and
    the seconds that took."""
    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService

    app = EngineApp(PredictionService(spec, device=device), **engine)
    await app.start("127.0.0.1", 0)
    t0 = time.perf_counter()
    boot = asyncio.create_task(app.boot())
    try:
        while await asyncio.to_thread(_get, app.port, "/ready") != 200:
            if boot.done():
                boot.result()  # raises the boot failure
            await asyncio.sleep(0.2)
    except BaseException:
        boot.cancel()
        await app.close()
        raise
    await boot
    return app, time.perf_counter() - t0


def _check_replies(replies, prompts, vocab: int) -> list[list[int]]:
    outs = []
    for (status, body), p in zip(replies, prompts):
        if status != 200 or body["status"]["code"] != 200:
            raise AssertionError(f"request failed: {body}")
        toks = json.loads(body["strData"])["tokens"]
        if len(toks) != MAX_NEW or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"bad reply for a {len(p)}-token prompt: {toks}")
        outs.append(toks)
    return outs


def _record_blocks(model) -> list:
    """Log, on ``model``'s instance, each decode block (with its seconds)
    and each admission and paced chunk dispatched before it."""
    events = []
    step_k, admit, chunk = model.step_k, model.admit_dispatch, model.prefill_chunk_dispatch

    def logged_step(*a, **kw):
        out = step_k(*a, **kw)
        events.append(("block", model.last_block_s))
        return out

    def logged_admit(*a, **kw):
        events.append(("admit", None))
        return admit(*a, **kw)

    def logged_chunk(*a, **kw):
        t0 = time.perf_counter()
        out = chunk(*a, **kw)
        events.append(("chunk", time.perf_counter() - t0))  # host time, no sync
        return out

    model.step_k, model.admit_dispatch, model.prefill_chunk_dispatch = (
        logged_step, logged_admit, logged_chunk)
    return events


def _block_times(events) -> dict:
    """Mean decode-block milliseconds after nothing else was dispatched since
    the previous block, and after exactly one paced chunk (and no
    admission); and the host's mean time to dispatch a chunk."""
    clean, after_chunk, since = [], [], []
    chunk_s = [sec for kind, sec in events if kind == "chunk"]
    for kind, sec in events:
        if kind != "block":
            since.append(kind)
            continue
        if not since:
            clean.append(sec)
        elif since == ["chunk"]:
            after_chunk.append(sec)
        since = []

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return {"blocks_clean": len(clean), "block_ms_clean": 1e3 * mean(clean) if clean else None,
            "blocks_after_chunk": len(after_chunk),
            "block_ms_after_chunk": 1e3 * mean(after_chunk) if after_chunk else None,
            "chunk_dispatch_ms": 1e3 * mean(chunk_s) if chunk_s else None}


def phase_serve_cached(device: str = "cuda", preset: str = SERVE_PRESET, seed: int = 1) -> dict:
    """The serve graph with int8 KV, prefix reuse and chunked prefill: a warm
    request, then six prompts sharing its 512-token prefix and, while they
    decode, two long unshared ones.  Returns the kernels' launch counts."""
    import numpy as np

    from seldon_core_tpu_torch.models import llama
    from seldon_core_tpu_torch.ops import _build

    spec = _serve_spec(preset, seed, kv_cache_dtype=("int8", "STRING"),
                       kv_prefix_reuse=("true", "BOOL"), prefill_chunk=(CACHED_CHUNK, "INT"))
    rng = np.random.default_rng(seed)

    async def run() -> dict:
        app, boot_s = await _boot(spec, device)
        port = app.port
        try:
            comp = app.service.walker.component
            model, sched = comp.model, comp.scheduler
            vocab = model.cfg.vocab_size
            prefix = rng.integers(0, vocab, CACHED_PREFIX).tolist()
            warm = prefix + rng.integers(0, vocab, 24).tolist()
            shared = [prefix + rng.integers(0, vocab, n).tolist() for n in SHARED_SUFFIXES]
            longs = [rng.integers(0, vocab, n).tolist() for n in LONG_LENGTHS]

            def body(p):
                return {"strData": json.dumps({"tokens": p, "max_new_tokens": MAX_NEW})}

            _check_replies([await asyncio.to_thread(_post, port, body(warm))], [warm], vocab)
            events = _record_blocks(model)
            _build.reset_launches()  # this phase's run starts here
            before = {
                "blocks": model.decode_blocks, "syncs": model.host_syncs, "steps": model.steps,
                "block_s": model.block_seconds, "reused": model.prefills_reused,
                "tokens_reused": model.prefix_snapshot()["tokens_reused"],
                "paced": sched.chunks_paced, "chunks": model.prefill_chunks,
                "ttft": len(sched.ttft),
            }
            loop = asyncio.get_running_loop()
            t1 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(shared) + len(longs)) as clients:
                first = [loop.run_in_executor(clients, _post, port, body(p)) for p in shared]
                await asyncio.sleep(LONG_DELAY_S)  # the shared streams are decoding by now
                late = [loop.run_in_executor(clients, _post, port, body(p)) for p in longs]
                replies = await asyncio.gather(*first, *late)
            wave_s = time.perf_counter() - t1
            launches = dict(_build.LAUNCHES)
            _check_replies(replies, shared + longs, vocab)
            snap = model.prefix_snapshot()
            blocks = model.decode_blocks - before["blocks"]
            syncs = model.host_syncs - before["syncs"]
            steps = model.steps - before["steps"]
            ttft = list(sched.ttft)[before["ttft"]:]
            t_shared = sorted(t for n, t in ttft if n < min(LONG_LENGTHS))
            t_long = sorted(t for n, t in ttft if n >= min(LONG_LENGTHS))
            missing = [k for k, n in launches.items() if n == 0]
            rec = {
                "phase": "serve_cached", "preset": preset, "dtype": "bfloat16",
                "kv_cache_dtype": model.kv_dtype, "prefill_chunk": model.prefill_chunk,
                "kv_prefix_reuse": model.prefix_index is not None, "n_slots": SERVE_SLOTS,
                "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                "prompt_lens": [len(p) for p in shared + longs], "warm_prompt_len": len(warm),
                "long_delay_s": LONG_DELAY_S, "boot_and_warmup_s": boot_s, "wave_s": wave_s,
                "ttft_s_shared_p50": statistics.median(t_shared), "ttft_s_shared_max": t_shared[-1],
                "ttft_s_long_p50": statistics.median(t_long), "ttft_s_long_max": t_long[-1],
                "ttft_s_long": t_long,
                "wave_tokens_per_s": (len(shared) + len(longs)) * MAX_NEW / wave_s,
                "decode_step_ms": 1e3 * (model.block_seconds - before["block_s"]) / max(1, steps),
                **_block_times(events),
                "prefills_reused": model.prefills_reused - before["reused"],
                "tokens_reused": snap["tokens_reused"] - before["tokens_reused"],
                "prefill_chunks": model.prefill_chunks - before["chunks"],
                "chunks_paced": sched.chunks_paced - before["paced"],
                "decode_blocks": blocks, "host_syncs": syncs,
                "host_syncs_per_block": syncs / max(1, blocks), "launches": launches,
                "kv_bytes_per_2048_slot": {
                    "int8": model.kv_bytes_per_slot(),
                    "bfloat16": llama.paged_kv_slot_bytes(model.cfg, model.kv_block_size,
                                                          dtype="bfloat16"),
                },
                "kv_slots_per_card": model.kv_slots_per_chip(),
            }
            rec["ok"] = (rec["prefills_reused"] >= len(shared)
                         and rec["tokens_reused"] >= len(shared) * CACHED_PREFIX
                         and rec["chunks_paced"] >= 1 and blocks > 0 and syncs == blocks
                         and not missing)
            emit(rec)
            if not rec["ok"]:
                raise AssertionError(
                    "serve_cached: reuse, pacing, one host sync per block or a kernel's "
                    f"launch is missing (kernels never launched: {missing})")
            return rec
        finally:
            await app.close()

    return asyncio.run(run())


def _divergence(model, prompt, off, on) -> dict:
    """Where greedy stream ``on`` first leaves ``off``, and the logits gap
    there: logit(off's token) - logit(on's token) from one dense prefill of
    ``prompt`` + ``off``'s tokens before that point (the model's dtype)."""
    import torch

    from seldon_core_tpu_torch.models import llama

    i = next((j for j, (a, b) in enumerate(zip(off, on)) if a != b), None)
    if i is None:
        return {"equal_tokens": len(off), "first_divergence": None, "logit_gap": None}
    toks = torch.tensor([list(prompt) + list(off[:i])], dtype=torch.int32, device=model.device)
    logits = llama.forward(model.params, toks, model.cfg)[0, -1].float()
    return {"equal_tokens": i, "first_divergence": i,
            "logit_gap": float(logits[off[i]] - logits[on[i]]),
            "logit_scale": float(logits.abs().max())}


def _verify_rows_vs_steps(model) -> dict:
    """A verify pass (L = 1 + SPEC_DRAFT) against L plain decode steps fed
    the pass's tokens, on copies of one pool, with ``model``'s weights,
    dtype and ``row_split`` (SERVE_SLOTS slots at positions 100-121): for
    each query j whether its logits are the step's at pos + j bit for bit,
    and the pools' bytes after; the same pass with no op split, for
    comparison; and which ops of a layer and the ``lm_head`` keep a row's
    bits at SERVE_SLOTS * L rows against SERVE_SLOTS."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models import llama

    cfg, dev, S, L = model.cfg, model.device, SERVE_SLOTS, 1 + SPEC_DRAFT
    rng = np.random.default_rng(5)
    cache = llama.init_paged_cache(cfg, S, 1 + S * 8, 16, dtype=model.dtype, device=dev)
    for slot in range(S):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128)).astype(np.int32))
        row = np.zeros(cfg.max_seq // 16, np.int32)
        row[:8] = 1 + 8 * slot + np.arange(8)
        llama.prefill_slot_paged(model.params, toks.to(dev), 100 + 3 * slot, slot, row, cache, cfg)
    qtok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, L)).astype(np.int32)).to(dev)
    act = torch.ones(S, dtype=torch.bool, device=dev)
    valid = torch.ones(S, L, dtype=torch.bool, device=dev)

    def verify(row_split):
        pool = {k: v.clone() for k, v in cache.items()}
        out, _ = llama.decode_slots_spec_paged(model.params, qtok, pool, act, valid, cfg,
                                               window=128, row_split=row_split)
        return out, pool

    stepped = {k: v.clone() for k, v in cache.items()}
    steps = []
    for j in range(L):
        out, _ = llama.decode_slots_paged(model.params, qtok[:, j].contiguous(), stepped, act, cfg,
                                          window=128)
        steps.append(out)
    recs = {}
    for name, split in (("row_split", model._row_split), ("unsplit", frozenset())):
        out, pool = verify(split)
        diffs = [float((steps[j].float() - out[:, j].float()).abs().max()) for j in range(L)]
        recs[name] = {
            "ops": sorted(split),
            "rows_bit_equal": [bool(torch.equal(steps[j], out[:, j])) for j in range(L)],
            "max_abs_logit_diff": diffs,
            "argmax_equal": [int((steps[j].argmax(-1) == out[:, j].argmax(-1)).sum())
                             for j in range(L)],
            "pool_bit_equal": all(torch.equal(pool[k][:, 1:], stepped[k][:, 1:])
                                  for k in ("k", "v")),
        }
    variant = llama.row_variant_ops(cfg, S, L, model.dtype, dev)
    return {"dtype": str(model.dtype).replace("torch.", ""), "slots": S, "L": L, **recs,
            "logit_scale": float(steps[0].float().abs().max()),
            "ops_rows_bit_equal": {op: op not in variant for op in llama.ROW_OPS},
            "bit_equal": all(recs["row_split"]["rows_bit_equal"])
            and recs["row_split"]["pool_bit_equal"]}


def phase_serve_spec(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                     seed: int = 0) -> dict:
    """The serve graph with ``spec_draft=3``, once per proposer: the serve
    wave's prompts plus a repetitive one, concurrently.  Returns the
    kernels' launch counts summed over the runs."""
    import numpy as np

    from seldon_core_tpu_torch.ops import _build

    total = {name: 0 for name in KERNELS}
    for method, extra in SPEC_METHODS.items():
        spec = _serve_spec(preset, seed, spec_draft=(SPEC_DRAFT, "INT"), **extra)

        async def run() -> dict:
            app, boot_s = await _boot(spec, device)
            port = app.port
            try:
                comp = app.service.walker.component
                model, sched = comp.model, comp.scheduler
                vocab = model.cfg.vocab_size
                rng = np.random.default_rng(seed + 100)
                repeat = np.tile(rng.integers(0, vocab, REPEAT_CYCLE),
                                 REPEAT_LEN // REPEAT_CYCLE).tolist()
                prompts = serve["prompts"] + [repeat]
                k1_draft = [0]
                draft_prefill = model.draft_prefill_dispatch

                def counted(*a, **kw):  # K1 launches made by draft-pool prefills
                    before = _build.LAUNCHES["flash_attention"]
                    out = draft_prefill(*a, **kw)
                    k1_draft[0] += _build.LAUNCHES["flash_attention"] - before
                    return out

                model.draft_prefill_dispatch = counted
                _build.reset_launches()  # this method's run starts here
                before = {"blocks": model.decode_blocks, "syncs": model.host_syncs,
                          "steps": model.steps, "block_s": model.block_seconds,
                          "emitted": model.spec_emitted_tokens,
                          "passes": model.spec_verify_passes, "ttft": len(sched.ttft),
                          "draft_prefills": model.draft_prefills}
                loop = asyncio.get_running_loop()
                t1 = time.perf_counter()
                with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
                    replies = await asyncio.gather(*(
                        loop.run_in_executor(clients, _post, port, {"strData": json.dumps(
                            {"tokens": p, "max_new_tokens": MAX_NEW})})
                        for p in prompts))
                wave_s = time.perf_counter() - t1
                launches = dict(_build.LAUNCHES)
                by_l = {str(n): c for n, c in sorted(_build.PAGED_LAUNCHES_BY_L.items())}
                outs = _check_replies(replies, prompts, vocab)
                blocks = model.decode_blocks - before["blocks"]
                syncs = model.host_syncs - before["syncs"]
                passes = model.spec_verify_passes - before["passes"]
                emitted = model.spec_emitted_tokens - before["emitted"]
                steps = model.steps - before["steps"]
                ttft = sorted(t for _, t in list(sched.ttft)[before["ttft"]:])
                agree = [_divergence(model, p, off, on)
                         for p, off, on in zip(serve["prompts"], serve["outs"], outs)]
                rows = _verify_rows_vs_steps(model) if method == "ngram" else None
                rec = {
                    "phase": "serve_spec", "method": method, "preset": preset,
                    "dtype": "bfloat16", "spec_draft": SPEC_DRAFT,
                    "spec": model.spec_snapshot(), "n_slots": SERVE_SLOTS,
                    "decode_block": SERVE_BLOCK, "max_new_tokens": MAX_NEW,
                    "prompt_lens": [len(p) for p in prompts], "boot_and_warmup_s": boot_s,
                    "wave_s": wave_s, "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
                    "ttft_s_p50": statistics.median(ttft), "ttft_s_max": ttft[-1],
                    "verify_passes": passes, "emitted_tokens": emitted,
                    "accepted_tokens_per_pass": emitted / max(1, passes),
                    "ms_per_verify_pass": 1e3 * (model.block_seconds - before["block_s"])
                    / max(1, steps),
                    "decode_blocks": blocks, "host_syncs": syncs,
                    "host_syncs_per_block": syncs / max(1, blocks),
                    "launches": launches, "paged_launches_by_L": by_l,
                    "draft_prefills": model.draft_prefills - before["draft_prefills"],
                    "flash_launches_draft_pool": k1_draft[0],
                    "repeat_prompt_tokens": outs[-1][:16],
                    # gated: greedy speculation on equals off, bit for bit,
                    # in bf16 at full depth too (the verify pass runs the
                    # ops in spec.row_split once per query position)
                    "agreement_with_serve": agree,
                    "streams_equal_to_serve": sum(a["first_divergence"] is None for a in agree),
                    "verify_rows_vs_steps": rows,
                }
                rec["ok"] = (blocks > 0 and syncs == blocks and passes > 0
                             and by_l.get(str(1 + SPEC_DRAFT), 0) > 0
                             and (not method.startswith("draft")
                                  or (k1_draft[0] > 0 and by_l.get("1", 0) > 0))
                             and (method != "draft_self" or emitted > passes)
                             and rec["streams_equal_to_serve"] == len(agree)
                             and (rows is None or rows["bit_equal"]))
                emit(rec)
                if not rec["ok"]:
                    raise AssertionError(
                        f"serve_spec {method}: one host sync per block, verify passes at "
                        f"L={1 + SPEC_DRAFT}, the draft pool's kernels, the self-draft's "
                        "acceptance, the streams of spec off or the verify rows' bits are "
                        "missing")
                return launches
            finally:
                await app.close()

        launches = asyncio.run(run())
        for name in total:
            total[name] += launches[name]
    return total


DISAGG_KV_BLOCKS = 1 + SERVE_SLOTS * 64  # each engine's pool: 8 slots of up to 1024 rows
# the least pool a 2048-token request fits in (128 blocks + the sink): the
# 1500-token prompt's 96 blocks do not fit beside the warmed 33-block chain
DRAM_POOL_BLOCKS = 129
DRAM_GB = 1.0


def _gen(port: int, prompt, headers=None) -> tuple[int, dict]:
    code, body = _call(port, "/disagg/generate", {"tokens": prompt, "max_new_tokens": MAX_NEW},
                       headers)
    return code, json.loads(body)


async def _wave(port: int, prompts, path: str = "/disagg/generate") -> tuple[list, float, list]:
    """``prompts`` concurrently -> (replies, wave seconds, client send times)."""
    loop = asyncio.get_running_loop()
    sent = [0.0] * len(prompts)

    def one(i):
        sent[i] = time.perf_counter()
        if path == "/disagg/generate":
            return _gen(port, prompts[i])
        return _post(port, {"strData": json.dumps({"tokens": prompts[i],
                                                   "max_new_tokens": MAX_NEW})})

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(prompts)) as clients:
        replies = await asyncio.gather(*(loop.run_in_executor(clients, one, i)
                                         for i in range(len(prompts))))
    return replies, time.perf_counter() - t0, sent


def _timed(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` on the instance to log its host seconds."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, name, timed)


def _first_token_times(sched) -> dict:
    """Log, on ``sched``'s instance, when each request's first token lands
    (the decode engine admits an import): prompt tuple -> times."""
    seen: dict = {}
    start = sched._start

    def logged(req, *a, **kw):
        seen.setdefault(tuple(req.prompt.tolist()), []).append(time.perf_counter())
        return start(req, *a, **kw)

    sched._start = logged
    return seen


async def _disagg_wave(a, b, prompts) -> dict:
    """The wave through prefill engine ``a`` (handing off to ``b``): the
    streams, modes, launches by engine, TTFT (client send to the decode
    engine's first token), export and import costs, handoff bytes."""
    from seldon_core_tpu_torch.ops import _build

    ma, mb = (x.service.walker.component.model for x in (a, b))
    sb = b.service.walker.component.scheduler
    firsts = _first_token_times(sb)
    attach: list = []
    _timed(mb, "attach_imported", attach)
    before = {"a": dict(a.disagg_stats), "b": dict(b.disagg_stats), "a_blocks": ma.decode_blocks,
              "b_prefills": mb.prefills, "b_blocks": mb.decode_blocks, "b_syncs": mb.host_syncs,
              "b_steps": mb.steps, "b_block_s": mb.block_seconds}
    _build.reset_launches()  # this wave's run starts here
    replies, wave_s, sent = await _wave(a.port, prompts)
    launches = dict(_build.LAUNCHES)
    del sb._start, mb.attach_imported  # the instance wrappers
    ttft = []
    for i, p in enumerate(prompts):
        times = firsts.get(tuple(p), [])
        if times:
            ttft.append(times.pop(0) - sent[i])
    da = {k: a.disagg_stats[k] - before["a"][k] for k in ("handoffs_ok", "handoff_bytes",
                                                          "export_s", "local_fallbacks")}
    db = {k: b.disagg_stats[k] - before["b"][k] for k in ("imports_ok", "import_decode_s")}
    n = max(1, da["handoffs_ok"])
    rows = sum(-(-len(p) // 16) * 16 for p in prompts)  # the prompt blocks' rows shipped
    blocks = mb.decode_blocks - before["b_blocks"]
    syncs = mb.host_syncs - before["b_syncs"]
    return {
        "replies": replies, "modes": [body.get("mode") for _, body in replies],
        "outs": [body.get("tokens") for _, body in replies],
        "wave_s": wave_s, "wave_tokens_per_s": len(prompts) * MAX_NEW / wave_s,
        "ttft_s_p50": statistics.median(ttft) if ttft else None,
        "ttft_s_max": max(ttft) if ttft else None,
        "ttft_prefill_engine_s_p50": statistics.median(
            t for _, t in list(a.service.walker.component.scheduler.ttft)[-len(prompts):]),
        "handoffs": da["handoffs_ok"], "imports": db["imports_ok"],
        "local_fallbacks": da["local_fallbacks"],
        "handoff_bytes_per_request": da["handoff_bytes"] / n,
        "handoff_bytes_per_prompt_row": da["handoff_bytes"] / max(1, rows),
        "export_ms": 1e3 * da["export_s"] / n,
        "import_ms": 1e3 * (db["import_decode_s"] + sum(attach)) / max(1, db["imports_ok"]),
        "import_frame_decode_ms": 1e3 * db["import_decode_s"] / max(1, db["imports_ok"]),
        "import_attach_host_ms": 1e3 * sum(attach) / max(1, len(attach)),
        "launches_prefill_engine": {"flash_attention": launches["flash_attention"]},
        "launches_decode_engine": {"paged_decode_attention": launches["paged_decode_attention"]},
        "launches": launches,
        # the attribution holds: the prefill engine decoded nothing, the
        # decode engine prefilled nothing
        "prefill_engine_decode_blocks": ma.decode_blocks - before["a_blocks"],
        "decode_engine_prefills": mb.prefills - before["b_prefills"],
        "decode_blocks": blocks, "host_syncs": syncs,
        "decode_step_ms": 1e3 * (mb.block_seconds - before["b_block_s"])
        / max(1, mb.steps - before["b_steps"]),
    }


def _streams_equal(want, got) -> int:
    return sum(a == b for a, b in zip(want, got))


def phase_serve_disagg(serve: dict, device: str = "cuda", preset: str = SERVE_PRESET,
                       seed: int = 0) -> dict:
    """Two engines in one process over loopback HTTP, prefill role (A) and
    decode role (B), answer the serve wave's distinct prompts through
    ``/disagg/generate``: the streams must equal ``serve``'s bit for bit,
    bf16 pools and again int8 pools (against a unified int8 wave); A
    answers ``unified-fallback`` with B stopped and leaks no block; B
    refuses a frame of another block size (409).  A third engine (C)
    pulls a shared prefix's chain from A and serves it from the peer tier
    with A's tokens.  Then the DRAM tier: a pool small enough that a long
    prompt evicts a warmed 512-token prefix, with ``prefix_dram_gb`` set,
    must give the pressure-free run's streams.  Returns the kernels'
    launch counts summed over the runs."""
    import numpy as np

    from seldon_core_tpu_torch.disagg import handoff
    from seldon_core_tpu_torch.ops import _build

    blocks = {"kv_blocks": (DISAGG_KV_BLOCKS, "INT")}
    reuse = {"kv_prefix_reuse": ("true", "BOOL")}
    int8 = {"kv_cache_dtype": ("int8", "STRING")}
    prompts = serve["prompts"]  # the serve wave's distinct prompts
    total = {name: 0 for name in KERNELS}

    def add(launches):
        for name in total:
            total[name] += launches[name]

    async def pair(extra: dict, **a_extra):
        b, b_s = await _boot(_serve_spec(preset, seed, **blocks, **extra), device, role="decode")
        os.environ["SCT_DISAGG_DECODE"] = f"127.0.0.1:{b.port}"
        try:
            a, a_s = await _boot(_serve_spec(preset, seed, **blocks, **extra, **a_extra), device,
                                 role="prefill")
        finally:
            del os.environ["SCT_DISAGG_DECODE"]
        return a, b, a_s + b_s

    async def run() -> dict:
        rec = {"phase": "serve_disagg", "preset": preset, "dtype": "bfloat16",
               "n_slots": SERVE_SLOTS, "kv_block_size": 16, "kv_blocks": DISAGG_KV_BLOCKS,
               "max_new_tokens": MAX_NEW, "prompt_lens": [len(p) for p in prompts],
               "kv_bytes_per_row_computed": 2 * 16 * 8 * 64 * 2}
        # ---- bf16 pools: A (prefill role, with prefix reuse for the peer
        # tier) hands off to B (decode role)
        a, b, boot_s = await pair({}, **reuse)
        c = None
        try:
            ma = a.service.walker.component.model
            free0 = ma.free_block_count
            wave = await _disagg_wave(a, b, prompts)
            add(wave["launches"])
            outs = wave.pop("outs")
            wave.pop("replies")
            rec["bf16"] = {**wave, "boot_s": boot_s,
                           "streams_equal_to_serve": _streams_equal(serve["outs"], outs),
                           "serve_wave_tokens_per_s": serve["wave_tokens_per_s"],
                           "serve_ttft_s_p50": serve["ttft_s_p50"]}
            # a frame of another block size: B refuses it (409)
            sched_a = a.service.walker.component.scheduler
            await _pins_back(sched_a)  # the wave's pinned slots
            args, kw = _pinned_handoff(ma, prompts[0])
            frame = handoff.decode_handoff(await asyncio.to_thread(
                handoff.build_handoff_frame, *args, **kw))
            ma.release_slot(0)
            k, v = (t.reshape(t.shape[0], -1, 8, *t.shape[3:]) for t in (frame["k"], frame["v"]))
            skew = handoff.encode_handoff(frame["prompt"], frame["first_token"], k, v,
                                          block_size=8, max_new_tokens=MAX_NEW)
            code, body = await asyncio.to_thread(_call, b.port, "/disagg/import", skew)
            rec["block_size_skew"] = {"status": code, "body": body[:160].decode(errors="replace")}
            # the peer tier: C pulls A's chain for a prompt sharing the
            # 600-token prompt's first 512 tokens (32 blocks), then A serves
            # the same prompt from its own index: both prefill the same
            # 40-token suffix over the same bytes
            os.environ["SCT_PREFIX_PEER_PULL"] = "1"
            c, _ = await _boot(_serve_spec(preset, seed, **blocks, **reuse), device)
            shared = prompts[-1][:CACHED_PREFIX] + np.random.default_rng(seed + 7).integers(
                0, ma.cfg.vocab_size, 40).tolist()
            _build.reset_launches()
            code_c, at_c = await asyncio.to_thread(
                _gen, c.port, shared, {"x-sct-prefix-peer": f"127.0.0.1:{a.port}"})
            code_a, at_a = await asyncio.to_thread(_gen, a.port, shared)
            add(_build.LAUNCHES)
            snap = c.service.walker.component.model.prefix_snapshot()
            rec["peer"] = {"prompt_len": len(shared), "status": [code_a, code_c],
                           "modes": [at_a.get("mode"), at_c.get("mode")],
                           "tokens_equal_to_a": at_a.get("tokens") == at_c.get("tokens"),
                           "tier_peer_hits": snap["tiers"]["peer"]["hits"],
                           "tier_peer_promotions": snap["tiers"]["peer"]["promotions"],
                           "pull": dict(c.prefix_pull_stats),
                           "a_serves": a.prefix_pull_stats["serves_ok"]}
            rec["peer"]["tier"] = "peer" if rec["peer"]["tier_peer_hits"] == 1 else None
            # B stopped: A decodes locally, the same tokens, no block leaked.
            # The 5-token prompt has no full block, so its streams are the
            # cold prefill's; the longest prompt's pinned slot matches and
            # then hands A's index its full blocks, so the account counts
            # blocks held by the index alone as well as free ones
            await b.close()
            before = await _block_account(ma, sched_a)
            _build.reset_launches()
            long_p = max(prompts, key=len)
            fb = [await asyncio.to_thread(_gen, a.port, p) for p in (prompts[0], prompts[0], long_p)]
            add(_build.LAUNCHES)
            after = await _block_account(ma, sched_a)
            # the same prompt as a unified request on A: the same reused
            # blocks and suffix prefill as the fallback's
            code_u, unified = await asyncio.to_thread(_post, a.port, {"strData": json.dumps(
                {"tokens": long_p, "max_new_tokens": MAX_NEW})})
            rec["fallback"] = {
                "prompt_lens": [len(prompts[0])] * 2 + [len(long_p)],
                "modes": [body.get("mode") for _, body in fb],
                "streams_equal_to_serve": _streams_equal(serve["outs"][:1] * 2,
                                                         [body.get("tokens") for _, body in fb]),
                "long_equal_to_unified": code_u == 200 and fb[2][1].get("tokens") == json.loads(
                    unified["strData"])["tokens"],
                "long_equal_to_serve": fb[2][1].get("tokens")
                == serve["outs"][prompts.index(long_p)],
                "blocks_before": before, "blocks_after": after,
                "free_blocks_at_boot": free0, "stats": dict(a.disagg_stats)}
        finally:
            os.environ.pop("SCT_PREFIX_PEER_PULL", None)
            for app in (a, b, c):
                if app is not None:
                    await app.close()
        # ---- int8 pools: a unified int8 wave on B, then the handoff
        a, b, _ = await pair(int8)
        try:
            _build.reset_launches()
            unified, _, _ = await _wave(b.port, prompts)
            add(_build.LAUNCHES)
            wave = await _disagg_wave(a, b, prompts)
            add(wave["launches"])
            outs = wave.pop("outs")
            wave.pop("replies")
            rec["int8"] = {**wave, "unified_modes": sorted({body["mode"] for _, body in unified}),
                           "streams_equal_to_unified_int8": _streams_equal(
                               [body["tokens"] for _, body in unified], outs)}
        finally:
            await a.close()
            await b.close()
        try:
            rec["dram"] = await _dram_tier(preset, seed, device, add)
        except Exception as e:  # noqa: BLE001 - the record is printed, then the phase fails
            rec["dram"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return rec

    rec = asyncio.run(run())
    bf, q, peer, fb, dram = rec["bf16"], rec["int8"], rec["peer"], rec["fallback"], rec["dram"]
    rec["ok"] = (
        bf["modes"] == ["disagg"] * len(prompts) and bf["streams_equal_to_serve"] == len(prompts)
        and bf["launches_prefill_engine"]["flash_attention"] > 0
        and bf["launches_decode_engine"]["paged_decode_attention"] > 0
        and bf["prefill_engine_decode_blocks"] == 0 and bf["decode_engine_prefills"] == 0
        and bf["host_syncs"] == bf["decode_blocks"] > 0
        and q["modes"] == ["disagg"] * len(prompts) and q["unified_modes"] == ["unified"]
        and q["streams_equal_to_unified_int8"] == len(prompts)
        and rec["block_size_skew"]["status"] == 409
        and peer["status"] == [200, 200] and peer["tokens_equal_to_a"] and peer["tier"] == "peer"
        and fb["modes"] == ["unified-fallback"] * 3 and fb["streams_equal_to_serve"] == 2
        and fb["long_equal_to_unified"]
        and fb["blocks_after"]["reclaimable"] == fb["blocks_before"]["reclaimable"]
        == fb["blocks_after"]["pool"] and fb["blocks_after"]["referenced"] == 0
        and dram["ok"])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("serve_disagg: a handoff, fallback, refusal, tier or stream check "
                             "failed (see the record above)")
    return total


async def _pins_back(sched, timeout_s: float = 10.0) -> None:
    """Wait, ``timeout_s`` at most, until ``sched`` has released every slot
    a handoff pinned."""
    deadline = time.perf_counter() + timeout_s
    while (sched._external or sched._external_release) and time.perf_counter() < deadline:
        await asyncio.sleep(0.01)


async def _block_account(model, sched) -> dict:
    """Where an idle reuse-on pool's blocks are, once ``sched``'s pinned
    slots have gone back: free, held by the prefix index alone (the two are
    ``reclaimable``), or referenced by an entry still in use.  A block
    neither free nor in the index has leaked; so has a slot still pinned
    after 10 s."""
    await _pins_back(sched)
    snap = model.prefix_snapshot()
    held = snap["entries"] - snap["referenced"]
    return {"free": snap["free_blocks"], "index_only": held, "referenced": snap["referenced"],
            "reclaimable": snap["free_blocks"] + held, "pool": snap["pool_blocks"]}


def _pinned_handoff(model, prompt):
    """Prefill ``prompt`` into slot 0 of ``model`` (an engine's model, idle)
    -> the arguments of ``build_handoff_frame``."""
    import numpy as np

    p = np.asarray(prompt, np.int32)
    tok = model.admit(0, p, 0.0, 0, reserve_tokens=MAX_NEW)
    return (model, 0, p, tok), {"max_new_tokens": MAX_NEW}


async def _dram_tier(preset: str, seed: int, device: str, add) -> dict:
    """A warmed 512-token prefix, a 1500-token prompt that evicts it from a
    128-block pool into the DRAM tier, then a prompt sharing the prefix
    (promoted back): the streams against the same requests on a pool with
    room for all of it."""
    import numpy as np

    from seldon_core_tpu_torch.models.registry import resolve_config
    from seldon_core_tpu_torch.ops import _build

    rng = np.random.default_rng(seed + 3)
    vocab = resolve_config(preset).vocab_size
    prefix = rng.integers(0, vocab, CACHED_PREFIX).tolist()
    prompts = [prefix + rng.integers(0, vocab, 24).tolist(),
               rng.integers(0, vocab, LONG_LENGTHS[0]).tolist(),
               prefix + rng.integers(0, vocab, 40).tolist()]
    reuse = {"kv_prefix_reuse": ("true", "BOOL"), "prefix_dram_gb": (DRAM_GB, "FLOAT")}
    runs = {}
    for name, extra in (("pressure", {"kv_blocks": (DRAM_POOL_BLOCKS, "INT")}), ("room", {})):
        app, _ = await _boot(_serve_spec(preset, seed, **reuse, **extra), device)
        try:
            comp = app.service.walker.component
            promote: list = []
            _timed(comp.model, "_promote", promote)
            _build.reset_launches()
            outs = []
            for p in prompts:
                code, body = await asyncio.to_thread(_post, app.port, {"strData": json.dumps(
                    {"tokens": p, "max_new_tokens": MAX_NEW})})
                outs.append(json.loads(body["strData"])["tokens"] if code == 200 else None)
            add(_build.LAUNCHES)
            snap = comp.model.prefix_snapshot()
            dram = snap["tiers"]["dram"]
            runs[name] = {"outs": outs, "ttft_s": [t for _, t in comp.scheduler.ttft][-3:],
                          "demotions": dram["demotions"], "promotions": dram["promotions"],
                          "dram_hits": dram["dram_hits"], "dram_bytes": dram["bytes"],
                          "promote_host_ms": [1e3 * t for t in promote],
                          "free_blocks": snap["free_blocks"], "pool_blocks": snap["pool_blocks"]}
        finally:
            await app.close()
    p, r = runs["pressure"], runs["room"]
    rec = {"prompt_lens": [len(x) for x in prompts], "pool_blocks": DRAM_POOL_BLOCKS - 1,
           "prefix_dram_gb": DRAM_GB,
           "streams_equal_to_no_pressure": _streams_equal(r["outs"], p["outs"]),
           **{k: p[k] for k in ("demotions", "promotions", "dram_hits", "dram_bytes",
                                "promote_host_ms")},
           "ttft_s_pressure": p["ttft_s"], "ttft_s_room": r["ttft_s"],
           "room_demotions": r["demotions"]}
    rec["ok"] = (rec["streams_equal_to_no_pressure"] == len(prompts) and p["demotions"] >= 1
                 and p["promotions"] >= 1 and p["dram_hits"] >= 1 and r["demotions"] == 0)
    return rec


def _flash_times(fa, S: int) -> dict:
    """K1 at B=1, S, llama3-1b heads, bf16: one input set per layer so no
    launch finds its inputs in L2."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KV, D, layers = 32, 8, 64, 16
    sets = [_flash_inputs(S, H, KV, D, torch.bfloat16, seed=100 + i) for i in range(layers)]
    bhsd = [tuple(x.transpose(1, 2).contiguous() for x in s) for s in sets]
    nbytes = 2 * (2 * S * H * D + 2 * S * KV * D)
    flops = 4 * D * H * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    return {
        "shape": {"B": 1, "S": S, "H": H, "KV": KV, "D": D, "dtype": "bfloat16"},
        "ms": time_ms(fa.flash_causal_attention_blhd, sets),
        "eager_ms": eager_ms(fa.flash_causal_attention_blhd, sets),
        "host_ms": host_ms(fa.flash_causal_attention_blhd, sets),
        "plain_ms": time_ms(lambda q, k, v: fa._attention_blhd_plain(q, k, v, True), sets, 5),
        "library_ms": time_ms(
            lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True), bhsd),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }


def _paged_times(pa, pos: list[int], WB: int, quant: bool = False, L: int = 1) -> dict:
    """K2: one decode step's read (``L`` = 1) or one verify pass's (``L``
    queries per slot) for SERVE_SLOTS slots at ``pos`` over a ``WB``-entry
    window, bf16 queries over bf16 pages or (``quant``) over int8 pages
    with bf16 scales, one pool per layer as in the model."""
    import torch

    H, KV, D, BS, layers = 32, 8, 64, 16, 16
    NB = 1 + SERVE_SLOTS * WB
    sets = []
    for i in range(layers):
        (q, k, v, table, p), kw = _paged_inputs(SERVE_SLOTS, L, H, KV, D, BS, NB, WB,
                                                torch.bfloat16, seed=200 + i, pos=pos,
                                                quant=quant)
        sets.append((q, k, v, table, p) + ((kw["k_scale"], kw["v_scale"]) if quant else ()))

    def kernel(*args):
        return pa.paged_decode_attention(*args[:5], k_scale=args[5], v_scale=args[6])

    def plain(*args):
        return pa.paged_decode_attention_plain(*args[:5], k_scale=args[5], v_scale=args[6])

    if not quant:  # the bf16 rows time the wrappers themselves, as before
        kernel, plain = pa.paged_decode_attention, pa.paged_decode_attention_plain

    # the function needs rows [0, pos + L - 1] of each slot (int8 rows carry
    # a bf16 scale per KV head) and the table entries of the pages that
    # hold them, whatever L is; the kernel reads them once per 4-row chunk
    # of the L * groups query rows
    rows = sum(p + L for p in pos)
    pages = sum((p + L - 1) // BS + 1 for p in pos)
    row_bytes = KV * (D + 2) if quant else 2 * KV * D
    nbytes = 2 * 2 * SERVE_SLOTS * L * H * D + 2 * rows * row_bytes + 4 * pages + 4 * SERVE_SLOTS
    flops = sum(4 * H * D * (p + j + 1) for p in pos for j in range(L))
    chunks = -(-L * (H // KV) // getattr(pa, "ROWS_PER_BLOCK", 4))
    b_ms, b_by = bound(nbytes, flops)
    return {
        "shape": {"S": SERVE_SLOTS, "L": L, "H": H, "KV": KV, "D": D, "BS": BS, "WB": WB,
                  "pos": pos, "dtype": "bfloat16", "pages": "int8" if quant else "bfloat16"},
        "chunks": chunks, "kv_bytes_needed": 2 * rows * row_bytes,
        "kv_bytes_read": chunks * 2 * rows * row_bytes,
        "ms": time_ms(kernel, sets),
        "eager_ms": eager_ms(kernel, sets),
        "host_ms": host_ms(kernel, sets),
        "plain_ms": time_ms(plain, sets, 5),
        "library_ms": None,  # no single PyTorch call reads a paged pool
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
    }


def window_entries(pos: list[int], rows_per_step: int = 1) -> int:
    """The table entries of the window bucket the scheduler picks for slots
    at ``pos`` (16-row pages) before a block of ``rows_per_step`` rows a
    step (``1 + spec_draft`` in a speculative block)."""
    window = 64
    while window < max(pos) + SERVE_BLOCK * rows_per_step + 1:
        window *= 2
    return window // 16


def kernel_times(fa, pa, bucket: int, pos: list[int]) -> dict:
    """Each kernel at the main path's shapes (``served``: the flash bucket
    and the served slots' positions) and a long one (``long``); the paged
    kernel also over int8 pages at both."""
    return {
        "flash_attention": {"served": _flash_times(fa, bucket), "long": _flash_times(fa, 2048)},
        "paged_decode_attention": {
            "served": _paged_times(pa, pos, window_entries(pos)),
            "long": _paged_times(pa, LONG_POS, 128),
            "served_int8": _paged_times(pa, pos, window_entries(pos), quant=True),
            "long_int8": _paged_times(pa, LONG_POS, 128, quant=True),
            "served_L4": _paged_times(pa, pos, window_entries(pos, 1 + SPEC_DRAFT),
                                      L=1 + SPEC_DRAFT),
            "long_L4": _paged_times(pa, LONG_POS, 128, L=1 + SPEC_DRAFT),
        },
    }


def phase_kernel_times(serve: dict) -> dict:
    """Each kernel at the main path's shapes (``served``) and a long one
    (``long``): kernel, plain version, one library call where there is one,
    and the bound."""
    fa = importlib.import_module("seldon_core_tpu_torch.ops.flash_attention")
    pa = importlib.import_module("seldon_core_tpu_torch.ops.paged_attention")
    # K1 at the largest bucket the served prompts used; K2 for the served
    # slots at their mid-answer positions over the scheduler's window bucket
    out = kernel_times(fa, pa, serve["bucket"], serve["pos"])
    for t in out["paged_decode_attention"].values():
        t["splits"], t["per"] = pa.plan_splits(t["shape"]["WB"])
        t["grid_blocks"] = t["splits"] * t["shape"]["KV"] * t["chunks"] * SERVE_SLOTS
    emit({"phase": "kernel_times", **out})
    return {name: t["served"] for name, t in out.items()}


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
    cached = phase_serve_cached()
    spec = phase_serve_spec(serve)
    split = phase_serve_disagg(serve)
    times = phase_kernel_times(serve)
    launches = {name: serve["launches"][name] + cached["launches"][name] + spec[name]
                + split[name] for name in KERNELS}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
          f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": origin,
         "launches": launches[name], "max_abs_err": errs[name],
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
