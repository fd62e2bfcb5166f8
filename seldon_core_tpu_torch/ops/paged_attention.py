"""Paged decode attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel ``ops/paged_attention.py
::paged_decode_attention`` (``pallas_call`` at :163), the attention read of
every decode step.  On an H100 a decode step is bound by the bytes it
reads, so the kernel (``csrc/paged_attention.cu``, one kernel for every
dtype: f32, f16 or bf16 queries over pages of the same type or int8 pages
with per-(position, head) scales) reads each visible pool row once and
keeps many of them in flight: split-KV flash-decoding in one launch.

* :func:`plan_splits` cuts each slot's table into runs of ``per``
  entries from the window width alone (never ``pos`` or the table, so a
  decode step needs no host sync; and ``per`` is fixed, so a slot's result
  does not depend on its batch).  The grid is ``(splits, KV * row chunks,
  S)``; a split that starts past the slot's last visible row exits at
  once.
* Inside a block 4 warps take 16-row units of the pages in turn, each
  through a 3-unit ring of 16-byte ``cp.async`` copies (2 units in flight
  while one is computed); a K row read serves every query row of its group
  (up to ``ROWS_PER_BLOCK``); the online softmax runs in f32 per warp;
  int8 pages are dequantized in registers.
* The last split block to finish for a (slot, KV head, row chunk) merges
  the splits' f32 partials by log-sum-exp weights (found by an atomic
  counter that the wrapper keeps per device and stream and the kernel
  resets), so the combine costs no second launch.

Query ``j`` of slot ``s`` sees pool rows ``[0, pos[s] + j]``; grouped
queries read the un-repeated KV heads (query row ``r = j * groups + g``).
Rows with nothing visible are zeros, as in the TPU kernel.

Dispatch is by device: a tensor on the CPU takes the plain version, a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from seldon_core_tpu_torch.ops import _build, _flops

KERNEL_DIMS = (16, 32, 64, 128)
ROWS_PER_BLOCK = 4  # query rows one block serves (csrc/paged_attention.cu RB)
PER_SPLIT = 8  # table entries one split covers at most: ~2 units per warp at 16-row pages


def plan_splits(WB: int) -> tuple[int, int]:
    """``(splits, per)``: each slot's ``WB`` table entries cut into
    ``splits`` contiguous runs of ``per = min(PER_SPLIT, WB)`` (the last may
    be shorter, none is empty).  The kernel runs ``S * KV * ceil(R /
    ROWS_PER_BLOCK) * splits`` blocks, 512 at the served shape (8 slots x 8
    KV heads, a 64-entry window), and a split past its slot's last visible
    row exits at once.  ``per`` never follows the window width: the window
    follows the batch's longest slot, so a ``per`` that followed it would
    change a slot's summation order, and a greedy token, with the requests
    it shares a batch with."""
    per = min(PER_SPLIT, WB)
    return -(-WB // per), per


_counters: dict[tuple[int, int], torch.Tensor] = {}
# outgrown counter buffers: a CUDA graph captured with one keeps its address
_retired: list[torch.Tensor] = []


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """The split counters of ``device``'s current stream, all 0 between
    launches (the kernel's last block resets its own).  Launches on one
    stream run in order, so they may share counters; a launch on another
    stream gets its own.  A graph replays its launches on one stream, in
    order, so the graphs captured on a stream share its counters too; they
    must exist before the capture (:func:`reserve_counters`), since memory
    allocated while a graph is captured belongs to that graph's pool."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged attention needs {n} split counters on a stream that a CUDA graph "
                "is capturing: reserve them before the capture (reserve_counters)"
            )
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def counter_rows(S: int, L: int, H: int, KV: int) -> int:
    """The split counters one launch over ``S`` slots of ``L`` queries uses."""
    return S * KV * -(-L * (H // KV) // ROWS_PER_BLOCK)


def reserve_counters(device: torch.device, n: int) -> None:
    """Allocate ``n`` split counters for ``device``'s current stream now,
    outside any graph capture."""
    _counter_buffer(device, n)


def paged_decode_attention_plain(
    q, k_pages, v_pages, table, pos, *, k_scale=None, v_scale=None
):
    """The gather path of ``paged_decode_attention_reference`` (the JAX
    package's XLA read side), with rows that see nothing set to zeros to
    match the kernel."""
    S, L, H, D = q.shape
    NB, BS, KV, _ = k_pages.shape
    WB = table.shape[1]
    W = WB * BS
    groups = H // KV
    idx = table.long()
    kw = k_pages[idx]  # (S, WB, BS, KV, D)
    vw = v_pages[idx]
    if k_scale is not None:
        kw = (kw.float() * k_scale[idx][..., None].float()).to(q.dtype)
        vw = (vw.float() * v_scale[idx][..., None].float()).to(q.dtype)
    kw = kw.reshape(S, W, KV, D)
    vw = vw.reshape(S, W, KV, D)
    positions = pos.long()[:, None] + torch.arange(L, device=q.device)[None, :]
    valid = torch.arange(W, device=q.device)[None, None, :] <= positions[:, :, None]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(S, L, KV, groups, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kw) * scale
    vmask = valid[:, None, None, :, :]  # (S, 1, 1, L, W)
    s = s.masked_fill(~vmask, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1) * vmask.any(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vw)
    return o.reshape(S, L, H, D)


def _check(q, k_pages, v_pages, table, pos, k_scale, v_scale) -> None:
    if q.ndim != 4 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged attention takes q (S, L, H, D) and pages (NB, BS, KV, D), got "
            f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    S, L, H, D = q.shape
    NB, BS, KV, Dk = k_pages.shape
    if Dk != D or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(k_pages.shape)}")
    if table.ndim != 2 or table.shape[0] != S or pos.shape != (S,):
        raise ValueError(
            f"table must be (S, WB) and pos (S,) for S={S}, got "
            f"{tuple(table.shape)} and {tuple(pos.shape)}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    if k_scale is not None and (
        k_scale.shape != (NB, BS, KV) or v_scale.shape != (NB, BS, KV)
    ):
        raise ValueError(f"scales must be (NB, BS, KV) = {(NB, BS, KV)}")


def _launch(q, k_pages, v_pages, table, pos, k_scale, v_scale):
    S, L, H, D = q.shape
    NB, BS, KV, _ = k_pages.shape
    WB = table.shape[1]
    tensors = [q, k_pages, v_pages, table, pos]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged attention inputs must lie on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged attention kernel needs contiguous inputs")
    if q.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        raise TypeError(f"paged attention kernel takes float queries, got {q.dtype}")
    if k_scale is None:
        if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
            raise TypeError("float pages must have the queries' dtype")
    elif not (
        k_pages.dtype == v_pages.dtype == torch.int8
        and k_scale.dtype == v_scale.dtype == q.dtype
    ):
        raise TypeError("quantized pages are int8 with scales in the queries' dtype")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("table and pos must be int32")
    if D not in KERNEL_DIMS:
        raise ValueError(f"paged attention kernel takes head_dim in {KERNEL_DIMS}, got {D}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged attention kernel needs 16-byte aligned pages")
    splits, per = plan_splits(WB)
    out = torch.empty_like(q)
    part = counters = None
    if splits > 1:
        rows = counter_rows(S, L, H, KV)
        part = torch.empty(rows * splits * ROWS_PER_BLOCK * (D + 2), dtype=torch.float32,
                           device=q.device)
        counters = _counter_buffer(q.device, rows)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.sct_paged_decode_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pages.dtype],
            S, L, H, KV, D, NB, BS, WB, splits, per, 1.0 / math.sqrt(D),
            _build.stream_handle(q.device),
        )
    _build.check(code, "paged_decode_attention")
    _build.LAUNCHES["paged_decode_attention"] += 1
    _build.LAUNCHES_BY_D[f"paged_decode_attention@{D}"] += 1
    _build.PAGED_LAUNCHES_BY_L[L] += 1
    return out


def paged_decode_attention(
    q, k_pages, v_pages, table, pos, *, k_scale=None, v_scale=None
):
    """Attention for ``L`` decode queries per slot over ONE layer's paged
    KV pool.

    ``q (S, L, H, D)`` post-RoPE queries; ``k_pages``/``v_pages
    (NB, BS, KV, D)`` float, or int8 with ``k_scale``/``v_scale
    (NB, BS, KV)``; ``table (S, WB)`` the physical blocks each slot's
    window reads; ``pos (S,)`` each slot's base position.  Returns
    ``(S, L, H, D)`` in q's dtype."""
    _check(q, k_pages, v_pages, table, pos, k_scale, v_scale)
    if _flops.active():  # a roofline's FLOP count: the formula, not the route
        S, L, H, D = q.shape
        W = table.shape[1] * k_pages.shape[1]
        _flops.add("paged_decode_attention", _flops.attention_flops(S, H, L, W, D))
        with _flops.paused():
            return _paged(q, k_pages, v_pages, table, pos, k_scale, v_scale)
    return _paged(q, k_pages, v_pages, table, pos, k_scale, v_scale)


def _paged(q, k_pages, v_pages, table, pos, k_scale, v_scale):
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, table, pos, k_scale=k_scale, v_scale=v_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k_pages, v_pages, table, pos, k_scale, v_scale)
