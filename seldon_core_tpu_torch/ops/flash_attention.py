"""Flash attention: hand-written CUDA kernels for Hopper and their plain
PyTorch version.

Replaces the JAX package's Pallas TPU kernel ``ops/flash_attention.py
::flash_attention`` (``pallas_call`` at :120), which the llama prefill runs
with ``seq_impl="flash"``.  On an H100 the prefill attention is bound by
operations (~S/2 multiply-adds per byte read at D = 64), so the scores
never touch device memory and the products run on the tensor cores.  The
kernels live in ``csrc/flash_attention.cu``:

* bf16 and f16 (the served path): one CTA per (batch*head, 128-row query
  tile); a producer warpgroup streams 64-key K/V tiles by TMA into a
  3-stage shared-memory ring; two consumer warpgroups run ``wgmma`` for
  Q.K^T (the next tile's while this tile's softmax runs) and, with the
  probabilities rounded once to the input's type in registers, for P.V,
  the online softmax in f32 between them.  TMA needs 16-byte aligned
  pointers and strides: a view that has neither is copied contiguous
  first.
* f32: the SIMT kernel of the first port (f32 FMAs on the CUDA cores), so
  f32 callers keep full f32 products.

Their times beside the bound stand in PERF.md.

Unlike the TPU kernel it takes any sequence length (the ragged edge is
masked in the kernel, so ``_fit_block`` has no counterpart) and K/V with
fewer heads than Q (KV divides H; head ``h`` reads KV head
``h // (H // KV)``), so the model need not repeat K/V.  K/V already
repeated to H heads still work, which is the JAX adapter's contract.
Causal attention also takes more keys than queries, with the mask aligned
bottom-right (the suffix prefill over a reused prefix or earlier chunks);
a suffix row then gets the bits of the same row of a cold prefill (the
kernel's header says why).

Dispatch is by device: a tensor on the CPU takes the plain version, a CUDA
tensor launches a kernel or raises.
"""

from __future__ import annotations

import math

import torch

from seldon_core_tpu_torch.ops import _build, _flops

KERNEL_DIMS = (16, 32, 64, 128)


def _dense_causal_attention(q, k, v):
    """``(B, L, H, D)`` causal attention with a bottom-right aligned mask
    (the model zoo's dense path); k/v carry H heads."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ql, kl = q.shape[1], k.shape[1]
    rows = torch.arange(ql, device=q.device)[:, None] + (kl - ql)
    mask = rows >= torch.arange(kl, device=q.device)[None, :]
    s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _full_attention(q, k, v):
    """``(B, L, H, D)`` attention with no mask; k/v carry H heads."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _repeat_heads(kv, n_heads: int, head_dim: int = 2):
    reps = n_heads // kv.shape[head_dim]
    return kv if reps == 1 else kv.repeat_interleave(reps, dim=head_dim)


def _attention_blhd_plain(q, k, v, causal: bool):
    H = q.shape[2]
    kf, vf = _repeat_heads(k, H), _repeat_heads(v, H)
    return _dense_causal_attention(q, kf, vf) if causal else _full_attention(q, kf, vf)


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The plain version of :func:`flash_attention`, ``(B, H, S, D)``."""
    out = _attention_blhd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal
    )
    return out.transpose(1, 2)


def _check_shapes(q, k, v, causal: bool) -> None:
    """Shape rules both versions share; ``q/k/v`` are ``(B, H, S, D)``
    views."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes 4-D q, k, v")
    B, H, Sq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    KV = k.shape[1]
    if KV < 1 or H % KV:
        raise ValueError(f"q heads {H} must be a multiple of kv heads {KV}")
    if causal and k.shape[2] < Sq:
        raise ValueError(
            f"causal flash attention needs at least as many keys as queries, got {Sq} "
            f"queries and {k.shape[2]} keys"
        )


def _tma_ready(t) -> bool:
    """Whether TMA can address ``t`` as it is: a 16-byte aligned pointer
    and 16-byte multiples for every stride of a dim longer than 1."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st * size) % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
    )


def _launch(q, k, v, o, causal: bool) -> None:
    """Launch the kernel on ``(B, H, S, D)``-indexed views (any strides
    with D contiguous)."""
    if not (q.device == k.device == v.device == o.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.float16, torch.bfloat16,
    ):
        raise TypeError(
            f"flash attention kernel takes one float dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if D not in KERNEL_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in {KERNEL_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.stride(3) != 1:
            raise ValueError(f"flash attention kernel needs {name}'s last dim contiguous")
    if q.dtype != torch.float32:
        q, k, v = (t if _tma_ready(t) else t.contiguous() for t in (q, k, v))
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.sct_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _build.DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            1.0 / math.sqrt(D), int(causal), _build.stream_handle(q.device),
        )
    _build.check(code, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    _build.LAUNCHES_BY_D[f"flash_attention@{D}"] += 1


def flash_attention(q, k, v, *, causal: bool = True):
    """``(B, H, Sq, D)`` attention over ``k/v (B, KV, Sk, D)`` (KV divides H).

    Causal attention needs ``Sk >= Sq`` and aligns its mask bottom-right:
    query row ``i`` sees keys ``[0, Sk - Sq + i]`` (``Sk == Sq`` masks ``col
    > row``); rows with nothing visible are zeros."""
    _check_shapes(q, k, v, causal)
    if _flops.active():  # a roofline's FLOP count: the formula, not the route
        B, H, Sq, D = q.shape
        _flops.add("flash_attention", _flops.attention_flops(B, H, Sq, k.shape[2], D))
        with _flops.paused():
            return _flash_attention(q, k, v, causal)
    return _flash_attention(q, k, v, causal)


def _flash_attention(q, k, v, causal: bool):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, o, causal)
    return o


def flash_causal_attention_blhd(q, k, v):
    """The model zoo's ``(B, L, H, D)`` causal attention contract
    (``models/llama.py::_layer``); k/v may carry fewer heads than q, and
    more rows (``Sk >= Sq``): the queries are then the last ``Sq`` rows of
    an ``Sk``-row causal prefill, as in the suffix prefill over a reused
    prefix (``models/llama.py::prefill_suffix_paged``)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    _check_shapes(qt, kt, vt, True)
    if _flops.active():
        B, Sq, H, D = q.shape
        _flops.add("flash_attention", _flops.attention_flops(B, H, Sq, k.shape[1], D))
        with _flops.paused():
            return _flash_causal_blhd(q, k, v, qt, kt, vt)
    return _flash_causal_blhd(q, k, v, qt, kt, vt)


def _flash_causal_blhd(q, k, v, qt, kt, vt):
    if q.device.type == "cpu":
        return _attention_blhd_plain(q, k, v, True)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(qt, kt, vt, o.transpose(1, 2), True)
    return o
