"""Llama-family decoder for generative serving, in PyTorch.

The counterpart of the JAX package's ``models/llama.py`` for paged
serving: a float or int8 paged KV pool, the suffix prefill over a reused
prefix or an earlier chunk (``prefill_suffix_paged``), the speculative
verify pass over ``1 + draft`` positions per slot
(``decode_slots_spec_paged``) with its draft sources (Medusa-style heads,
a layer-truncated self-draft), greedy and top-k sampling.  The
weights keep the JAX package's stacked per-layer layout (``wq (L, E, H,
D)``, ``wo (L, H, D, E)``, ...) inside :class:`Llama`, an ``nn.Module``, and
the functions below keep the JAX signatures and ``(B, L, H, D)`` layouts,
so the tests compare like with like.  The layer loop is a Python loop over
views of the stacked weights.

Where JAX returns a new cache, these functions update the pool tensors in
place (the pool is the largest allocation a deployment makes; a copy per
step would double it) and return the same dict.

Attention runs through the hand-written kernels on the card:
``ops.flash_causal_attention_blhd`` in the prefill (``seq_impl="flash"``)
and in the suffix prefill (its bottom-right aligned variant over the
gathered prefix), and ``ops.paged_decode_attention`` in every decode step
(``kernel=True``), which dequantizes int8 pages itself.  On the CPU the
suffix prefill's attention is the einsum, mask and softmax of the JAX
package's dense prefill.  The int8 quantize-on-write and the prefix gather
are plain torch ops, as they are XLA code (not Pallas) in the JAX package.

Batched multi-LoRA: one stacked adapter pool ``{target: {"a": (layers,
adapters, in.., r), "b": (layers, adapters, r, out..)}}`` and per-row
adapter ids ``aid`` ride the prefill, suffix prefill and decode bodies;
each target's delta ``(x @ a[aid]) @ b[aid]`` (:func:`_lora_delta`, an
index gather and two batched products, as the JAX package's two einsums)
is added to its base projection.  Row 0 of the pool is the null adapter
(all zeros), whose delta is exactly zero.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.ops import flash_causal_attention_blhd, paged_decode_attention
from seldon_core_tpu_torch.ops.flash_attention import _dense_causal_attention, _repeat_heads
from seldon_core_tpu_torch.ops.paged_attention import paged_decode_attention_plain

__all__ = [
    "Config", "Llama", "init_paged_cache", "paged_kv_slot_bytes", "prefill_slot_paged",
    "prefill_suffix_paged", "decode_slots_paged", "decode_slots_spec_paged", "sample_tokens",
    "forward", "row_variant_ops", "prefill_variant_ops", "row_tiled_op", "init_medusa_heads",
    "apply_medusa_heads", "medusa_head_bytes", "truncate_params", "LORA_ATTN_TARGETS",
    "LORA_MLP_TARGETS", "init_lora_params", "lora_adapter_factors", "lora_pool_bytes",
]


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 32000
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "Config":
        return cls(
            vocab_size=128256, hidden=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn=14336, max_seq=8192,
        )

    @classmethod
    def llama3_1b(cls, max_seq: int = 2048) -> "Config":
        """Llama-3.2-1B shape (vocab truncated to keep the embedding from
        dominating the 1.2B total)."""
        return cls(
            vocab_size=32000, hidden=2048, n_layers=16, n_heads=32,
            n_kv_heads=8, ffn=8192, max_seq=max_seq,
        )

    @classmethod
    def tiny(cls, max_seq: int = 128) -> "Config":
        """Test-scale config: same code paths, toy sizes."""
        return cls(
            vocab_size=256, hidden=64, n_layers=2, n_heads=4,
            n_kv_heads=2, ffn=128, max_seq=max_seq, rope_theta=10000.0,
        )


LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ln_att", "ln_mlp")


def param_shapes(cfg: Config) -> dict:
    """The JAX ``init_params`` pytree's shapes, flattened to
    ``"layers/wq"``-style keys."""
    c, nl = cfg, cfg.n_layers
    return {
        "tok_emb": (c.vocab_size, c.hidden),
        "layers/wq": (nl, c.hidden, c.n_heads, c.head_dim),
        "layers/wk": (nl, c.hidden, c.n_kv_heads, c.head_dim),
        "layers/wv": (nl, c.hidden, c.n_kv_heads, c.head_dim),
        "layers/wo": (nl, c.n_heads, c.head_dim, c.hidden),
        "layers/w_gate": (nl, c.hidden, c.ffn),
        "layers/w_up": (nl, c.hidden, c.ffn),
        "layers/w_down": (nl, c.ffn, c.hidden),
        "layers/ln_att": (nl, c.hidden),
        "layers/ln_mlp": (nl, c.hidden),
        "ln_f": (c.hidden,),
        "head": (c.hidden, c.vocab_size),
    }


class Llama(nn.Module):
    """The weights, in the JAX package's stacked layout.  ``tok_emb``,
    ``ln_f`` and ``head`` are parameters of the module; the per-layer
    stacks live in ``layers`` (``layers["wq"]`` is ``(L, E, H, D)``)."""

    def __init__(self, cfg: Config, tensors: dict):
        super().__init__()
        self.cfg = cfg
        shapes = param_shapes(cfg)
        if set(tensors) != set(shapes):
            raise ValueError(
                f"llama weights need keys {sorted(shapes)}, got {sorted(tensors)}"
            )
        for key, want in shapes.items():
            if tuple(tensors[key].shape) != want:
                raise ValueError(
                    f"llama weight {key} has shape {tuple(tensors[key].shape)}, "
                    f"config wants {want}"
                )
        frozen = {k: nn.Parameter(t, requires_grad=False) for k, t in tensors.items()}
        self.tok_emb = frozen["tok_emb"]
        self.ln_f = frozen["ln_f"]
        self.head = frozen["head"]
        self.layers = nn.ParameterDict({k: frozen[f"layers/{k}"] for k in LAYER_KEYS})

    def layer(self, li: int) -> dict:
        """Views of layer ``li``'s weights."""
        return {k: self.layers[k][li] for k in LAYER_KEYS}

    def forward(self, tokens: torch.Tensor, seq_impl: str = "flash") -> torch.Tensor:
        """Full-sequence logits ``(B, L, V)``."""
        return forward(self, tokens, self.cfg, seq_impl=seq_impl)



# ---------------------------------------------------------------------------
# batched multi-LoRA adapters
# ---------------------------------------------------------------------------
#
# ONE stacked adapter pool, ``(n_layers, n_adapters, ...)`` per low-rank
# factor, and a per-row adapter id gathered inside the same prefill and
# decode bodies that serve the base model: a mixed-adapter batch is one
# decode block.  Row 0 is the null adapter (all-zero factors): its delta is
# exactly zero, so a null-adapter row gets the bits of a LoRA-off build.

LORA_ATTN_TARGETS = ("wq", "wk", "wv", "wo")
LORA_MLP_TARGETS = ("w_gate", "w_up", "w_down")


def _lora_shapes(cfg: Config, rank: int) -> dict:
    """Per-target ``(a, b)`` factor shapes without the leading ``(n_layers,
    n_adapters)`` axes: ``delta = (x @ a) @ b`` has the base projection's
    contraction and output."""
    e, h, kv, d, f = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn
    return {
        "wq": ((e, rank), (rank, h, d)),
        "wk": ((e, rank), (rank, kv, d)),
        "wv": ((e, rank), (rank, kv, d)),
        "wo": ((h, d, rank), (rank, e)),
        "w_gate": ((e, rank), (rank, f)),
        "w_up": ((e, rank), (rank, f)),
        "w_down": ((f, rank), (rank, e)),
    }


def init_lora_params(cfg: Config, n_adapters: int, rank: int,
                     targets: tuple = LORA_ATTN_TARGETS, dtype=torch.float32,
                     device="cpu") -> dict:
    """The zero stacked adapter pool ``{target: {"a": (L, A, in.., r), "b":
    (L, A, r, out..)}}``; row 0 stays all-zero (the null adapter)."""
    shapes = _lora_shapes(cfg, int(rank))
    lead = (cfg.n_layers, int(n_adapters))
    return {t: {"a": torch.zeros(lead + shapes[t][0], dtype=dtype, device=device),
                "b": torch.zeros(lead + shapes[t][1], dtype=dtype, device=device)}
            for t in targets}


@torch.no_grad()
def lora_adapter_factors(generator: torch.Generator, cfg: Config, rank: int,
                         targets: tuple = LORA_ATTN_TARGETS, scale: float = 0.05,
                         dtype=torch.float32, device="cpu") -> dict:
    """ONE adapter's synthetic factors ``{target: {"a": (L, in.., r), "b":
    (L, r, out..)}}`` drawn from ``generator``: ``a`` is normal / sqrt(fan
    in), ``b`` normal * ``scale`` (non-zero, unlike a training init, so
    distinct adapters give distinct generations).  The JAX package draws the
    same distribution from its own generator, so the numbers differ."""
    shapes = _lora_shapes(cfg, int(rank))
    out = {}
    for t in targets:
        sa, sb = shapes[t]
        a = torch.randn((cfg.n_layers,) + sa, generator=generator, device=device)
        b = torch.randn((cfg.n_layers,) + sb, generator=generator, device=device)
        out[t] = {"a": (a / math.sqrt(math.prod(sa[:-1]))).to(dtype),
                  "b": (b * scale).to(dtype)}
    return out


def lora_pool_bytes(cfg: Config, n_adapters: int, rank: int,
                    targets: tuple = LORA_ATTN_TARGETS, dtype="float32") -> int:
    """Device bytes the stacked adapter pool costs (the ``adapter_pool``
    class of the memory ledger)."""
    shapes = _lora_shapes(cfg, int(rank))
    per = sum(math.prod(shapes[t][0]) + math.prod(shapes[t][1]) for t in targets)
    return per * cfg.n_layers * int(n_adapters) * _itemsize(dtype)


def _lora_layer(lora: dict | None, li: int) -> dict | None:
    """Layer ``li``'s slice of the stacked pool (views)."""
    if lora is None:
        return None
    return {t: {"a": f["a"][li], "b": f["b"][li]} for t, f in lora.items()}


def _lora_delta(h, la, aid):
    """Per-row low-rank delta: ``h (B, L, in..)`` through adapter ``aid[b]``'s
    factors, gathered from one layer's slice ``la = {"a": (A, in.., r), "b":
    (A, r, out..)}``: an index gather per factor and two batched products."""
    a = la["a"][aid]  # (B, in.., r)
    b = la["b"][aid]  # (B, r, out..)
    if a.ndim == 4:  # the output projection's input (B, L, H, D)
        xa = torch.bmm(h.flatten(-2), a.flatten(1, 2))
    else:
        xa = torch.bmm(h, a)
    if b.ndim == 4:  # a head-shaped output (B, r, H|KV, D)
        return torch.bmm(xa, b.flatten(2)).unflatten(-1, b.shape[2:])
    return torch.bmm(xa, b)


def _with_lora(op, name, base, t, ll, aid):
    """``base`` plus target ``name``'s delta of ``t`` when the layer's pool
    slice ``ll`` holds that target; the delta is the op ``name + ".lora"``."""
    if ll is None or name not in ll:
        return base
    return base + op(name + ".lora", lambda u: _lora_delta(u, ll[name], aid), t)


def _aid(lora, ids, n: int, device):
    """The per-row adapter ids as a long ``(n,)`` tensor on ``device`` (None
    without a pool; no ids means the null adapter everywhere).  A Python
    int becomes a fill on the device, never a copy from the host."""
    if lora is None:
        return None
    if ids is None or isinstance(ids, int):
        return torch.full((n,), int(ids or 0), dtype=torch.long, device=device)
    return torch.as_tensor(ids, device=device).reshape(n).long()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _per_query(fn, x, split: bool):
    """``fn`` over ``x (S, L, ...)``: in one call, or (``split``, L > 1) once
    per query position over a contiguous ``(S, 1, ...)`` slice, which is
    the plain decode step's shape; the rows keep their order."""
    if not split or x.shape[1] == 1:
        return fn(x)
    xt = x.transpose(0, 1).contiguous()
    return torch.cat([fn(xt[j].unsqueeze(1)) for j in range(x.shape[1])], dim=1)


def _plain(name, fn, t):
    """The default op hook of the layer helpers: ``fn(t)`` in one call."""
    return fn(t)


def _row_split_op(names: frozenset):
    """An op hook that runs the ops in ``names`` once per query position
    (:func:`_per_query`) and the others in one call."""
    def op(name, fn, t):
        return _per_query(fn, t, name in names)

    return op


def _row_tiled(fn, t, tile: int):
    """``fn`` over ``t (B, R, ...)`` in calls of exactly ``tile`` rows along
    dim 1, the last one zero-padded; the padding's rows are dropped."""
    rows = t.shape[1]
    n = -(-rows // tile)
    if n * tile != rows:
        t = torch.cat([t, t.new_zeros((t.shape[0], n * tile - rows) + tuple(t.shape[2:]))], 1)
    return torch.cat([fn(t[:, i * tile:(i + 1) * tile]) for i in range(n)], 1)[:, :rows]


def row_tiled_op(names: frozenset, tile: int):
    """An op hook for the prefill bodies: the ops in ``names`` run in fixed
    tiles of ``tile`` rows (:func:`_row_tiled`), the others in one call, so
    that a cold prefill, a suffix prefill and a chunk give those ops the
    same row count whatever their lengths."""
    def op(name, fn, t):
        return _row_tiled(fn, t, tile) if name in names else fn(t)

    return op


def _rmsnorm(x, w, eps, op=_plain):
    """RMS norm over the last dim; its one sum, the mean of squares, is the
    op ``norm``."""
    var = op("norm", lambda t: t.mean(dim=-1, keepdim=True), x.float().square())
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope(x, positions, theta):
    """x: (..., L, H, D); positions: (..., L) integer."""
    d = x.shape[-1]
    exps = -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = torch.pow(float(theta), exps)  # a scalar base: no host-to-device copy
    angles = positions[..., None].float() * freqs  # (..., L, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _proj_heads(h, w):
    """``einsum("ble,ehd->blhd")`` as one matrix product."""
    E, H, D = w.shape
    return (h @ w.reshape(E, H * D)).unflatten(-1, (H, D))


def _mlp_block(h, lp, op=_plain, ll=None, aid=None):
    """SwiGLU MLP, with the per-row LoRA deltas of the pool slice ``ll``."""
    gate = _with_lora(op, "w_gate", op("w_gate", lambda t: t @ lp["w_gate"], h), h, ll, aid)
    up = _with_lora(op, "w_up", op("w_up", lambda t: t @ lp["w_up"], h), h, ll, aid)
    act = torch.nn.functional.silu(gate) * up
    return _with_lora(op, "w_down", op("w_down", lambda t: t @ lp["w_down"], act), act, ll, aid)


def _out_proj(o, wo):
    """``einsum("blhd,hde->ble")`` as one matrix product."""
    H, D, E = wo.shape
    return o.flatten(-2) @ wo.reshape(H * D, E)


def _select_attn(seq_impl: str):
    """``(q, k, v) -> o`` over ``(B, L, H|KV, D)``; k/v keep their KV
    heads.  ``flash`` is the hand-written kernel (GQA-aware, no repeat);
    ``dense`` the plain masked softmax over repeated K/V."""
    if seq_impl == "flash":
        return flash_causal_attention_blhd
    if seq_impl == "dense":
        def dense(q, k, v):
            H = q.shape[2]
            return _dense_causal_attention(q, _repeat_heads(k, H), _repeat_heads(v, H))

        return dense
    raise ValueError(f"seq_impl must be 'flash' or 'dense', got {seq_impl!r}")


def _qkv(x, lp, cfg: Config, positions, op=_plain, ll=None, aid=None):
    """The attention input of one layer: post-RoPE ``q``, ``k`` and ``v``.
    ``op(name, fn, t)`` runs each named op (:data:`ROW_OPS`) of the layer;
    ``ll``/``aid`` are the layer's adapter-pool slice and the per-row
    adapter ids (None: the base model)."""
    h = _rmsnorm(x, lp["ln_att"], cfg.norm_eps, op)
    q = _with_lora(op, "wq", op("wq", lambda t: _proj_heads(t, lp["wq"]), h), h, ll, aid)
    k = _with_lora(op, "wk", op("wk", lambda t: _proj_heads(t, lp["wk"]), h), h, ll, aid)
    v = _with_lora(op, "wv", op("wv", lambda t: _proj_heads(t, lp["wv"]), h), h, ll, aid)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def _layer_out(x, o, lp, cfg: Config, op=_plain, ll=None, aid=None):
    """Output projection, residual and MLP of one layer."""
    x = x + _with_lora(op, "wo", op("wo", lambda t: _out_proj(t, lp["wo"]), o), o, ll, aid)
    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps, op)
    return x + _mlp_block(h, lp, op, ll, aid)


def _layer(x, lp, cfg: Config, positions, attn_fn, kv_hook=None, op=_plain, ll=None,
           aid=None):
    """``kv_hook(k, v) -> (k_attn, v_attn, stored)`` lets an int8 pool
    attend the dequantized values it will hold (fake-quant: a reused
    prefix then reads the K/V the cold prefill attended)."""
    q, k, v = _qkv(x, lp, cfg, positions, op, ll, aid)
    if kv_hook is None:
        ka, va, stored = k, v, (k, v)
    else:
        ka, va, stored = kv_hook(k, v)
    return _layer_out(x, attn_fn(q, ka, va), lp, cfg, op, ll, aid), stored


def _prefill_core(params: Llama, tokens, cfg: Config, attn_fn, kv_hook=None, op=_plain,
                  lora=None, aid=None):
    """Embed + the layer loop.  Returns ``(hidden (B, L, E), stored)``:
    ``(ks, vs)`` with ``(layers, B, L, kv, hd)`` each, or the kv_hook's
    ``(qk, sk, qv, sv)`` stacked over layers the same way.  ``lora``/``aid``:
    the stacked adapter pool and the per-row adapter ids."""
    x = params.tok_emb[tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    stored = []
    for li in range(cfg.n_layers):
        x, st = _layer(x, params.layer(li), cfg, positions, attn_fn, kv_hook, op,
                       _lora_layer(lora, li), aid)
        stored.append(st)
    return x, tuple(torch.stack(parts) for parts in zip(*stored))


@torch.no_grad()
def forward(params: Llama, tokens, cfg: Config, *, seq_impl: str = "flash"):
    """Full-sequence logits ``(B, L, V)``."""
    x, _ = _prefill_core(params, tokens, cfg, _select_attn(seq_impl))
    x = _rmsnorm(x, params.ln_f, cfg.norm_eps)
    return x @ params.head


@torch.no_grad()
def embed_pooled(params: Llama, tokens, length: int, cfg: Config, *,
                 seq_impl: str = "flash", op=_plain) -> torch.Tensor:
    """Mean-pooled final hidden state of one prompt: the embeddings path.

    ``tokens (1, Lpad)`` is right-padded to a bucket; ``length`` the true
    prompt length.  A pure forward through the prefill core (flash
    attention and the prefill's op hook, as a cold prefill runs them): no
    KV is written and no slot is taken.  Returns the final-norm hidden
    states averaged in f32 over the real rows only, ``(E,)``: the padding
    rows are left out of the sum, so the vector does not depend on the
    bucket the prompt landed in."""
    x, _ = _prefill_core(params, tokens, cfg, _select_attn(seq_impl), op=op)
    h = _rmsnorm(x[0, : int(length)], params.ln_f, cfg.norm_eps).float()
    return h.sum(dim=0) / max(int(length), 1)


# ---------------------------------------------------------------------------
# paged KV cache (block pool + per-slot block tables)
# ---------------------------------------------------------------------------
#
#   k/v: (layers, n_blocks, block_size, kv_heads, head_dim)
#   table: (n_slots, max_seq // block_size) int32 — physical block ids
#
# A slot's logical position p lives in physical row
# ``(table[slot, p // bs], p % bs)``.  Block 0 is the sink that inactive
# slots write into; the allocator never hands it out.


def init_paged_cache(
    cfg: Config, n_slots: int, n_blocks: int, block_size: int,
    dtype=torch.float32, device="cpu", kv_dtype: str | None = None,
) -> dict:
    """``kv_dtype="int8"`` stores K/V pages as int8 with one ``dtype``
    scale per (position, kv-head): ``k_scale``/``v_scale`` of shape
    ``(layers, n_blocks, block_size, kv_heads)``, about half the bytes of
    a 16-bit pool.  Writes quantize per row (decode appends never rescale
    their neighbours); reads dequantize."""
    if cfg.max_seq % block_size:
        raise ValueError(
            f"max_seq {cfg.max_seq} must be a multiple of block_size {block_size}"
        )
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    mb = cfg.max_seq // block_size
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    page_dtype = torch.int8 if kv_dtype == "int8" else dtype
    cache = {
        "k": torch.zeros(shape, dtype=page_dtype, device=device),
        "v": torch.zeros(shape, dtype=page_dtype, device=device),
        "pos": torch.zeros(n_slots, dtype=torch.int32, device=device),
        "table": torch.zeros(n_slots, mb, dtype=torch.int32, device=device),
    }
    if kv_dtype == "int8":
        cache["k_scale"] = torch.zeros(shape[:4], dtype=dtype, device=device)
        cache["v_scale"] = torch.zeros(shape[:4], dtype=dtype, device=device)
    return cache


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return 2 if str(dtype) in ("bfloat16", "bf16") else np.dtype(dtype).itemsize


def paged_kv_slot_bytes(
    cfg: Config, block_size: int, *, kv_dtype: str | None = None, dtype="float32"
) -> int:
    """Device bytes one max_seq slot costs in the paged pool.  ``dtype`` is
    the pool's float dtype (a ``torch.dtype`` or its name; the scales use
    it too); an int8 pool bills 1 byte per element plus one scale per
    (position, kv-head)."""
    itemsize = _itemsize(dtype)
    if kv_dtype == "int8":
        per_head = cfg.head_dim + itemsize  # int8 row + one scale
    else:
        per_head = cfg.head_dim * itemsize
    return cfg.max_seq * 2 * cfg.n_kv_heads * per_head * cfg.n_layers  # K and V


def _quant_kv(x, scale_dtype):
    """``x (..., head_dim)`` float -> ``(int8 (..., head_dim), scale (...))``.
    Symmetric absmax per (position, head): the largest magnitude maps to
    exactly +-127.  ``q`` is computed against the f32 scale (rounded half
    to even, as ``jnp.round``); only then is the scale stored in
    ``scale_dtype``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def _dequant_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _fake_quant_hook(scale_dtype):
    """kv_hook for :func:`_layer` under an int8 pool: attention sees the
    dequantized values, the layer loop collects ``(qk, sk, qv, sv)``."""

    def hook(k, v):
        qk, sk = _quant_kv(k, scale_dtype)
        qv, sv = _quant_kv(v, scale_dtype)
        return _dequant_kv(qk, sk, k.dtype), _dequant_kv(qv, sv, v.dtype), (qk, sk, qv, sv)

    return hook


@torch.no_grad()
def prefill_slot_paged(
    params: Llama, tokens, length: int, slot: int, blocks_row, cache: dict,
    cfg: Config, *, seq_impl: str = "flash", return_hidden: bool = False, op=_plain,
    lora: dict | None = None, adapter_id=None,
):
    """Prefill ONE request's prompt into the blocks reserved for ``slot``.

    ``tokens (1, Lpad)`` is right-padded to a bucket that is a multiple of
    the block size; ``blocks_row (max_blocks,)`` the slot's table row
    (reserved physical ids, zero-padded: pad rows land in the sink).
    Under an int8 pool the attention sees the dequantized K/V the pool
    will hold.  ``op`` runs the layer's named ops (:func:`row_tiled_op`).
    ``lora``/``adapter_id`` (an int or a ``(1,)`` tensor) select the
    request's adapter from the stacked pool; row 0, or no pool, is the base
    model.
    Returns ``(last_logits (V,), cache)``, plus the post-``ln_f`` hidden
    ``(E,)`` at that position when ``return_hidden`` (the Medusa heads'
    input); the cache is updated in place."""
    bs = cache["k"].shape[2]
    lp = tokens.shape[1]
    if lp % bs:
        raise ValueError(f"prefill bucket {lp} is not a multiple of block size {bs}")
    quant = "k_scale" in cache
    hook = _fake_quant_hook(cache["k_scale"].dtype) if quant else None
    x, stored = _prefill_core(params, tokens, cfg, _select_attn(seq_impl), hook, op,
                              lora, _aid(lora, adapter_id, 1, tokens.device))
    lb = lp // bs
    rows = (cfg.n_layers, lb, bs, cfg.n_kv_heads)
    blocks_row = torch.as_tensor(blocks_row, dtype=torch.int32, device=tokens.device)
    phys = blocks_row[:lb].long()
    names = ("k", "k_scale", "v", "v_scale") if quant else ("k", "v")
    for name, part in zip(names, stored):
        pool = cache[name]
        pool[:, phys] = part[:, 0].reshape(rows + pool.shape[4:]).to(pool.dtype)
    cache["pos"][slot] = int(length)
    cache["table"][slot] = blocks_row
    h = _rmsnorm(x[0, int(length) - 1], params.ln_f, cfg.norm_eps)
    if return_hidden:
        return h @ params.head, cache, h
    return h @ params.head, cache


@torch.no_grad()
def prefill_suffix_paged(
    params: Llama, tokens, prefix_len: int, length: int, slot: int, blocks_row,
    suffix_blocks, cache: dict, cfg: Config, *, prefix_window: int,
    return_hidden: bool = False, op=_plain, lora: dict | None = None, adapter_id=None,
):
    """Prefill only the SUFFIX of a prompt whose first ``prefix_len``
    tokens already have K/V in the slot's table blocks: a reused prefix
    (``cache/prefix.py``) or the earlier chunks of a chunked prefill.

    ``tokens (1, Ls)`` is the suffix right-padded to a multiple of the
    block size; ``prefix_len`` a multiple of the block size; ``length`` the
    total true length; ``blocks_row`` the slot's full table row, whose
    first ``prefix_window // bs`` entries are gathered (``prefix_window``
    covers ``prefix_len``); ``suffix_blocks (Ls // bs,)`` the physical
    blocks the suffix K/V is written to (sink 0 past the reservation).

    The suffix queries attend ``[prefix ++ suffix]``: prefix column j is
    visible iff ``j < prefix_len``, suffix columns are causal.  On a CUDA
    tensor that is the flash kernel's bottom-right aligned variant over the
    prefix's ``prefix_len`` rows (gathered from the pool, dequantized from
    an int8 pool as the cold prefill's fake-quant attends them) followed by
    the suffix's own K/V, so a row gets the cold prefill's bits; on the CPU
    the einsum, mask and softmax of the dense prefill.  ``op`` runs the
    layer's named ops (:func:`row_tiled_op`); ``lora``/``adapter_id`` as in
    :func:`prefill_slot_paged`.  Returns ``(last_logits (V,), cache)``; the
    cache is updated in place."""
    bs = cache["k"].shape[2]
    ls = tokens.shape[1]
    if ls % bs:
        raise ValueError(f"suffix bucket {ls} is not a multiple of block size {bs}")
    dev = tokens.device
    pb = max(1, int(prefix_window) // bs)
    lb = ls // bs
    kvh, hd, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    quant = "k_scale" in cache
    hook = _fake_quant_hook(cache["k_scale"].dtype) if quant else None
    blocks_row = torch.as_tensor(blocks_row, dtype=torch.int32, device=dev)
    suffix_blocks = torch.as_tensor(suffix_blocks, dtype=torch.int32, device=dev).long()
    flash = dev.type == "cuda"
    P = int(prefix_len)
    # the flash route gathers exactly the prefix's blocks; the einsum route
    # the window's, whose columns past prefix_len the mask hides
    nread = P // bs if flash else pb
    read_idx = blocks_row[:nread].long()
    aid = _aid(lora, adapter_id, 1, dev)
    x = params.tok_emb[tokens.long()]  # (1, Ls, E)
    positions = (P + torch.arange(ls, device=dev))[None, :]
    if not flash:
        cols = torch.arange(ls, device=dev)
        prefix_valid = torch.arange(pb * bs, device=dev)[None, :] < P
        mask = torch.cat([prefix_valid.expand(ls, pb * bs), cols[:, None] >= cols[None, :]], dim=1)
        scale = 1.0 / math.sqrt(hd)
    ck, cv = cache["k"], cache["v"]
    for li in range(cfg.n_layers):
        lp, ll = params.layer(li), _lora_layer(lora, li)
        q, k, v = _qkv(x, lp, cfg, positions, op, ll, aid)
        if quant:
            k, v, (qk, sk, qv, sv) = hook(k, v)
            cks, cvs = cache["k_scale"][li], cache["v_scale"][li]
            kp = _dequant_kv(ck[li][read_idx], cks[read_idx], k.dtype)
            vp = _dequant_kv(cv[li][read_idx], cvs[read_idx], v.dtype)
        else:
            kp = ck[li][read_idx].to(k.dtype)
            vp = cv[li][read_idx].to(v.dtype)
        kf = torch.cat([kp.reshape(1, nread * bs, kvh, hd), k], dim=1)
        vf = torch.cat([vp.reshape(1, nread * bs, kvh, hd), v], dim=1)
        if flash:
            o = flash_causal_attention_blhd(q, kf, vf)
        else:
            kf, vf = _repeat_heads(kf, H), _repeat_heads(vf, H)
            s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf)
        x = _layer_out(x, o, lp, cfg, op, ll, aid)
        # written after this layer's gather: the window may reach into the
        # first suffix blocks, whose columns the mask hides
        if quant:
            ck[li, suffix_blocks] = qk[0].reshape(lb, bs, kvh, hd)
            cv[li, suffix_blocks] = qv[0].reshape(lb, bs, kvh, hd)
            cks[suffix_blocks] = sk[0].reshape(lb, bs, kvh)
            cvs[suffix_blocks] = sv[0].reshape(lb, bs, kvh)
        else:
            ck[li, suffix_blocks] = k[0].reshape(lb, bs, kvh, hd).to(ck.dtype)
            cv[li, suffix_blocks] = v[0].reshape(lb, bs, kvh, hd).to(cv.dtype)
    cache["pos"][slot] = int(length)
    cache["table"][slot] = blocks_row
    h = _rmsnorm(x[0, int(length) - int(prefix_len) - 1], params.ln_f, cfg.norm_eps)
    if return_hidden:
        return h @ params.head, cache, h
    return h @ params.head, cache


@torch.no_grad()
def decode_slots_paged(
    params: Llama, tokens, cache: dict, active, cfg: Config, *,
    window: int | None = None, kernel: bool = True, lora: dict | None = None,
    adapter_ids=None,
):
    """One decode step for every slot against the paged cache:
    ``tokens (S,)`` -> ``(logits (S, V), cache)``; only ``active`` slots
    advance their position.  Attention reads the first ``window //
    block_size`` table entries per slot; ``kernel`` routes the read through
    the paged decode-attention kernel (the plain gather path otherwise).
    ``lora``/``adapter_ids (S,)`` gather each slot's adapter delta inside the
    same step: a mixed-adapter batch is one call."""
    logits, cache = _decode_paged_multi(
        params, tokens[:, None], cache, active, active[:, None], cfg,
        window=window, kernel=kernel, lora=lora, adapter_ids=adapter_ids,
    )
    cache["pos"].add_(active.to(torch.int32))
    return logits[:, 0], cache


@torch.no_grad()
def decode_slots_spec_paged(
    params: Llama, qtokens, cache: dict, active, qvalid, cfg: Config, *,
    window: int | None = None, kernel: bool = True, return_hidden: bool = False,
    row_split: frozenset = frozenset(), lora: dict | None = None, adapter_ids=None,
):
    """Speculative verify pass: score ``L = 1 + draft`` query positions per
    slot in ONE model call.

    ``qtokens (S, L)`` is the current token followed by the drafted ones;
    query ``j`` runs at position ``pos + j`` and its K/V is written there.
    ``qvalid (S, L)`` gates those writes: a draft position at or past the
    slot's remaining budget (whose block may not be reserved) and every
    position of an inactive slot go to the sink block 0, scales too.
    ``cache["pos"]`` is NOT advanced: the caller moves it by the tokens it
    accepts, and rejected rows above it are overwritten by the next pass
    before anything reads them.  ``row_split`` names the ops run once per
    query position (:func:`row_variant_ops`), so that row ``j``'s bits are
    those of a plain step at ``pos + j`` (a LoRA delta is an op of its own,
    ``wq.lora`` and so on).  ``lora``/``adapter_ids`` as in
    :func:`decode_slots_paged`.  Returns ``(logits (S, L, V), cache)``, plus
    the post-``ln_f`` hidden ``(S, L, E)`` when ``return_hidden``."""
    return _decode_paged_multi(
        params, qtokens, cache, active, qvalid, cfg, window=window, kernel=kernel,
        return_hidden=return_hidden, row_split=row_split, lora=lora, adapter_ids=adapter_ids,
    )


# the ops of the decode body whose rows a library may reduce in an order
# that follows the row count: the RMS norms' mean of squares and the
# products, by weight (each LoRA delta is one more op, ``wq.lora`` ...)
ROW_OPS = ("norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head")


def _product_shapes(cfg: Config) -> dict:
    """``(K, N)`` of each product among :data:`ROW_OPS`."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (cfg.hidden, H * D), "wk": (cfg.hidden, KV * D), "wv": (cfg.hidden, KV * D),
            "wo": (H * D, cfg.hidden), "w_gate": (cfg.hidden, cfg.ffn),
            "w_up": (cfg.hidden, cfg.ffn), "w_down": (cfg.ffn, cfg.hidden),
            "head": (cfg.hidden, cfg.vocab_size)}


def _lora_product_shapes(cfg: Config, lora: tuple | None) -> dict:
    """``(K, N)`` of the two batched products of each LoRA delta op
    (``wq.lora`` ...) for ``lora = (rank, targets)``; empty without."""
    if not lora:
        return {}
    rank, targets = int(lora[0]), tuple(lora[1])
    shapes = _lora_shapes(cfg, rank)
    return {f"{t}.lora": ((math.prod(shapes[t][0][:-1]), rank),
                          (rank, math.prod(shapes[t][1][1:]))) for t in targets}


def _cancelling(gen, batch: int, rows: int, K: int, N: int, dtype, device):
    """Probe operands of a batched product whose exact result is 0: ``[a,
    -a]`` rows against ``[w; w]``, so that only the rounding of the partial
    sums, which follows the summation order, is left."""
    a = torch.randn(batch, rows, K // 2, generator=gen, device=device)
    w = torch.randn(batch, K // 2, N, generator=gen, device=device)
    return torch.cat([a, -a], dim=-1).to(dtype), torch.cat([w, w], dim=1).to(dtype)


@torch.no_grad()
def row_variant_ops(cfg: Config, n_rows: int, L: int, dtype=torch.float32, device="cpu",
                    seed: int = 0, lora: tuple | None = None) -> frozenset:
    """The :data:`ROW_OPS` whose rows get other bits on ``device`` in
    ``dtype`` when the op sees ``n_rows * L`` rows instead of ``n_rows``.
    A library picks its algorithm, and with it the order of a row's sums,
    by the shape (never by the values), so the probe runs each op's shapes
    on made-up values whose sums cancel: a product of ``[a, -a]`` rows with
    ``[w; w]`` is 0 but for the rounding of its partial sums, which any
    other summation order changes; for the norm it compares the f32 mean of
    squares, the one sum in :func:`_rmsnorm`.  A verify pass runs the ops
    found once per query position (``row_split``), so that its rows equal
    the plain step's bit for bit.  With ``lora = (rank, targets)`` each
    delta op's two batched products (``n_rows`` batches of ``L`` rows
    against batches of one row) are probed too."""
    if L <= 1:
        return frozenset()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    rows = int(n_rows) * int(L)
    out = set()
    for name, (K, N) in _product_shapes(cfg).items():
        a = torch.randn(rows, 1, K // 2, generator=gen, device=device)
        w = torch.randn(K // 2, N, generator=gen, device=device)
        x = torch.cat([a, -a], dim=-1).to(dtype)
        w = torch.cat([w, w]).to(dtype)
        if not torch.equal((x @ w)[: int(n_rows)], x[: int(n_rows)].contiguous() @ w):
            out.add(name)
    x = torch.randn(rows, 1, cfg.hidden, generator=gen, device=device).to(dtype)

    def sumsq(t):
        return t.float().square().mean(dim=-1, keepdim=True)

    if not torch.equal(sumsq(x)[: int(n_rows)], sumsq(x[: int(n_rows)].contiguous())):
        out.add("norm")
    lgen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    for name, prods in _lora_product_shapes(cfg, lora).items():
        for K, N in prods:
            x, w = _cancelling(lgen, int(n_rows), int(L), K, N, dtype, device)
            if not torch.equal(torch.bmm(x, w)[:, :1], torch.bmm(x[:, :1].contiguous(), w)):
                out.add(name)
    return frozenset(out)


# rows a prefill runs each row-variant op in (row_tiled_op): one 256-token
# chunk is one call
PREFILL_ROW_TILE = 256


@torch.no_grad()
def prefill_variant_ops(cfg: Config, sizes, dtype=torch.float32, device="cpu",
                        seed: int = 0, lora: tuple | None = None) -> frozenset:
    """The ops of a prefill layer (:data:`ROW_OPS` but the ``lm_head``, which
    a prefill runs on one row) whose rows get other bits on ``device`` in
    ``dtype`` at another row count: for each pair of consecutive ``sizes``
    ``(n, m)``, the first and the last ``n`` rows of an ``m``-row call
    against calls on those ``n`` rows alone, with the probe values of
    :func:`row_variant_ops`.  A cold prefill, a suffix prefill and a chunk
    run the ops found in fixed row tiles (:func:`row_tiled_op`), so that a
    reused prefix or an earlier chunk holds the K/V a cold prefill
    writes.  With ``lora = (rank, targets)`` each delta op's two batched
    products are probed too (one batch of ``m`` rows against ``n``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = {k: v for k, v in _product_shapes(cfg).items() if k != "head"}
    sizes = sorted(int(n) for n in sizes)
    pairs = list(zip(sizes, sizes[1:]))

    def differs(fn, x, n, m):
        big = fn(x)
        return not (torch.equal(big[:, :n], fn(x[:, :n].contiguous()))
                    and torch.equal(big[:, m - n:], fn(x[:, m - n:].contiguous())))

    out = set()
    for name, (K, N) in shapes.items():
        w = torch.randn(K // 2, N, generator=gen, device=device)
        w = torch.cat([w, w]).to(dtype)
        for n, m in pairs:
            a = torch.randn(1, m, K // 2, generator=gen, device=device)
            if differs(lambda t: t @ w, torch.cat([a, -a], dim=-1).to(dtype), n, m):
                out.add(name)
                break
    for n, m in pairs:
        x = torch.randn(1, m, cfg.hidden, generator=gen, device=device).to(dtype)
        if differs(lambda t: t.float().square().mean(dim=-1, keepdim=True), x, n, m):
            out.add("norm")
            break
    lgen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    for name, prods in _lora_product_shapes(cfg, lora).items():
        for (K, N), (n, m) in ((kn, nm) for kn in prods for nm in pairs):
            x, w = _cancelling(lgen, 1, m, K, N, dtype, device)
            if differs(lambda t: torch.bmm(t, w), x, n, m):
                out.add(name)
                break
    return frozenset(out)


def _decode_paged_multi(params: Llama, qtokens, cache, active, qvalid, cfg: Config, *,
                        window, kernel: bool = True, return_hidden: bool = False,
                        row_split: frozenset = frozenset(), lora: dict | None = None,
                        adapter_ids=None):
    """Shared L-query decode body (``L = 1`` is the decode step, ``L > 1``
    the speculative verify).  This step's K/V rows are written into the
    pool first (quantized per row under an int8 pool; rows whose ``qvalid``
    is false into the sink block 0, scales too), then attention reads the
    slot's window (the kernel dequantizes int8 pages itself).  The ops
    named in ``row_split`` (:func:`row_variant_ops`) run once per query
    position, as the plain step runs them; the math is the same."""
    del active  # the write routing reads qvalid; kept for the JAX signature
    pos = cache["pos"]  # (S,)
    table = cache["table"]  # (S, MB)
    S, L = qtokens.shape
    bs = cache["k"].shape[2]
    mb = table.shape[1]
    quant = "k_scale" in cache
    W = cfg.max_seq if window is None else min(int(window), cfg.max_seq)
    wb = max(1, W // bs)
    read_idx = table[:, :wb].contiguous()  # (S, wb) physical blocks attention reads
    x = params.tok_emb[qtokens.long()]  # (S, L, E)
    positions = pos.long()[:, None] + torch.arange(L, device=pos.device)[None, :]  # (S, L)
    write_blk = torch.where(
        qvalid,
        torch.take_along_dim(table, torch.clamp(positions // bs, max=mb - 1), dim=1).long(),
        0,
    )  # (S, L)
    write_off = positions % bs
    attend = paged_decode_attention if kernel else paged_decode_attention_plain
    ck, cv = cache["k"], cache["v"]
    op = _row_split_op(row_split) if row_split else _plain
    aid = _aid(lora, adapter_ids, S, pos.device)
    for li in range(cfg.n_layers):
        lp, ll = params.layer(li), _lora_layer(lora, li)
        q, k, v = _qkv(x, lp, cfg, positions, op, ll, aid)
        ckl, cvl = ck[li], cv[li]
        scales = {}
        if quant:
            qk, sk = _quant_kv(k, cache["k_scale"].dtype)
            qv, sv = _quant_kv(v, cache["v_scale"].dtype)
            scales = {"k_scale": cache["k_scale"][li], "v_scale": cache["v_scale"][li]}
            ckl[write_blk, write_off] = qk
            cvl[write_blk, write_off] = qv
            scales["k_scale"][write_blk, write_off] = sk
            scales["v_scale"][write_blk, write_off] = sv
        else:
            ckl[write_blk, write_off] = k.to(ckl.dtype)
            cvl[write_blk, write_off] = v.to(cvl.dtype)
        o = attend(q.contiguous(), ckl, cvl, read_idx, pos, **scales)
        x = _layer_out(x, o, lp, cfg, op, ll, aid)
    x = _rmsnorm(x, params.ln_f, cfg.norm_eps, op)
    logits = op("head", lambda t: t @ params.head, x)
    if return_hidden:
        return logits, cache, x
    return logits, cache


# ---------------------------------------------------------------------------
# draft sources for speculation: Medusa-style heads and a layer-truncated
# self-draft.  Both only propose; the verify pass emits the model's own
# tokens, so neither changes the output, only the acceptance rate.
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_medusa_heads(generator: torch.Generator, cfg: Config, n_heads: int, base_head=None,
                      dtype=torch.float32, device="cpu") -> dict:
    """``n_heads`` Medusa-style draft heads: head ``j`` predicts the token
    ``j + 1`` positions past the one its input hidden emitted, as
    ``logits_j = (h + silu(h @ w1[j])) @ head[j]`` over the post-``ln_f``
    hidden ``h``.  ``w1`` is ``0.01 * normal`` from ``generator``; with
    ``base_head`` (the model's ``lm_head``) each output projection starts as
    a copy of it (untrained heads then draft "repeat the argmax"), else
    ``0.02 * normal``."""
    n_heads, e, v = int(n_heads), cfg.hidden, cfg.vocab_size
    w1 = 0.01 * torch.randn((n_heads, e, e), generator=generator, device=device)
    if base_head is not None:
        head = base_head.to(device=device, dtype=torch.float32)[None].expand(n_heads, e, v)
    else:
        head = 0.02 * torch.randn((n_heads, e, v), generator=generator, device=device)
    return {"w1": w1.to(dtype).contiguous(), "head": head.to(dtype).contiguous()}


def apply_medusa_heads(heads: dict, h: torch.Tensor) -> torch.Tensor:
    """Head logits ``(S, K, V)`` from per-slot hidden states ``h (S, E)``."""
    w1 = heads["w1"]
    hx = h.to(w1.dtype)
    hk = hx[:, None, :] + torch.nn.functional.silu(torch.einsum("se,kef->skf", hx, w1))
    return torch.einsum("ske,kev->skv", hk, heads["head"])


def medusa_head_bytes(cfg: Config, n_heads: int, dtype=torch.float32) -> int:
    """Device bytes ``n_heads`` resident Medusa heads cost."""
    e, v = cfg.hidden, cfg.vocab_size
    return int(n_heads) * (e * e + e * v) * _itemsize(dtype)


def truncate_params(params: Llama, n_layers: int) -> Llama:
    """A layer-truncated self-draft: the model's OWN first ``n_layers``
    blocks with its embedding, final norm and ``lm_head``.  The stacked
    layer tensors are sliced (views, no copy) and everything else is the
    same tensor; the result's ``cfg`` has ``n_layers`` layers."""
    n = int(n_layers)
    dcfg = dataclasses.replace(params.cfg, n_layers=n)
    tensors = {"tok_emb": params.tok_emb.data, "ln_f": params.ln_f.data,
               "head": params.head.data}
    for k in LAYER_KEYS:
        tensors[f"layers/{k}"] = params.layers[k].data[:n]
    return Llama(dcfg, tensors)


def sample_tokens(logits, temperature, generator: torch.Generator, top_k: int = 0):
    """Per-row sampling on the device: ``temperature (S,)`` <= 0 means greedy
    (the first maximal logit); otherwise a draw from the f32 softmax of
    ``logits / temperature``, restricted to the ``top_k`` highest logits
    when ``top_k > 0``.  The draw is Gumbel-max over noise from
    ``generator``, so a seeded generator gives a reproducible stream and no
    host sync."""
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    f32 = logits.float()
    if top_k and int(top_k) > 0:
        k = min(int(top_k), logits.shape[-1])
        vals, idx = torch.topk(f32, k, dim=-1)  # (S, k) descending
        local = _gumbel_argmax(vals / temp, generator)
        sampled = torch.take_along_dim(idx, local[:, None], dim=-1)[:, 0]
    else:
        sampled = _gumbel_argmax(f32 / temp, generator)
    return torch.where(temperature > 0, sampled, greedy).to(torch.int32)


def _gumbel_argmax(scores, generator):
    expo = torch.empty_like(scores).exponential_(generator=generator)
    return torch.argmax(scores - torch.log(expo), dim=-1)
