"""Llama-family decoder for generative serving, in PyTorch.

The counterpart of the JAX package's ``models/llama.py`` in its plain
configuration: a float paged KV pool, greedy and top-k sampling.  The
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
and ``ops.paged_decode_attention`` in every decode step (``kernel=True``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from seldon_core_tpu_torch.ops import flash_causal_attention_blhd, paged_decode_attention
from seldon_core_tpu_torch.ops.flash_attention import _dense_causal_attention, _repeat_heads
from seldon_core_tpu_torch.ops.paged_attention import paged_decode_attention_plain

__all__ = [
    "Config", "Llama", "init_paged_cache", "prefill_slot_paged",
    "decode_slots_paged", "sample_tokens", "forward",
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
# building blocks
# ---------------------------------------------------------------------------


def _rmsnorm(x, w, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
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


def _mlp_block(h, lp):
    """SwiGLU MLP."""
    act = torch.nn.functional.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return act @ lp["w_down"]


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


def _layer(x, lp, cfg: Config, positions, attn_fn):
    h = _rmsnorm(x, lp["ln_att"], cfg.norm_eps)
    q = _proj_heads(h, lp["wq"])
    k = _proj_heads(h, lp["wk"])
    v = _proj_heads(h, lp["wv"])
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attn_fn(q, k, v)
    x = x + _out_proj(o, lp["wo"])
    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    x = x + _mlp_block(h, lp)
    return x, (k, v)


def _prefill_core(params: Llama, tokens, cfg: Config, attn_fn):
    """Embed + the layer loop.  Returns ``(hidden (B, L, E), (ks, vs))``
    with ``ks``/``vs (layers, B, L, kv, hd)``."""
    x = params.tok_emb[tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        x, (k, v) = _layer(x, params.layer(li), cfg, positions, attn_fn)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks), torch.stack(vs))


@torch.no_grad()
def forward(params: Llama, tokens, cfg: Config, *, seq_impl: str = "flash"):
    """Full-sequence logits ``(B, L, V)``."""
    x, _ = _prefill_core(params, tokens, cfg, _select_attn(seq_impl))
    x = _rmsnorm(x, params.ln_f, cfg.norm_eps)
    return x @ params.head


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
    dtype=torch.float32, device="cpu",
) -> dict:
    if cfg.max_seq % block_size:
        raise ValueError(
            f"max_seq {cfg.max_seq} must be a multiple of block_size {block_size}"
        )
    mb = cfg.max_seq // block_size
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros(n_slots, dtype=torch.int32, device=device),
        "table": torch.zeros(n_slots, mb, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill_slot_paged(
    params: Llama, tokens, length: int, slot: int, blocks_row, cache: dict,
    cfg: Config, *, seq_impl: str = "flash",
):
    """Prefill ONE request's prompt into the blocks reserved for ``slot``.

    ``tokens (1, Lpad)`` is right-padded to a bucket that is a multiple of
    the block size; ``blocks_row (max_blocks,)`` the slot's table row
    (reserved physical ids, zero-padded: pad rows land in the sink).
    Returns ``(last_logits (V,), cache)``; the cache is updated in place."""
    bs = cache["k"].shape[2]
    lp = tokens.shape[1]
    if lp % bs:
        raise ValueError(f"prefill bucket {lp} is not a multiple of block size {bs}")
    x, (ks, vs) = _prefill_core(params, tokens, cfg, _select_attn(seq_impl))
    lb = lp // bs
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    blocks_row = torch.as_tensor(blocks_row, dtype=torch.int32, device=tokens.device)
    phys = blocks_row[:lb].long()
    ck, cv = cache["k"], cache["v"]
    ck[:, phys] = ks[:, 0].reshape(cfg.n_layers, lb, bs, kvh, hd).to(ck.dtype)
    cv[:, phys] = vs[:, 0].reshape(cfg.n_layers, lb, bs, kvh, hd).to(cv.dtype)
    cache["pos"][slot] = int(length)
    cache["table"][slot] = blocks_row
    h = _rmsnorm(x[0, int(length) - 1], params.ln_f, cfg.norm_eps)
    return h @ params.head, cache


@torch.no_grad()
def decode_slots_paged(
    params: Llama, tokens, cache: dict, active, cfg: Config, *,
    window: int | None = None, kernel: bool = True,
):
    """One decode step for every slot against the paged cache:
    ``tokens (S,)`` -> ``(logits (S, V), cache)``; only ``active`` slots
    advance their position.  Attention reads the first ``window //
    block_size`` table entries per slot; ``kernel`` routes the read through
    the paged decode-attention kernel (the plain gather path otherwise)."""
    logits, cache = _decode_paged_multi(
        params, tokens[:, None], cache, active, active[:, None], cfg,
        window=window, kernel=kernel,
    )
    cache["pos"].add_(active.to(torch.int32))
    return logits[:, 0], cache


def _decode_paged_multi(params: Llama, qtokens, cache, active, qvalid, cfg: Config, *,
                        window, kernel: bool = True):
    """Shared L-query decode body (``L = 1`` is the decode step).  This
    step's K/V rows are written into the pool first (inactive slots and
    positions past the table into the sink block 0), then attention reads
    the slot's window."""
    del active  # the write routing reads qvalid; kept for the JAX signature
    pos = cache["pos"]  # (S,)
    table = cache["table"]  # (S, MB)
    S, L = qtokens.shape
    bs = cache["k"].shape[2]
    mb = table.shape[1]
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
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        h = _rmsnorm(x, lp["ln_att"], cfg.norm_eps)
        q = _proj_heads(h, lp["wq"])
        k = _proj_heads(h, lp["wk"])
        v = _proj_heads(h, lp["wv"])
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        ckl, cvl = ck[li], cv[li]
        ckl[write_blk, write_off] = k.to(ckl.dtype)
        cvl[write_blk, write_off] = v.to(cvl.dtype)
        o = attend(q.contiguous(), ckl, cvl, read_idx, pos)
        x = x + _out_proj(o, lp["wo"])
        h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + _mlp_block(h, lp)
    x = _rmsnorm(x, params.ln_f, cfg.norm_eps)
    return x @ params.head, cache


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
