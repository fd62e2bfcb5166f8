"""BERT-base encoder classifier: the port of the JAX package's
``models/bert.py``.

Token-id batches ``(B, L)``; the attention mask is ``token_ids !=
pad_id`` and segment ids default to zeros.  The attention is the JAX
model's plain math (it reaches no Pallas kernel): scores scaled by
``1 / sqrt(head_dim)`` in the activation dtype, masked keys set to that
dtype's most negative finite value (a row of only padding gets a uniform
softmax, not NaN), a softmax, the weighted sum.  flax's defaults are
kept: LayerNorm epsilon 1e-6 and the tanh approximation of GELU.  The
``query``/``key``/``value``/``out`` projections are ``nn.Linear`` over the
flattened ``(heads, head_dim)`` axes of flax's ``DenseGeneral``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.models import zoo


@dataclasses.dataclass(frozen=True)
class Config:
    vocab_size: int = 30522
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn: int = 3072
    max_len: int = 512
    n_segments: int = 2
    n_classes: int = 2
    pad_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads


LN_EPS = 1e-6  # flax nn.LayerNorm's default


class SelfAttention(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        width = cfg.n_heads * cfg.head_dim
        self.query = nn.Linear(cfg.hidden, width)
        self.key = nn.Linear(cfg.hidden, width)
        self.value = nn.Linear(cfg.hidden, width)
        self.out = nn.Linear(width, cfg.hidden)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, s, _ = x.shape

        def heads(t):  # (B, S, H*D) -> (B, H, S, D)
            return t.view(b, s, c.n_heads, c.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # jnp.sqrt(head_dim).astype(x.dtype): the divisor rounded to the activation dtype
        scale = torch.tensor(math.sqrt(c.head_dim), dtype=torch.float32).to(x.dtype).item()
        scores = (q @ k.transpose(-1, -2)) / scale
        scores = scores.masked_fill(~mask[:, None, None, :], torch.finfo(x.dtype).min)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out(out.transpose(1, 2).reshape(b, s, -1))


class Layer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.ln_att = nn.LayerNorm(cfg.hidden, eps=LN_EPS)
        self.ffn_up = nn.Linear(cfg.hidden, cfg.ffn)
        self.ffn_down = nn.Linear(cfg.ffn, cfg.hidden)
        self.ln_ffn = nn.LayerNorm(cfg.hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln_att(x + self.attention(x, mask))
        h = self.ffn_down(F.gelu(self.ffn_up(x), approximate="tanh"))
        return self.ln_ffn(x + h)


class Bert(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.pos_emb = nn.Embedding(cfg.max_len, cfg.hidden)
        self.seg_emb = nn.Embedding(cfg.n_segments, cfg.hidden)
        self.ln_emb = nn.LayerNorm(cfg.hidden, eps=LN_EPS)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", Layer(cfg))
        self.pooler = nn.Linear(cfg.hidden, cfg.hidden)
        self.head = nn.Linear(cfg.hidden, cfg.n_classes)

    def check_input(self, x) -> None:
        """Token ids must index the tables (an index outside them is a
        device-side fault on the card, so it is refused on the host)."""
        c = self.cfg
        if x.ndim != 2 or not 0 < x.shape[1] <= c.max_len:
            raise ValueError(f"bert takes (batch, tokens) ids of at most {c.max_len} tokens, "
                             f"got shape {tuple(x.shape)}")
        if x.size and (x.min() < 0 or x.max() >= c.vocab_size):
            raise ValueError(f"bert token ids must lie in [0, {c.vocab_size})")

    def forward(self, token_ids: torch.Tensor,
                segment_ids: torch.Tensor | None = None) -> torch.Tensor:
        c = self.cfg
        token_ids = token_ids.long()
        mask = token_ids != c.pad_id
        pos = torch.arange(token_ids.shape[1], device=token_ids.device)
        x = self.tok_emb(token_ids) + self.pos_emb(pos)[None]
        if segment_ids is None:
            segment_ids = torch.zeros_like(token_ids)
        x = self.ln_emb(x + self.seg_emb(segment_ids))
        for i in range(c.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return torch.softmax(self.head(pooled), dim=-1)


def init_params(cfg: Config = Config(), generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None, device="cpu") -> Bert:
    return zoo.build(Bert, cfg, generator, dtype, device)


def apply(module: Bert, batch: torch.Tensor) -> torch.Tensor:
    return module(batch)
