"""Draft proposers for speculative decoding, in PyTorch.

The counterpart of the JAX package's ``executor/speculative.py``.  A
verify pass (``models/llama.py::decode_slots_spec_paged``) scores the
current token plus ``draft`` proposed ones per slot in one model call and
emits the longest agreeing prefix, so the proposers below only move the
acceptance rate, never the emitted tokens.

Everything here runs on tensors of the pool's device with shapes fixed by
the slot count and the static ``n``/``draft`` ints, so drafting needs no
host sync: ``propose_ngram`` matches the last ``n`` tokens against a
per-slot history ring, ``propose_heads`` takes the argmax of Medusa-style
head logits.

The history ring ``hist (S, H)`` stores the token at sequence position
``p`` in row ``p % H``: admission seeds it with the prompt tail
(:func:`seed_history`) plus the first sampled token, and each verify pass
scatters the tokens it emitted, so ``hist[slot, pos % H]`` is the current
token at every block boundary.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["propose_ngram", "propose_heads", "seed_history"]


def propose_ngram(hist: torch.Tensor, pos: torch.Tensor, cur: torch.Tensor, *,
                  n: int, draft: int) -> torch.Tensor:
    """Draft ``draft`` tokens per slot from the history ring.

    ``hist (S, H)`` int32 (position ``p`` at ``p % H``); ``pos (S,)`` the
    current position (``hist[pos % H]`` is ``cur (S,)``).  Each slot's most
    recent earlier occurrence of its last ``n`` tokens is found and the
    ``draft`` tokens that followed it are proposed; a slot with no match
    repeats ``cur``.  Candidate starts keep the whole ``n + draft`` window
    inside the ring and strictly before the suffix itself.  Returns
    ``(S, draft)`` in ``hist``'s dtype."""
    S, H = hist.shape
    n, draft = int(n), int(draft)
    win = n + draft
    if H <= win:
        raise ValueError(f"history {H} too small for n={n} + draft={draft}")
    C = H - win  # candidate starts per slot, c=0 the most recent
    dev = hist.device
    pos = pos.long()
    # the last n tokens (positions pos-n+1 .. pos)
    sfx_idx = (pos[:, None] + torch.arange(-n + 1, 1, device=dev)[None, :]) % H
    suffix = torch.gather(hist, 1, sfx_idx)  # (S, n)
    # start s_c matches tokens s_c..s_c+n-1 and proposes the next `draft`;
    # all win tokens must be known (<= pos) and still in the ring (> pos-H)
    cs = torch.arange(C, device=dev)
    starts = pos[:, None] - win + 1 - cs[None, :]  # (S, C)
    ok = (starts >= 0) & (starts > pos[:, None] - H)
    widx = (starts[:, :, None] + torch.arange(win, device=dev)[None, None, :]) % H
    wins = torch.gather(hist, 1, widx.reshape(S, C * win)).reshape(S, C, win)
    match = ok & (wins[:, :, :n] == suffix[:, None, :]).all(dim=-1)
    any_match = match.any(dim=1)
    # smallest c (most recent occurrence) among matches: the weights C - c
    # are distinct, so the argmax is that c (0 when nothing matched)
    best = torch.argmax(match.long() * (C - cs)[None, :], dim=1)
    cand = torch.gather(
        wins[:, :, n:], 1, best[:, None, None].expand(S, 1, draft)
    )[:, 0]  # (S, draft)
    fallback = cur[:, None].expand(S, draft)
    return torch.where(any_match[:, None], cand, fallback.to(cand.dtype)).to(hist.dtype)


def propose_heads(head_logits: torch.Tensor, *, draft: int) -> torch.Tensor:
    """Draft ``draft`` tokens per slot from Medusa-style head logits
    ``(S, K, V)`` (head ``j`` scores the token ``j + 1`` positions past the
    current one; ``draft <= K``): the greedy argmax of each head, int32."""
    return torch.argmax(head_logits[:, : int(draft), :], dim=-1).to(torch.int32)


def seed_history(prompt, hist_len: int) -> np.ndarray:
    """Host-side history-ring row for a freshly admitted prompt: the last
    ``hist_len - 1`` prompt tokens at their ``p % H`` rows (one row is left
    for the first sampled token, written at ``length % H``).  Returns
    ``(hist_len,)`` int32 numpy."""
    H = int(hist_len)
    row = np.zeros(H, np.int32)
    prompt = np.asarray(prompt, np.int32).ravel()
    lp = int(prompt.size)
    for p in range(max(0, lp - H + 1), lp):
        row[p % H] = prompt[p]
    return row
