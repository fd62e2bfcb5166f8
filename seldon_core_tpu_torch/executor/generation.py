"""Generative serving: slot-based continuous batching on PyTorch.

The plain path of the JAX package's ``executor/generation.py``:

* a paged KV pool holds ``n_slots`` independent sequences, each with its
  own position; blocks are reserved at admission for ``prompt +
  max_new_tokens`` (block 0 is the sink inactive slots write into, never
  handed out), so no request runs out of KV mid-flight;
* **admission** prefills one request's prompt into a free slot, right-
  padded to a power-of-two bucket (a multiple of the block size);
* **decode** runs ``decode_block`` steps for every slot in one call, with
  tokens, the active mask, the remaining budgets and eos kept on the
  device, and ONE host fetch per block (``decode_blocks`` and
  ``host_syncs`` count them);
* sampling happens on the device (``sample_tokens``): only token ids cross
  to the host, never logits.

``GenerationScheduler`` is the asyncio front (``submit(prompt) ->
generated ids``); ``GenerativeComponent`` adapts it to the graph-unit
contract under the ``JAX_GENERATIVE`` implementation name.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch import resolve_device
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.graph.units import GraphUnitError, SeldonComponent
from seldon_core_tpu_torch.models import llama

log = logging.getLogger(__name__)

PAD_ID = -1  # right-pad for ragged generated rows in dense responses


def _prefill_buckets(max_seq: int, smallest: int = 16) -> tuple[int, ...]:
    sizes = []
    b = smallest
    while b < max_seq:
        sizes.append(b)
        b *= 2
    sizes.append(max_seq)
    return tuple(sizes)


class OutOfKVBlocks(Exception):
    """The paged KV pool cannot reserve the blocks this request needs right
    now; the scheduler holds the request until completions free blocks."""


class QueueFull(Exception):
    """The scheduler's bounded intake is full (the engine answers 429)."""


class GenerativeModel:
    """Slot-cache generation engine for the llama family on one device.

    Calls must not interleave (they update the pool in place); an internal
    lock serializes them.  On ``cuda`` the prefill attention and the decode
    attention are the hand-written kernels: ``seq_impl`` must be
    ``"flash"`` and ``decode_kernel`` True there.
    """

    def __init__(
        self,
        cfg: llama.Config,
        params: llama.Llama,
        *,
        n_slots: int = 4,
        dtype: torch.dtype | None = None,
        seq_impl: str = "flash",
        name: str = "generative",
        decode_block: int = 16,
        kv_block_size: int = 16,
        kv_blocks: int | None = None,
        top_k: int = 0,
        decode_kernel: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if int(n_slots) < 1:
            raise GraphUnitError(f"n_slots must be >= 1, got {n_slots}")
        kv_block_size = int(kv_block_size)
        if kv_block_size < 1 or kv_block_size & (kv_block_size - 1):
            raise GraphUnitError(f"kv_block_size must be a power of two, got {kv_block_size}")
        if cfg.max_seq % kv_block_size:
            raise GraphUnitError(
                f"max_seq {cfg.max_seq} is not a multiple of kv_block_size {kv_block_size}"
            )
        if seq_impl not in ("flash", "dense"):
            raise GraphUnitError(f"seq_impl must be 'flash' or 'dense', got {seq_impl!r}")
        if self.device.type == "cuda" and (seq_impl != "flash" or not decode_kernel):
            raise GraphUnitError(
                "on cuda the prefill and decode attention are the hand-written "
                "kernels: seq_impl must be 'flash' and decode_kernel True"
            )
        self.cfg = cfg
        self.name = name
        self.n_slots = int(n_slots)
        self.seq_impl = seq_impl
        self.decode_kernel = bool(decode_kernel)
        self.decode_block = max(1, int(decode_block))
        self.top_k = int(top_k or 0)
        self.params = params.to(device=self.device, dtype=dtype) if dtype else params.to(self.device)
        self.dtype = self.params.tok_emb.dtype

        self.kv_block_size = kv_block_size
        self.max_blocks_per_slot = cfg.max_seq // kv_block_size
        if kv_blocks is None:
            kv_blocks = 1 + self.n_slots * self.max_blocks_per_slot
        self.kv_blocks = int(kv_blocks)
        if self.kv_blocks < 1 + self.max_blocks_per_slot:
            raise GraphUnitError(
                f"kv_blocks {self.kv_blocks} cannot hold even one max_seq request "
                f"(+sink); need >= {1 + self.max_blocks_per_slot}"
            )
        self._free_blocks: list[int] = list(range(1, self.kv_blocks))
        self._slot_blocks: dict[int, list[int]] = {}
        self._cache = llama.init_paged_cache(
            cfg, self.n_slots, self.kv_blocks, kv_block_size, dtype=self.dtype,
            device=self.device,
        )
        self.prefill_buckets = tuple(
            b for b in _prefill_buckets(cfg.max_seq) if b >= kv_block_size
        ) or (cfg.max_seq,)
        # host-side ceiling of every slot's device position (admission sets
        # it, each block adds k): sizes the attention window bucket
        self._pos_ceiling = np.zeros(self.n_slots, np.int64)
        self._lock = threading.RLock()
        self.prefills = 0
        self.steps = 0
        self.decode_blocks = 0
        self.host_syncs = 0  # device->host fetches made by decode blocks
        self.tokens_emitted = 0
        self.block_seconds = 0.0
        self.last_block_s = 0.0

    # ------------------------------------------------------------ helpers

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        # pageable host memory is staged at once: no wait on queued work
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, non_blocking=True)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def fit_bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise GraphUnitError(f"prompt length {n} exceeds max_seq {self.cfg.max_seq}")

    # ----------------------------------------------------------- KV blocks

    def reserve_blocks(self, slot: int, total_tokens: int) -> np.ndarray:
        """Reserve the physical blocks ``slot`` needs for a request whose
        prompt+generation will reach ``total_tokens``; returns the slot's
        zero-padded table row.  Raises :class:`OutOfKVBlocks` when the pool
        cannot cover it right now."""
        total = min(int(total_tokens), self.cfg.max_seq)
        need = -(-total // self.kv_block_size)
        self.release_slot(slot)  # a stale reservation on this slot is dead
        if len(self._free_blocks) < need:
            raise OutOfKVBlocks(f"need {need} KV blocks, {len(self._free_blocks)} free")
        got = self._free_blocks[-need:] if need else []
        if need:
            del self._free_blocks[-need:]
        self._slot_blocks[int(slot)] = got
        row = np.zeros(self.max_blocks_per_slot, np.int32)
        row[:need] = got
        return row

    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks to the pool (idempotent)."""
        with self._lock:  # the event loop releases while admissions run in a thread
            blocks = self._slot_blocks.pop(int(slot), None)
            if blocks:
                self._free_blocks.extend(blocks)

    @property
    def free_block_count(self) -> int:
        return len(self._free_blocks)

    # ----------------------------------------------------------- prefill

    def admit_dispatch(
        self, slot: int, prompt: np.ndarray, temperature: float, seed: int,
        reserve_tokens: int = 0,
    ) -> torch.Tensor:
        """Prefill ``prompt`` (1-D ids) into ``slot`` WITHOUT fetching the
        sampled token (a 0-d device tensor is returned), so several
        admissions cost one host fetch (:meth:`fetch_tokens`)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        L = int(prompt.size)
        if L < 1:
            raise GraphUnitError("empty prompt")
        bucket = self.fit_bucket(L)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :L] = prompt
        with self._lock, torch.no_grad():
            row = self.reserve_blocks(slot, L + max(0, int(reserve_tokens)))
            self._pos_ceiling[int(slot)] = L  # prefill wrote rows [0, L)
            logits, _ = llama.prefill_slot_paged(
                self.params, self._h2d(padded), L, int(slot), self._h2d(row),
                self._cache, self.cfg, seq_impl=self.seq_impl,
            )
            temp = torch.full((1,), float(temperature), device=self.device)
            tok = llama.sample_tokens(logits[None], temp, self._generator(seed), self.top_k)[0]
            self.prefills += 1
        return tok

    def fetch_tokens(self, toks: list[torch.Tensor]) -> list[int]:
        """One device->host fetch for several admissions' first tokens."""
        if not toks:
            return []
        return [int(t) for t in torch.stack(toks).cpu().tolist()]

    def admit(self, slot: int, prompt: np.ndarray, temperature: float, seed: int,
              reserve_tokens: int = 0) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled token."""
        return self.fetch_tokens(
            [self.admit_dispatch(slot, prompt, temperature, seed, reserve_tokens)]
        )[0]

    # ------------------------------------------------------------ decode

    def _window_for(self, active: np.ndarray, extra: int) -> int:
        """Smallest power-of-two window (min 64, capped at max_seq) covering
        every ACTIVE slot's position ceiling after ``extra`` more tokens."""
        act = np.asarray(active, bool)
        hi = int(self._pos_ceiling[act].max()) if act.any() else 0
        need = hi + extra + 1
        w = 64
        while w < need:
            w *= 2
        return min(w, self.cfg.max_seq)

    def _window_buckets(self) -> list[int]:
        """Every window :meth:`_window_for` can return."""
        out = []
        w = 64
        while w < self.cfg.max_seq:
            out.append(w)
            w *= 2
        out.append(self.cfg.max_seq)
        return out

    def step_k(
        self,
        tokens: np.ndarray,
        active: np.ndarray,
        temperature: np.ndarray,
        seed: int,
        eos: np.ndarray,
        remaining: np.ndarray,
        k: int,
        window: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``k`` decode steps for every slot -> ``(k, S)`` sampled tokens plus
        the ``(k, S)`` was-active-at-step mask saying which are real.
        ``eos`` is per slot (-1 = none) and ``remaining`` the per-slot token
        budget; both are enforced on the device, so a slot stops writing
        the pool the step it finishes.  One host fetch per call."""
        act_np = np.asarray(active, bool)
        k = int(k)
        window = window or self._window_for(act_np, k)
        packed = np.stack([
            np.asarray(tokens, np.int32), act_np.astype(np.int32),
            np.asarray(eos, np.int32), np.asarray(remaining, np.int32),
        ])
        with self._lock, torch.no_grad():
            t0 = time.perf_counter()
            tok, act, eos_t, rem = self._h2d(packed).unbind(0)
            act = act.bool()
            temps = self._h2d(np.asarray(temperature, np.float32))
            gen = self._generator(seed)
            toks_seq, act_seq = [], []
            for _ in range(k):
                logits, _ = llama.decode_slots_paged(
                    self.params, tok, self._cache, act, self.cfg, window=window,
                    kernel=self.decode_kernel,
                )
                new = llama.sample_tokens(logits, temps, gen, self.top_k)
                new = torch.where(act, new, tok)
                rem = torch.where(act, rem - 1, rem)
                done = (new == eos_t) | (rem <= 0)
                toks_seq.append(new)
                act_seq.append(act)
                tok, act = new, act & ~done
            # THE one host fetch of the block: tokens and mask together
            out = torch.stack([torch.stack(toks_seq), torch.stack(act_seq).to(torch.int32)])
            out = out.cpu().numpy()
            self.host_syncs += 1
            self.decode_blocks += 1
            self.steps += k
            self._pos_ceiling[act_np] += k
            self.last_block_s = time.perf_counter() - t0
            self.block_seconds += self.last_block_s
            self.tokens_emitted += int(out[1].sum())
        return out[0], out[1].astype(bool)

    # ------------------------------------------------------ warmup/reset

    def warmup(self) -> int:
        """Run every prefill bucket and one decode block per window bucket
        once (the kernel build, the allocator and cuBLAS handles are then
        off the request path).  A no-op once traffic has touched the
        cache."""
        with self._lock:
            if self.prefills or self.steps:
                return 0
            n = 0
            for b in self.prefill_buckets:
                self.admit(0, np.ones(b, np.int32), 0.0, 0)
                n += 1
            S = self.n_slots
            for w in self._window_buckets():
                self.step_k(
                    np.zeros(S, np.int32), np.zeros(S, bool), np.zeros(S, np.float32), 0,
                    np.full(S, -1, np.int32), np.zeros(S, np.int32), self.decode_block,
                    window=w,
                )
                n += 1
            self.reset()
            self.prefills = self.steps = self.decode_blocks = self.host_syncs = 0
            self.tokens_emitted, self.block_seconds = 0, 0.0
            return n

    def reset(self) -> None:
        """Zero every slot position and reclaim every reservation."""
        with self._lock:
            self._pos_ceiling[:] = 0
            for slot in list(self._slot_blocks):
                self.release_slot(slot)
            self._cache["pos"].zero_()


@dataclasses.dataclass(eq=False)  # identity eq: fields hold arrays/futures
class _Request:
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    future: asyncio.Future
    out: list[int] = dataclasses.field(default_factory=list)
    t0: float = 0.0


class GenerationScheduler:
    """Continuous-batching front: admits queued requests into free slots at
    each sync point (between decode blocks), runs blocks, delivers tokens
    and reaps finished slots.  The intake is bounded (``maxsize``,
    default 256): overflow raises :class:`QueueFull`."""

    def __init__(self, model: GenerativeModel, *, maxsize: int | None = None):
        self.model = model
        self._waiting: list[_Request] = []
        # admitted to a slot but not to the KV pool (OutOfKVBlocks): retried
        # ahead of the queue as completions free blocks
        self._overflow: list[_Request] = []
        self._maxsize = 256 if maxsize is None else int(maxsize)
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._closed = False
        self.ttft_s: collections.deque[float] = collections.deque(maxlen=4096)
        # random base so sampled streams differ across restarts; within one
        # process the sequence is deterministic
        self._seed = int.from_bytes(os.urandom(4), "little")

    def _next_seed(self) -> int:
        self._seed = (self._seed + 1) % (2**31 - 1)
        return self._seed

    def _ensure_run_task(self) -> None:
        """(Re)spawn the run loop on the CURRENT event loop, with a fresh
        wake event bound to it."""
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def submit(
        self,
        prompt: np.ndarray,
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: int | None = None,
    ) -> np.ndarray:
        """Generate up to ``max_new_tokens`` ids for a 1-D prompt."""
        if self._closed:
            raise RuntimeError("GenerationScheduler is closed")
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise GraphUnitError("empty prompt")
        vocab = self.model.cfg.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise GraphUnitError(
                f"token ids must be in [0, {vocab}); got "
                f"[{int(prompt.min())}, {int(prompt.max())}]"
            )
        if prompt.size >= self.model.cfg.max_seq:
            raise GraphUnitError(
                f"prompt length {prompt.size} must be < max_seq {self.model.cfg.max_seq}"
            )
        if max_new_tokens < 1:
            return np.zeros(0, np.int32)
        max_new_tokens = min(int(max_new_tokens), self.model.cfg.max_seq - int(prompt.size))
        depth = len(self._waiting) + len(self._overflow)
        if self._maxsize and depth >= self._maxsize:
            raise QueueFull(f"generation queue is full ({depth} waiting, cap {self._maxsize})")
        self._ensure_run_task()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        req = _Request(prompt, max_new_tokens, float(temperature), eos_id, fut,
                       t0=time.perf_counter())
        self._waiting.append(req)
        self._wake.set()
        try:
            return await fut
        except asyncio.CancelledError:
            # the client is gone: withdraw before a slot is spent (in-slot
            # requests are reaped by the run loop via the cancelled future)
            if req in self._waiting:
                self._waiting.remove(req)
            if req in self._overflow:
                self._overflow.remove(req)
            raise

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            self._wake.set()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        err = RuntimeError("GenerationScheduler closed")
        for req in self._waiting:
            if not req.future.done():
                req.future.set_exception(err)
        self._waiting.clear()

    # ---------------------------------------------------------------- loop

    def _token_done(self, req: _Request, tok: int) -> bool:
        if not req.out:
            self.ttft_s.append(time.perf_counter() - req.t0)
        req.out.append(tok)
        if req.eos_id is not None and tok == req.eos_id:
            return True
        return len(req.out) >= req.max_new_tokens

    def _finish(self, req: _Request, slot: int, slots, active) -> None:
        if not req.future.done():
            req.future.set_result(np.asarray(req.out, np.int32))
        slots[slot] = None
        active[slot] = False
        self.model.release_slot(slot)

    def _reap(self, slots, active) -> None:
        """Drop requests whose client vanished (cancelled future): from the
        queues before a prefill is spent, from slots mid-generation."""
        for q in (self._waiting, self._overflow):
            q[:] = [r for r in q if not r.future.done()]
        for i, req in enumerate(slots):
            if req is not None and req.future.done():
                slots[i] = None
                active[i] = False
                self.model.release_slot(i)

    def _deliver(self, toks_seq, act_seq, slots, cur, active) -> None:
        """Fan one fetched block's ``(k, S)`` tokens out to their requests."""
        for step_i in range(toks_seq.shape[0]):
            for i, req in enumerate(slots):
                if req is None or not act_seq[step_i, i]:
                    continue
                tok = int(toks_seq[step_i, i])
                cur[i] = tok
                if self._token_done(req, tok):
                    self._finish(req, i, slots, active)

    def _fail_inflight(self, slots, active, exc: BaseException) -> None:
        for i, req in enumerate(slots):
            if req is not None and not req.future.done():
                req.future.set_exception(exc)
            slots[i] = None
            self.model.release_slot(i)
        active[:] = False

    async def _admit_batch(self, batch, slots, cur, temps, active) -> None:
        free = [i for i in range(len(slots)) if not active[i]]

        def dispatch_and_fetch():
            placed, errors, starved = [], [], []
            for req, slot in zip(batch, free):
                try:
                    tok = self.model.admit_dispatch(
                        slot, req.prompt, req.temperature, self._next_seed(),
                        reserve_tokens=req.max_new_tokens,
                    )
                    placed.append((req, slot, tok))
                except OutOfKVBlocks:
                    starved.append(req)
                except Exception as exc:  # noqa: BLE001 - routed to the future
                    errors.append((req, exc))
            # one host fetch for every admitted first token
            toks = self.model.fetch_tokens([t for _, _, t in placed])
            return placed, toks, errors, starved

        placed, toks, errors, starved = await asyncio.to_thread(dispatch_and_fetch)
        self._overflow.extend(starved)
        for req, exc in errors:
            if not isinstance(exc, GraphUnitError):
                log.error("prefill admission failed", exc_info=exc)
            if not req.future.done():
                req.future.set_exception(exc)
        for (req, slot, _), tok in zip(placed, toks):
            slots[slot] = req
            cur[slot] = tok
            temps[slot] = req.temperature
            active[slot] = True
            if self._token_done(req, tok):
                self._finish(req, slot, slots, active)

    async def _run(self) -> None:
        S = self.model.n_slots
        slots: list[_Request | None] = [None] * S
        cur = np.zeros(S, np.int32)
        temps = np.zeros(S, np.float32)
        active = np.zeros(S, bool)
        k = self.model.decode_block
        try:
            while True:
                if self._closed:
                    raise asyncio.CancelledError
                self._reap(slots, active)
                if not active.any() and not self._waiting and not self._overflow:
                    # fully idle: park until a submit wakes us (no await
                    # between the emptiness check and clear)
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                # sync point: nothing is in flight, so admissions may prefill
                cap_free = S - int(active.sum())
                batch = []
                while self._overflow and len(batch) < cap_free:
                    batch.append(self._overflow.pop(0))
                while self._waiting and len(batch) < cap_free:
                    batch.append(self._waiting.pop(0))
                if batch:
                    await self._admit_batch(batch, slots, cur, temps, active)
                if not active.any():
                    if self._overflow:
                        # nothing in flight can free blocks: these requests
                        # exceed the pool outright
                        err = GraphUnitError(
                            "request KV reservation exceeds the configured pool "
                            f"({self.model.kv_blocks - 1} blocks of "
                            f"{self.model.kv_block_size})"
                        )
                        for req in self._overflow:
                            if not req.future.done():
                                req.future.set_exception(err)
                        self._overflow.clear()
                    continue
                eos = np.array(
                    [r.eos_id if r is not None and r.eos_id is not None else -1 for r in slots],
                    np.int32,
                )
                remaining = np.array(
                    [max(0, r.max_new_tokens - len(r.out)) if r is not None else 0
                     for r in slots],
                    np.int32,
                )
                try:
                    toks_seq, act_seq = await asyncio.to_thread(
                        self.model.step_k, cur.copy(), active.copy(), temps.copy(),
                        self._next_seed(), eos, remaining, k,
                    )
                except Exception as exc:  # noqa: BLE001 - fails the in-flight requests
                    log.error("decode block failed; failing %d requests",
                              int(active.sum()), exc_info=exc)
                    self._fail_inflight(slots, active, exc)
                    continue
                self._deliver(toks_seq, act_seq, slots, cur, active)
        except asyncio.CancelledError:
            err = RuntimeError("GenerationScheduler closed")
            for i, req in enumerate(slots):
                if req is not None and not req.future.done():
                    req.future.set_exception(err)
                self.model.release_slot(i)
            for req in self._overflow:
                if not req.future.done():
                    req.future.set_exception(err)
            self._overflow.clear()
            raise


class GenerativeComponent(SeldonComponent):
    """Graph unit serving a generative decoder.

    Wire contract (MODEL unit):

    * ``data.ndarray`` (B, L) int token ids -> (B, <=max_new) generated ids,
      rows right-padded with ``-1`` where EOS ended a row early;
    * ``strData`` JSON ``{"tokens": [[...], ...] | [...], "max_new_tokens":
      N, "temperature": t, "eos_id": e}`` -> ``strData`` JSON ``{"tokens":
      [[...], ...] | [...]}`` (a flat prompt gets a flat reply).
    """

    def __init__(
        self,
        model: GenerativeModel,
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: int | None = None,
        queue_max: int | None = None,
    ):
        self.model = model
        self.scheduler = GenerationScheduler(model, maxsize=queue_max)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        # greedy decode is a pure function of the prompt
        self.DETERMINISTIC = self.temperature == 0.0

    def warmup(self) -> int:
        return self.model.warmup()

    async def close(self) -> None:
        await self.scheduler.close()

    def metrics(self) -> list[dict[str, Any]]:
        m, n = self.model, self.model.name
        return [
            {"key": f"{n}_decode_steps", "type": "GAUGE", "value": m.steps},
            {"key": f"{n}_prefills", "type": "GAUGE", "value": m.prefills},
            {"key": f"{n}_decode_blocks", "type": "GAUGE", "value": m.decode_blocks},
            {"key": f"{n}_host_syncs", "type": "GAUGE", "value": m.host_syncs},
        ]

    async def _generate_rows(self, rows, max_new_tokens, temperature, eos_id):
        return list(await asyncio.gather(*(
            self.scheduler.submit(
                row, max_new_tokens=max_new_tokens, temperature=temperature, eos_id=eos_id,
            )
            for row in rows
        )))

    @staticmethod
    def _pad_rows(outs: list[np.ndarray]) -> np.ndarray:
        width = max((o.size for o in outs), default=0)
        dense = np.full((len(outs), width), PAD_ID, np.int32)
        for i, o in enumerate(outs):
            dense[i, : o.size] = o
        return dense

    async def predict(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X))
        if not np.issubdtype(X.dtype, np.integer):
            if not np.all(np.equal(np.mod(X, 1), 0)):
                raise GraphUnitError("generative input must be integer token ids")
            X = X.astype(np.int32)
        # rows may carry our own PAD_ID right-padding: strip it per row
        rows = []
        for row in X:
            row = np.asarray(row, np.int32)
            keep = row != PAD_ID
            rows.append(row[: int(keep.cumsum().argmax()) + 1] if keep.any() else row)
        outs = await self._generate_rows(
            rows, self.max_new_tokens, self.temperature, self.eos_id
        )
        return self._pad_rows(outs)

    async def predict_raw(self, p: Payload) -> Payload:
        if p.kind != DataKind.STRING:
            return p.with_array(await self.predict(p.array, p.names), names=[])
        try:
            body = json.loads(p.data)
            tokens = body["tokens"]
            if not isinstance(tokens, (list, tuple)):
                raise TypeError("'tokens' must be a list")
            single = bool(tokens) and not isinstance(tokens[0], (list, tuple))
            rows = [np.asarray(tokens, np.int32)] if single else [
                np.asarray(r, np.int32) for r in tokens
            ]
            max_new = int(body.get("max_new_tokens", self.max_new_tokens))
            temperature = float(body.get("temperature", self.temperature))
            eos = body.get("eos_id", self.eos_id)
            eos = int(eos) if eos is not None else None
        except (json.JSONDecodeError, TypeError, KeyError, ValueError) as e:
            raise GraphUnitError(f"bad generative request: {e}") from e
        outs = await self._generate_rows(rows, max_new, temperature, eos)
        result = [o.tolist() for o in outs]
        reply = {"tokens": result[0] if single else result}
        return Payload(json.dumps(reply), [], DataKind.STRING, p.meta)
