"""Generative serving: slot-based continuous batching on PyTorch.

The paged path of the JAX package's ``executor/generation.py``:

* a paged KV pool (float, or int8 with per-row scales:
  ``kv_cache_dtype``) holds ``n_slots`` independent sequences, each with
  its own position; blocks are reserved at admission for ``prompt +
  max_new_tokens`` (block 0 is the sink inactive slots write into, never
  handed out), so no request runs out of KV mid-flight;
* **admission** prefills one request's prompt into a free slot, right-
  padded to a power-of-two bucket (a multiple of the block size).  With
  ``prefix_reuse`` the prompt's leading full blocks already in the prefix
  index (``cache/prefix.py``) are referenced, not prefilled: only the
  suffix runs (``llama.prefill_suffix_paged``).  With ``prefill_chunk``
  a long prompt is prefilled in block-aligned chunks, every chunk after
  the first as the suffix program over the slot's own blocks; while
  decode streams are live the scheduler paces one chunk per sync point;
* **decode** runs ``decode_block`` steps for every slot in one call, with
  tokens, the active mask, the remaining budgets and eos kept on the
  device, and ONE host fetch per block (``decode_blocks`` and
  ``host_syncs`` count them).  On the card a block is ONE replay of a CUDA
  graph of its k steps, captured per ``(k, window)`` at warmup; the
  scheduler overlaps the pipeline (``overlap``): block N+1 is dispatched
  from block N's device carry before block N's tokens are fetched;
* **speculation** (``spec_draft``): each step of a block is a verify pass
  that drafts ``spec_draft`` tokens per slot (``spec_method``: ``ngram``
  from a per-slot history ring, ``heads`` from Medusa-style heads over the
  last verified hidden, ``draft`` from a co-resident draft model over its
  own paged KV), scores ``1 + spec_draft`` positions in one model call and
  emits the longest agreeing prefix; greedy output equals speculation off;
* sampling happens on the device (``sample_tokens``): only token ids cross
  to the host, never logits;
* **handoff between engines**: a prefill engine exports a pinned slot's
  prompt blocks (``export_slot_kv``) and a decode engine imports them
  (``attach_imported``, longest-prefix reuse applied), each with one
  host<->device copy; **prefix tiers**: with ``prefix_dram_gb`` an index
  eviction demotes its blocks into host DRAM (``cache/tiers.py``) and a
  later match promotes them back, and a peer's chain is exported
  (``export_prefix_kv``) and installed (``install_prefix_chain``).  All
  of it runs at sync points, never inside a decode block;
* **the cascade's confidence signal** (``conf_signal``): every decode step
  and verify pass also computes the top-2 margin of the f32 logits that
  sampling reads, inside the captured block, and the margins ride the
  block's one fetch; the scheduler averages them per request over its
  decode tokens (``info["confidence"]``);
* **embeddings** (``embed``): a prompt's mean-pooled final hidden state
  (``llama.embed_pooled``) with no KV written and no slot taken; the
  scheduler serves the waiting prompts as one wave at a sync point, with
  one host fetch for the wave;
* **batched multi-LoRA** (``lora_rank``, ``lora_slots``, ``lora_targets``,
  ``lora_adapters``): one stacked adapter pool on the device, each slot
  bound to a named adapter's row (``executor/lora.py``) for its request's
  lifetime; the per-slot ids are a static buffer of the decode blocks and
  each prefill, chunk, decode step and verify pass gathers its rows' deltas
  inside the same call.  Registering an adapter writes its row in place
  between blocks, so no graph is captured again.  Prefix chains are salted
  per adapter;
* **the memory ledgers** (``executor/memory.py``): every model reserves its
  byte classes (weights, KV pool and scales, adapter pool, speculation
  state) on its card's ledger at build, and its host-DRAM classes (the
  prefix tier's and the suspend store's bytes) on the host ledger;
* **chip packing and live drain**: co-resident deployments time-share one
  card under a device arbiter (``executor/arbiter.py``); a preempted or
  drained scheduler exports its live slots as handoff frames into a
  host-DRAM suspend store (``cache/tiers.py``) at a sync point and frees
  their blocks, and resumes them through the import path, bit-exactly,
  here or on a peer;
* **telemetry**: at the one fetch of each block the model counts a host
  sync (``obs/probes.py``), observes the device step and sets the MFU
  gauge (about 2 x params FLOPs a token over the block's CUDA-event
  seconds and the card's peak, ``utils/roofline.py``); the scheduler
  writes each request's lifecycle timeline (``obs/timeline.py``: queued,
  admit with the reservation's reuse depth, chunks, blocks with
  speculation's split, overlap breaks, preempt/suspend/resume, the
  terminal reason and what the request spent) and feeds the TTFT,
  inter-token and token families, all from values the host holds.

``GenerationScheduler`` is the asyncio front (``submit(prompt) ->
generated ids``, with an ``on_token`` hook per delivered token);
``GenerativeComponent`` adapts it to the graph-unit contract under the
``JAX_GENERATIVE`` implementation name and streams tokens
(:meth:`GenerativeComponent.stream`).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
import weakref
import zlib
from typing import Any, AsyncIterator, Callable

import numpy as np
import torch

from seldon_core_tpu_torch import capture_section, qos, resolve_device
from seldon_core_tpu_torch.cache.prefix import PrefixIndex
from seldon_core_tpu_torch.cache.tiers import HostPrefixStore, SuspendStore
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.cache.prefix import adapter_salt
from seldon_core_tpu_torch.executor.lora import AdapterPool, UnknownAdapter
from seldon_core_tpu_torch.executor.memory import (
    MemoryManager,
    device_memory,
    hbm_budget_bytes,
    host_memory,
    suspend_budget_bytes,
)
from seldon_core_tpu_torch.executor.speculative import propose_heads, propose_ngram, seed_history
from seldon_core_tpu_torch.graph.units import GraphUnitError, SeldonComponent
from seldon_core_tpu_torch.models import llama
from seldon_core_tpu_torch.models.registry import resolve_config
from seldon_core_tpu_torch.models.weights import init_params, medusa_heads_from_jax
from seldon_core_tpu_torch.obs.metering import METER
from seldon_core_tpu_torch.obs.probes import record_host_sync
from seldon_core_tpu_torch.obs.spans import (
    RECORDER,
    STAGE_DEVICE_STEP,
    STAGE_QUEUE_WAIT,
    STAGE_TTFT,
    current_span,
    current_trace_id,
    make_trace_id,
)
from seldon_core_tpu_torch.obs.timeline import (
    EVENT_PREEMPT,
    EVENT_RESUME,
    EVENT_SUSPEND,
    TIMELINE,
)
from seldon_core_tpu_torch.ops import _build, paged_attention
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS
from seldon_core_tpu_torch.utils.metrics import observe_exemplar
from seldon_core_tpu_torch.utils.roofline import chip_peak_flops
from seldon_core_tpu_torch.qos.admission import DeadlineExceeded, QueueFull

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


def _conf_margin(logits: torch.Tensor) -> torch.Tensor:
    """The top-2 margin of the f32 logits sampling reads, per row: equal to
    the top-2 log-probability margin (softmax is shift-invariant), so a
    threshold written in log-probability space applies directly."""
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


class OutOfKVBlocks(Exception):
    """The paged KV pool cannot reserve the blocks this request needs right
    now; the scheduler holds the request until completions free blocks."""


class AdapterUnavailable(GraphUnitError):
    """A request names a LoRA adapter its unit cannot serve: not resident,
    or the unit was built without multi-LoRA (the engine answers 400)."""


class GenerativeModel:
    """Slot-cache generation engine for the llama family on one device.

    Calls must not interleave (they update the pool in place); an internal
    lock serializes them, the prefix index's bookkeeping included.  On
    ``cuda`` the prefill attention and the decode attention are the
    hand-written kernels: ``seq_impl`` must be ``"flash"`` and
    ``decode_kernel`` True there.

    ``kv_cache_dtype`` (``"int8"`` or unset; env ``SCT_KV_DTYPE``),
    ``prefill_chunk`` (tokens, rounded up to a block multiple; env
    ``SCT_PREFILL_CHUNK``) and ``prefix_reuse`` (env ``SCT_CACHE_PREFIX=1``)
    are normalized as the JAX package does, and so is ``prefix_dram_gb``
    (env ``SCT_PREFIX_DRAM_GB``; with prefix reuse on, index evictions are
    kept in a host-DRAM store of that many GiB and promoted back on a
    match), and so are the speculation
    parameters: ``spec_draft`` (env ``SCT_SPEC_DRAFT``; 0 is off),
    ``spec_ngram`` (``SCT_SPEC_NGRAM``, default 3), ``spec_hist``,
    ``spec_method`` (``SCT_SPEC_METHOD``, default ``ngram``), ``spec_heads``
    (``SCT_SPEC_HEADS``), ``spec_heads_path`` (``SCT_SPEC_HEADS_PATH``: an
    npz of trained heads, read for ``heads`` only) and
    ``spec_draft_model`` (``SCT_SPEC_DRAFT_MODEL``: ``truncate:N``,
    ``truncate:auto`` or ``preset:NAME``).  ``medusa_heads`` (or the file
    of ``spec_heads_path``) carries a head block (``{"w1", "head"}``) in
    place of the heads made from the model's ``lm_head``; ``draft_params`` carries the weights of a
    ``preset:`` draft model in place of seeded ones.  ``conf_signal`` (env
    ``SCT_CASCADE_CONF_SIGNAL=1``) computes the top-2 logit margin of each
    step inside the decode blocks and stashes a fetched block's margins in
    :attr:`last_conf_seq`; a graph with it and one without are two cache
    entries.  ``embed`` (env ``SCT_EMBED=1``) warms the pooled-embedding
    path at every prefill bucket (:meth:`embed_dispatch` serves whether or
    not it is set).  ``lora_rank`` (env ``SCT_LORA_RANK``; 0 is off),
    ``lora_slots`` (``SCT_LORA_SLOTS``, default 8 pool rows, row 0 the null
    adapter), ``lora_targets`` (``SCT_LORA_TARGETS``: ``qkvo`` or
    ``qkvo+mlp``) and ``lora_adapters`` (``SCT_LORA_ADAPTERS``: ``name`` or
    ``name:seed``, comma-separated, registered at build) turn on batched
    multi-LoRA; ``memory`` is the ledger the model reserves its bytes on
    (default: the process's ledger of its device).

    On ``cuda`` a decode block is one replay of a CUDA graph of its ``k``
    steps (plain steps, or verify passes with the proposer), one graph per
    ``(k, window)`` and the static configuration, captured at
    :meth:`warmup` for every window bucket (``program_compiles`` counts
    captures, ``program_hits`` replays of a cached graph).  Every graph
    reads its inputs from the same static buffers and writes its tokens,
    mask and final carry into the same static outputs, so a block may
    continue from the previous block's carry under another window
    (:meth:`step_k_continue`).  On the CPU the same body runs eagerly.
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
        kv_cache_dtype: str | None = None,
        prefill_chunk: int | None = None,
        prefix_reuse: bool | None = None,
        prefix_dram_gb: float | None = None,
        spec_draft: int | None = None,
        spec_ngram: int | None = None,
        spec_hist: int = 64,
        spec_method: str | None = None,
        spec_heads: int | None = None,
        spec_heads_path: str | None = None,
        spec_draft_model: str | None = None,
        medusa_heads: dict | None = None,
        draft_params: llama.Llama | None = None,
        conf_signal: bool | None = None,
        embed: bool | None = None,
        lora_rank: int | None = None,
        lora_slots: int | None = None,
        lora_targets: str | None = None,
        lora_adapters: Any = None,
        memory: MemoryManager | None = None,
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
        self._mem_key = f"{name}:{id(self):x}"  # this model's rows in the ledgers
        self.n_slots = int(n_slots)
        self.seq_impl = seq_impl
        self.decode_kernel = bool(decode_kernel)
        self.decode_block = max(1, int(decode_block))
        self.top_k = int(top_k or 0)
        self.params = params.to(device=self.device, dtype=dtype) if dtype else params.to(self.device)
        self.dtype = self.params.tok_emb.dtype
        if kv_cache_dtype is None:
            kv_cache_dtype = os.environ.get("SCT_KV_DTYPE") or None
        if kv_cache_dtype in ("", "auto", "bf16", "bfloat16", "float32", "fp32"):
            kv_cache_dtype = None  # the pool's float dtype: the default layout
        if kv_cache_dtype not in (None, "int8"):
            raise GraphUnitError(f"kv_cache_dtype must be 'int8' or unset, got {kv_cache_dtype!r}")
        self.kv_dtype: str | None = kv_cache_dtype
        if prefill_chunk is None:
            prefill_chunk = int(os.environ.get("SCT_PREFILL_CHUNK", "0") or 0)
        prefill_chunk = max(0, int(prefill_chunk))
        if prefill_chunk:
            prefill_chunk = min(-(-prefill_chunk // kv_block_size) * kv_block_size, cfg.max_seq)
        self.prefill_chunk = prefill_chunk
        if prefix_reuse is None:
            prefix_reuse = os.environ.get("SCT_CACHE_PREFIX", "0") == "1"
        self._spec_config(spec_draft, spec_ngram, spec_hist, spec_method, spec_heads,
                          spec_draft_model, spec_heads_path)
        self._lora_config(lora_rank, lora_slots, lora_targets)
        if conf_signal is None:
            conf_signal = os.environ.get("SCT_CASCADE_CONF_SIGNAL", "0") == "1"
        self.conf_signal = bool(conf_signal)
        # the last fetched block's (rows, S) f32 margins, None without the
        # signal; the scheduler reads it right after the fetch
        self.last_conf_seq: np.ndarray | None = None
        if embed is None:
            embed = os.environ.get("SCT_EMBED", "0") == "1"
        self.embed_enabled = bool(embed)

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
        self._slot_blocks: dict[int, list[int]] = {}  # owned blocks per slot
        # KV prefix reuse: a radix index over token-id prefixes -> ref-
        # counted blocks of this pool; per slot, the prompt (inserted at
        # release) and how many leading blocks were matched (shared refs);
        # only slots whose prompt prefill completed may give blocks to the
        # index: a cancelled or failed one holds blocks nobody wrote
        self.prefix_index = PrefixIndex(kv_block_size) if prefix_reuse else None
        self._slot_prompt: dict[int, np.ndarray] = {}
        self._slot_matched: dict[int, int] = {}
        # (prefix tokens spared, tier) per reservation, for the usage meter
        self._slot_saved: dict[int, tuple[int, str]] = {}
        self._slot_promoted: dict[int, int] = {}
        self._slot_filled: set[int] = set()
        self._slot_row: dict[int, np.ndarray] = {}  # the reservation's table row
        # the host-DRAM tier under the index (cache/tiers.py): evicted
        # chain levels are kept there and promoted back on a match
        if prefix_dram_gb is not None and float(prefix_dram_gb) > 0 and not prefix_reuse:
            raise GraphUnitError("prefix_dram_gb keeps evicted prefix blocks: it needs "
                                 "kv_prefix_reuse on")
        if prefix_dram_gb is None:
            prefix_dram_gb = float(os.environ.get("SCT_PREFIX_DRAM_GB", "0") or 0)
        self._dram_bytes = int(float(prefix_dram_gb) * (1 << 30)) if prefix_reuse else 0
        # this model's host-DRAM byte classes (prefix tier, suspend store):
        # its row in the host ledger, re-reserved whole on every change
        self._host_classes: dict[str, int] = {}
        self.host_store = (HostPrefixStore(kv_block_size, self._dram_bytes,
                                           on_bytes=self._note_dram_bytes)
                           if self._dram_bytes > 0 else None)
        # chain levels a peer pull installed that no admission has used yet
        self._peer_chains: set = set()
        self._cache = llama.init_paged_cache(
            cfg, self.n_slots, self.kv_blocks, kv_block_size, dtype=self.dtype,
            device=self.device, kv_dtype=self.kv_dtype,
        )
        self.prefill_buckets = tuple(
            b for b in _prefill_buckets(cfg.max_seq) if b >= kv_block_size
        ) or (cfg.max_seq,)
        self._spec_state(medusa_heads, draft_params)
        self._lora_state()
        # host-side ceiling of every slot's device position (admission sets
        # it, each block adds k): sizes the attention window bucket
        self._pos_ceiling = np.zeros(self.n_slots, np.int64)
        self._lock = threading.RLock()
        # the decode blocks: one sampler, reseeded per block (a graph
        # replays its draws from it), the static buffers every graph
        # reads and writes, and the graph cache keyed as the JAX package
        # keys its block programs
        self._gen = torch.Generator(device=self.device)
        self._block_buffers()
        # the LoRA geometry sits just before the signal: a graph with
        # adapters and one without are two cache entries
        self._program_config = (self.spec_method, self.spec_draft, self.spec_ngram,
                                self.spec_hist, self.top_k, self.kv_dtype,
                                tuple(sorted(self._row_split)), self.lora_rank,
                                self.lora_slots, self.lora_targets, self.conf_signal)
        self._graphs: dict[tuple, dict] = {}
        self._graph_pool = None
        self._capture_stream: torch.cuda.Stream | None = None
        self.program_compiles = 0  # graphs captured
        self.program_hits = 0  # blocks that replayed a cached graph
        self.overlapped = 0  # blocks dispatched from the previous block's carry
        # the eager k-step loop on the card: a yardstick for "replay ==
        # eager" (chip_smoke.py), never a serving path
        self._eager_on_card = False
        # the ops a prefill runs in fixed row tiles, so that suffix
        # prefills and chunks write the K/V a cold prefill writes
        self._prefill_split = (llama.prefill_variant_ops(cfg, self.prefill_buckets, self.dtype,
                                                         self.device, lora=self._lora_geom)
                               if self.device.type == "cuda" else frozenset())
        self._prefill_op = (llama.row_tiled_op(self._prefill_split, llama.PREFILL_ROW_TILE)
                            if self._prefill_split else llama._plain)
        self.prefills = 0
        self.prefills_reused = 0  # admissions that skipped a reused prefix
        self.prefill_chunks = 0  # chunked-prefill chunk dispatches
        self.steps = 0
        self.decode_blocks = 0
        self.host_syncs = 0  # device->host fetches made by decode blocks
        self.tokens_emitted = 0
        self.block_seconds = 0.0
        self.last_block_s = 0.0
        # the acceptance ledger: tokens emitted over productive (pass, slot)
        # pairs, i.e. passes in which the slot emitted at least one token
        self.spec_emitted_tokens = 0
        self.spec_verify_passes = 0
        # deferred draft-model prefills (spec_method='draft' on a packed
        # card): queued at admission, drained at the scheduler's sync points
        self._pending_draft_prefill: list[dict] = []
        self.defer_draft_prefill = False
        self.draft_prefills = 0  # draft-pool prompt prefills dispatched
        self.embeds = 0  # pooled-embedding forwards dispatched
        self.embed_fetches = 0  # device->host fetches made by embed waves
        self._zero_tier_counters()
        self._reserve_memory(memory)
        self._register_declared(lora_adapters)
        # the metric sinks, fed at the host's sync points only (never inside
        # a captured graph: a capture runs host code once, a replay never).
        # Decode FLOPs are about 2 x params a token; the MFU gauge divides
        # them by the block's measured seconds and the card's peak (none off
        # a known card: the gauge then stays unset)
        self.flops_per_token = 2.0 * sum(p.numel() for p in self.params.parameters())
        self._peak_flops = chip_peak_flops(self.device)
        self._m_device_step = DEFAULT_METRICS.device_step.labels(name)
        self._m_mfu = DEFAULT_METRICS.mfu.labels(name)
        self._m_itl = DEFAULT_METRICS.itl.labels(name)
        self._blocks_high_water = 0
        self._in_warmup = False
        DEFAULT_METRICS.kv_slots_per_chip.labels(name).set(
            self.kv_slots_per_chip(hbm_budget_bytes(self.device)))

    def _zero_tier_counters(self) -> None:
        self.imports = 0  # handoffs imported into this pool
        self.dram_hits = 0  # admissions that promoted >= 1 level from DRAM
        self.peer_hits = 0  # admissions whose prefix a peer pull installed
        self.peer_installs = 0  # chain levels installed from peer pulls
        self.peer_serves = 0  # chains exported to pulling peers

    # -------------------------------------------------------- speculation

    def _spec_config(self, spec_draft, spec_ngram, spec_hist, spec_method, spec_heads,
                     spec_draft_model, spec_heads_path) -> None:
        """The speculation parameters, their env fallbacks and checks."""
        if spec_draft is None:
            spec_draft = int(os.environ.get("SCT_SPEC_DRAFT", "0") or 0)
        if spec_ngram is None:
            spec_ngram = int(os.environ.get("SCT_SPEC_NGRAM", "3") or 3)
        self.spec_draft = max(0, int(spec_draft))
        self.spec_ngram = max(1, int(spec_ngram))
        self.spec_hist = max(8, int(spec_hist))
        if self.spec_draft and self.decode_block <= 1:
            # the draft/verify/accept loop runs inside the k-step block;
            # dropping speculation quietly would bill every token in full
            raise GraphUnitError(
                f"generative model {self.name!r}: spec_draft={self.spec_draft} requires "
                f"decode_block > 1, got decode_block={self.decode_block}: the "
                "draft/verify/accept loop runs inside the k-step decode block.  Raise "
                "decode_block or unset spec_draft (graph param or SCT_SPEC_DRAFT)."
            )
        if spec_method is None:
            spec_method = os.environ.get("SCT_SPEC_METHOD", "") or "ngram"
        spec_method = str(spec_method).lower()
        if spec_method not in ("ngram", "heads", "draft"):
            raise GraphUnitError(
                f"spec_method must be 'ngram', 'heads', or 'draft', got {spec_method!r}"
            )
        self.spec_method = spec_method if self.spec_draft else None
        if spec_heads is None:
            spec_heads = int(os.environ.get("SCT_SPEC_HEADS", "0") or 0)
        if spec_draft_model is None:
            spec_draft_model = os.environ.get("SCT_SPEC_DRAFT_MODEL") or None
        if spec_heads_path and self.spec_method != "heads":
            # the JAX package reads it for 'heads' only; the port ignores
            # no parameter (the env default below stays harmless)
            raise GraphUnitError(
                f"spec_heads_path={spec_heads_path!r} needs spec_method='heads' with "
                f"spec_draft > 0, got spec_method={self.spec_method!r}"
            )
        if spec_heads_path is None:
            spec_heads_path = os.environ.get("SCT_SPEC_HEADS_PATH") or None
        self.spec_heads = 0
        self.spec_heads_path: str | None = None
        self._draft_geom: tuple | None = None
        if self.spec_draft:
            if self.spec_hist <= self.spec_ngram + self.spec_draft:
                raise GraphUnitError(
                    f"spec_hist {self.spec_hist} must exceed spec_ngram "
                    f"{self.spec_ngram} + spec_draft {self.spec_draft}"
                )
            if self.spec_method == "heads":
                self.spec_heads = max(self.spec_draft, int(spec_heads or 0))
                self.spec_heads_path = spec_heads_path
            elif self.spec_method == "draft":
                self._draft_geom = self._parse_draft_model(spec_draft_model)
        # tokens a slot can emit per step of a block (the verify width)
        self._tps = 1 + self.spec_draft

    def _parse_draft_model(self, spec: str | None) -> tuple:
        """``spec_draft_model`` -> ``("truncate", N)`` (the model's own first
        N layers; ``auto`` is ``max(1, n_layers // 8)``) or ``("preset",
        NAME)`` (a separate preset of the family, at this model's
        max_seq)."""
        spec = str(spec or "truncate:auto").strip()
        kind, _, arg = spec.partition(":")
        kind = kind.lower()
        if kind == "truncate":
            arg = (arg or "auto").strip().lower()
            if arg == "auto":
                n = max(1, int(self.cfg.n_layers) // 8)
            else:
                try:
                    n = int(arg)
                except ValueError:
                    raise GraphUnitError(
                        f"generative model {self.name!r}: bad truncate layer count in "
                        f"spec_draft_model={spec!r}"
                    ) from None
            if not 1 <= n < int(self.cfg.n_layers):
                raise GraphUnitError(
                    f"generative model {self.name!r}: truncate:{n} must keep "
                    f"1 <= N < n_layers ({self.cfg.n_layers})"
                )
            return ("truncate", n)
        if kind == "preset" and arg.strip():
            return ("preset", arg.strip())
        raise GraphUnitError(
            f"generative model {self.name!r}: spec_draft_model must be 'truncate:N', "
            f"'truncate:auto', or 'preset:NAME', got {spec!r}"
        )

    def _spec_state(self, medusa_heads: dict | None, draft_params) -> None:
        """The proposers' device state: the history ring ``(S, spec_hist)``;
        for ``heads`` the head block and the last verified hidden ``(S, E)``
        per slot; for ``draft`` the draft model and its own paged pool, in
        which slot ``i`` statically owns blocks ``[1 + i*mb, 1 + (i+1)*mb)``
        (block 0 the sink), so no draft block is ever allocated or freed."""
        S, dev, cfg = self.n_slots, self.device, self.cfg
        self.spec_heads_bytes = self.draft_weight_bytes = self.draft_kv_bytes = 0
        self._hist = self._hlast = self._heads = None
        self._draft_params = self._draft_cfg = self._draft_cache = None
        self._row_split = frozenset()
        preset_draft = self._draft_geom is not None and self._draft_geom[0] == "preset"
        if ((medusa_heads is not None and self.spec_method != "heads")
                or (draft_params is not None and not preset_draft)):
            raise GraphUnitError(
                "medusa_heads needs spec_method='heads' and draft_params a "
                "spec_draft_model='preset:NAME'"
            )
        if medusa_heads is not None and self.spec_heads_path:
            raise GraphUnitError("medusa_heads and spec_heads_path both name the heads")
        if not self.spec_draft:
            return
        if self.spec_heads_path:
            medusa_heads = self._load_heads(self.spec_heads_path)
        # the ops whose rows this device rounds otherwise at S * (1 + d)
        # rows than at S: the verify pass runs them per query position
        self._row_split = llama.row_variant_ops(cfg, S, self._tps, self.dtype, dev,
                                                lora=self._lora_geom)
        self._hist = torch.zeros(S, self.spec_hist, dtype=torch.int32, device=dev)
        if self.spec_method == "heads":
            if medusa_heads is None:
                # synthesized from the lm_head: untrained heads draft "repeat
                # the argmax", harmless since the verify pass emits the
                # model's own tokens
                medusa_heads = llama.init_medusa_heads(
                    torch.Generator(device=dev).manual_seed(0), cfg, self.spec_heads,
                    base_head=self.params.head, dtype=self.dtype, device=dev,
                )
            w1, head = medusa_heads.get("w1"), medusa_heads.get("head")
            if (w1 is None or head is None or w1.shape[0] != head.shape[0]
                    or w1.shape[0] < self.spec_draft
                    or tuple(w1.shape[1:]) != (cfg.hidden, cfg.hidden)
                    or tuple(head.shape[1:]) != (cfg.hidden, cfg.vocab_size)):
                raise GraphUnitError(
                    f"Medusa heads must be w1 (K, E, E) and head (K, E, V) with "
                    f"K >= spec_draft={self.spec_draft}, E={cfg.hidden}, V={cfg.vocab_size}"
                )
            self._heads = {"w1": w1.to(device=dev, dtype=self.dtype),
                           "head": head.to(device=dev, dtype=self.dtype)}
            self.spec_heads = int(w1.shape[0])
            self.spec_heads_bytes = sum(t.nbytes for t in self._heads.values())
            self._hlast = torch.zeros(S, cfg.hidden, dtype=self.dtype, device=dev)
        elif self.spec_method == "draft":
            kind, geo = self._draft_geom
            if kind == "truncate":
                dparams = llama.truncate_params(self.params, geo)
                self.draft_weight_bytes = sum(t.nbytes for t in dparams.layers.values())
            else:
                try:
                    dcfg = resolve_config(geo, max_seq=cfg.max_seq)
                except KeyError as e:
                    raise GraphUnitError(str(e)) from None
                if dcfg.vocab_size != cfg.vocab_size:
                    raise GraphUnitError(
                        f"generative model {self.name!r}: draft preset {geo!r} vocab "
                        f"{dcfg.vocab_size} != target vocab {cfg.vocab_size}"
                    )
                if draft_params is None:
                    dparams = init_params(dcfg, torch.Generator(device=dev).manual_seed(0),
                                          dtype=self.dtype, device=dev)
                elif draft_params.cfg != dcfg:
                    raise GraphUnitError(f"draft_params are not preset {geo!r}: {draft_params.cfg}")
                else:
                    dparams = draft_params.to(device=dev, dtype=self.dtype)
                self.draft_weight_bytes = sum(p.nbytes for p in dparams.parameters())
            self._draft_params, self._draft_cfg = dparams, dparams.cfg
            mbd = self._draft_cfg.max_seq // self.kv_block_size
            self._draft_cache = llama.init_paged_cache(
                self._draft_cfg, S, 1 + S * mbd, self.kv_block_size, dtype=self.dtype, device=dev,
            )
            self._draft_cache["table"].copy_(
                1 + torch.arange(S * mbd, dtype=torch.int32, device=dev).reshape(S, mbd))
            self.draft_kv_bytes = self._draft_cache["k"].nbytes + self._draft_cache["v"].nbytes

    def _load_heads(self, path: str) -> dict:
        """Trained Medusa heads from an npz of ``executor/checkpoint.py``
        (either package's): ``w1 (K, E, E)`` and ``head (K, E, V)`` with
        ``K >= spec_draft`` and ``V == vocab``, in the cache dtype on the
        model's device (bf16 carried bit for bit)."""
        from seldon_core_tpu_torch.executor.checkpoint import load_params

        def refuse(why: str = "") -> GraphUnitError:
            return GraphUnitError(
                f"generative model {self.name!r}: Medusa checkpoint {path!r} must hold "
                f"w1 (K, E, E) + head (K, E, V) with K >= spec_draft={self.spec_draft} "
                f"and V == {self.cfg.vocab_size}{why}"
            )

        try:
            heads = load_params(path)
        except (OSError, ValueError, KeyError) as e:
            raise refuse(f"; spec_heads_path cannot be read: {e}") from e
        w1 = heads.get("w1") if isinstance(heads, dict) else None
        hd = heads.get("head") if isinstance(heads, dict) else None
        E = self.cfg.hidden
        if (w1 is None or hd is None or np.shape(w1)[:1] != np.shape(hd)[:1]
                or np.shape(w1)[0] < self.spec_draft
                or np.shape(hd)[-1] != self.cfg.vocab_size
                or tuple(np.shape(w1)[1:]) != (E, E) or tuple(np.shape(hd)[1:-1]) != (E,)):
            raise refuse(f" (E={E})")
        try:
            return medusa_heads_from_jax({"w1": w1, "head": hd}, dtype=self.dtype,
                                         device=self.device)
        except (ValueError, TypeError) as e:
            raise refuse(f": {e}") from e

    def _with_hist(self, payload: dict, prompt: np.ndarray) -> dict:
        """Add the history-ring seed of ``prompt`` (the tokens the prefill
        leaves in the pool) to a prefill payload when speculation is on."""
        if self.spec_draft:
            payload["hist_seed"] = seed_history(prompt, self.spec_hist)
        return payload

    def _prompt_landed(self, payload: dict, tok: torch.Tensor, hidden) -> None:
        """A prefill's speculation state, on the device: the slot's history
        ring (the seed plus the sampled token at ``length % spec_hist``)
        and, for ``heads``, the hidden the first drafts come from."""
        if not self.spec_draft:
            return
        slot = payload["slot"]
        self._hist[slot] = self._h2d(payload["hist_seed"])
        self._hist[slot, int(payload["length"]) % self.spec_hist] = tok
        if hidden is not None:
            self._hlast[slot] = hidden.to(self._hlast.dtype)

    def draft_prefill_dispatch(self, slot: int, prompt: np.ndarray) -> None:
        """Prefill the draft model's pool for ``slot`` with the WHOLE prompt
        (``spec_method='draft'``; a reused prefix or a chunk plan prefills
        it whole too).  Nothing is sampled or fetched.  A no-op for the
        other methods.  Batch-class work: with :attr:`defer_draft_prefill`
        set (the scheduler joined an arbiter) it is queued instead, outside
        warmup, and runs at the scheduler's next sync point
        (:meth:`drain_draft_prefills`) under the draft registrant's grant.
        A late draft prefill costs acceptance only: the verify pass emits
        the model's own tokens, and the draft position re-syncs every
        pass."""
        if self._draft_params is None:
            return
        prompt = np.asarray(prompt, np.int32).ravel()
        payload = {"prompt": prompt, "slot": int(slot)}
        if self.defer_draft_prefill and not self._in_warmup:
            with self._lock:
                self._pending_draft_prefill.append(payload)
            return
        self._exec_draft_prefill(payload)

    def drain_draft_prefills(self) -> int:
        """Run the deferred draft-model prefills, oldest first; returns how
        many ran."""
        n = 0
        while True:
            with self._lock:
                if not self._pending_draft_prefill:
                    return n
                payload = self._pending_draft_prefill.pop(0)
            self._exec_draft_prefill(payload)
            n += 1

    def _exec_draft_prefill(self, payload: dict) -> None:
        """One draft-pool prefill: dispatch only, nothing fetched, so the
        one-host-sync-a-block audit is untouched."""
        prompt, slot = payload["prompt"], payload["slot"]
        dc = self._draft_cache
        with self._lock, torch.no_grad():
            llama.prefill_slot_paged(
                self._draft_params, self._h2d(self._padded(prompt)), prompt.size, slot,
                dc["table"][slot].clone(), dc, self._draft_cfg, seq_impl=self.seq_impl,
            )
            self.draft_prefills += 1

    def _drafts(self, tok, act, window: int) -> torch.Tensor:
        """``(S, spec_draft)`` proposals for the current tokens ``tok``."""
        d = self.spec_draft
        if self.spec_method == "heads":
            return propose_heads(llama.apply_medusa_heads(self._heads, self._hlast), draft=d)
        if self.spec_method == "draft":
            # greedy unroll of the draft model over its own pool: each step
            # writes the row it consumed, so rows below the draft position
            # hold the accepted sequence once the pass re-syncs it to pos
            cur, out = tok, []
            for _ in range(d):
                dlogits, _ = llama.decode_slots_paged(
                    self._draft_params, cur, self._draft_cache, act, self._draft_cfg,
                    window=window, kernel=self.decode_kernel,
                )
                cur = torch.argmax(dlogits, dim=-1).to(torch.int32)
                out.append(cur)
            return torch.stack(out, dim=1)
        return propose_ngram(self._hist, self._cache["pos"], tok, n=self.spec_ngram, draft=d)

    def _verify_pass(self, tok, act, rem, temps, gen, eos_t, window: int):
        """One speculative step of a block: draft, score ``L = 1 +
        spec_draft`` positions per slot in one model call, accept the
        longest prefix where the drafts agree with the sampled tokens (cut
        after an eos), advance ``pos`` and the history ring by the tokens
        emitted.  Returns ``(out (S, L), emitted (S, L), tok, act, rem,
        margin)``, all on the device; ``margin (S, L)`` is each position's
        top-2 logit margin with ``conf_signal`` on, else None."""
        S, L = self.n_slots, self._tps
        cache = self._cache
        pos = cache["pos"]
        offs = torch.arange(L, device=self.device)[None, :]
        heads = self.spec_method == "heads"
        drafts = self._drafts(tok, act, window)
        qtoks = torch.cat([tok[:, None], drafts.to(tok.dtype)], dim=1)
        # draft positions at or past the remaining budget write the sink
        qvalid = act[:, None] & (offs < rem[:, None])
        res = llama.decode_slots_spec_paged(
            self.params, qtoks, cache, act, qvalid, self.cfg, window=window,
            kernel=self.decode_kernel, return_hidden=heads, row_split=self._row_split,
            lora=self._lora, adapter_ids=self._gaid,
        )
        logits = res[0]
        out = llama.sample_tokens(
            logits.reshape(S * L, logits.shape[-1]), temps.repeat_interleave(L), gen, self.top_k,
        ).reshape(S, L)
        margin = _conf_margin(logits) if self.conf_signal else None
        agree = (drafts == out[:, :-1]).to(torch.int32)
        n_acc = torch.cumprod(agree, dim=1).sum(dim=1)
        base = qvalid & (offs <= n_acc[:, None])
        eos_here = base & (eos_t[:, None] >= 0) & (out == eos_t[:, None])
        eh = eos_here.to(torch.int32)
        emitted = base & ((torch.cumsum(eh, dim=1) - eh) == 0)
        n_em = emitted.sum(dim=1).to(torch.int32)
        last = torch.clamp(n_em - 1, min=0).long()
        new_cur = torch.gather(out, 1, last[:, None])[:, 0]
        tok = torch.where(act, new_cur, tok)
        rem = torch.where(act, rem - n_em, rem)
        act2 = act & ~eos_here.any(dim=1) & (rem > 0)
        # the emitted tokens go into the ring at positions pos+1 .. pos+n_em
        widx = (pos.long()[:, None] + 1 + offs) % self.spec_hist
        old = torch.gather(self._hist, 1, widx)
        self._hist.scatter_(1, widx, torch.where(emitted, out, old))
        new_pos = torch.where(act, pos + n_em, pos)
        if heads:
            hid = res[2]
            new_h = torch.gather(hid, 1, last[:, None, None].expand(S, 1, hid.shape[-1]))[:, 0]
            self._hlast.copy_(torch.where(act[:, None], new_h.to(self._hlast.dtype), self._hlast))
        elif self.spec_method == "draft":
            dpos = self._draft_cache["pos"]
            dpos.copy_(torch.where(act, new_pos, dpos))
        pos.copy_(new_pos)
        return out, emitted, tok, act2, rem, margin

    def spec_snapshot(self) -> dict:
        """The speculation configuration and its acceptance ledger."""
        ratio = (self.spec_emitted_tokens / self.spec_verify_passes
                 if self.spec_verify_passes else None)
        return {
            "spec_draft": self.spec_draft,
            "spec_ngram": self.spec_ngram if self.spec_draft else None,
            "spec_hist": self.spec_hist if self.spec_draft else None,
            "spec_method": self.spec_method,
            "spec_heads": self.spec_heads or None,
            "spec_draft_model": (f"{self._draft_geom[0]}:{self._draft_geom[1]}"
                                 if self._draft_geom else None),
            "spec_verify_passes": self.spec_verify_passes,
            "spec_emitted_tokens": self.spec_emitted_tokens,
            "accepted_tokens_per_step": round(ratio, 4) if ratio is not None else None,
            "draft_prefills": self.draft_prefills,
            "spec_heads_bytes": self.spec_heads_bytes,
            "draft_weight_bytes": self.draft_weight_bytes,
            "draft_kv_bytes": self.draft_kv_bytes,
            "row_split": sorted(self._row_split),
            "lora_rank": self.lora_rank or None,
            "adapters": self.adapters_snapshot(),
            "pool": self.pool_snapshot(),
            "memory": self.memory_snapshot(),
        }


    # ------------------------------------------------- multi-LoRA adapters

    def _lora_config(self, lora_rank, lora_slots, lora_targets) -> None:
        """The LoRA geometry and its env fallbacks: ``(lora_rank,
        lora_slots, lora_targets)`` is static (a graph key); which named
        adapter holds which row is host bookkeeping."""
        if lora_rank is None:
            lora_rank = int(os.environ.get("SCT_LORA_RANK", "0") or 0)
        if lora_slots is None:
            lora_slots = int(os.environ.get("SCT_LORA_SLOTS", "8") or 8)
        if lora_targets is None:
            lora_targets = os.environ.get("SCT_LORA_TARGETS", "qkvo")
        self.lora_rank = max(0, int(lora_rank))
        self.lora_slots = max(2, int(lora_slots)) if self.lora_rank else 0
        self.lora_targets: tuple = ()
        if self.lora_rank:
            lt = str(lora_targets or "qkvo").lower()
            if lt in ("qkvo+mlp", "all", "mlp"):
                self.lora_targets = llama.LORA_ATTN_TARGETS + llama.LORA_MLP_TARGETS
            elif lt in ("qkvo", ""):
                self.lora_targets = llama.LORA_ATTN_TARGETS
            else:
                raise GraphUnitError(
                    f"lora_targets must be 'qkvo' or 'qkvo+mlp', got {lora_targets!r}")
        # what the row-variance probes take: each delta is an op of its own
        self._lora_geom = (self.lora_rank, self.lora_targets) if self.lora_rank else None

    def _lora_state(self) -> None:
        """The stacked pool, allocated once in the model's dtype (row 0 the
        null adapter), the host registry over it, the per-slot adapter rows
        and salts, and the decode blocks' static adapter-id buffer."""
        S = self.n_slots
        self.lora_pool: AdapterPool | None = None
        self._lora: dict | None = None
        self.lora_bytes = 0
        self._slot_aidx = np.zeros(S, np.int64)
        self._slot_salt: dict[int, bytes] = {}
        # read by every decode block; changed only at sync points
        self._gaid = torch.zeros(S, dtype=torch.long, device=self.device)
        if not self.lora_rank:
            return
        self._lora = llama.init_lora_params(self.cfg, self.lora_slots, self.lora_rank,
                                            self.lora_targets, dtype=self.dtype,
                                            device=self.device)
        self.lora_bytes = sum(f[k].nbytes for f in self._lora.values() for k in ("a", "b"))
        self.lora_pool = AdapterPool(self.lora_slots, self.lora_rank, writer=self._lora_write)

    def _register_declared(self, lora_adapters) -> None:
        """Register the graph-declared adapters (``name`` or ``name:seed``,
        comma-separated or a list; env ``SCT_LORA_ADAPTERS``)."""
        if self.lora_pool is None:
            return
        if lora_adapters is None:
            lora_adapters = os.environ.get("SCT_LORA_ADAPTERS") or None
        if not lora_adapters:
            return
        names = (str(lora_adapters).split(",") if isinstance(lora_adapters, str)
                 else list(lora_adapters))
        for ent in names:
            ent = str(ent).strip()
            if ent:
                nm, _, sd = ent.partition(":")
                self.register_adapter(nm.strip(), seed=int(sd) if sd.strip() else None)

    def register_adapter(self, name: str, *, seed: int | None = None, factors: Any = None,
                         scale: float = 0.05) -> int:
        """Install adapter ``name`` into the stacked pool and return its row.
        ``factors`` is one adapter's ``{target: {"a": (L, in.., r), "b": (L,
        r, out..)}}`` (tensors or arrays, ``llama.lora_adapter_factors``'s
        layout); without it synthetic factors are drawn from ``seed``
        (default: the crc32 of the name, so every replica makes the same
        stand-in).  A new name takes a free row or evicts the least recently
        used idle one; :class:`~seldon_core_tpu_torch.executor.lora.AdapterPoolFull`
        when every row is bound to a slot."""
        if self.lora_pool is None:
            raise GraphUnitError(f"generative model {self.name!r} was built without "
                                 "multi-LoRA serving (set lora_rank / SCT_LORA_RANK)")
        if factors is None:
            if seed is None:
                seed = zlib.crc32(str(name).encode())
            gen = torch.Generator(device=self.device).manual_seed(int(seed) & 0x7FFFFFFF)
            factors = llama.lora_adapter_factors(gen, self.cfg, self.lora_rank, self.lora_targets,
                                                 scale=scale, dtype=self.dtype,
                                                 device=self.device)
        with self._lock:  # the model lock before the pool's, as admissions take them
            return self.lora_pool.register(name, factors)

    def _lora_write(self, idx: int, factors: Any) -> None:
        """The pool's device writer: copy one adapter's factors INTO row
        ``idx`` of every target, in place.  The captured decode blocks hold
        the pool's storage, so a rebind would leave them reading the old
        rows; the copies run under the model lock on the stream the blocks
        run on, so they land between two blocks, never inside one, and no
        graph is captured again."""
        with self._lock, torch.no_grad():
            for t, fac in self._lora.items():
                for key in ("a", "b"):
                    src = torch.as_tensor(factors[t][key])
                    if tuple(src.shape) != tuple(fac[key].shape[:1] + fac[key].shape[2:]):
                        raise GraphUnitError(
                            f"adapter factors {t}.{key} have shape {tuple(src.shape)}, the pool "
                            f"row {tuple(fac[key].shape[:1] + fac[key].shape[2:])}")
                    fac[key][:, int(idx)].copy_(src.to(device=self.device, dtype=fac[key].dtype))

    def check_adapter(self, adapter: str | None) -> None:
        """Raise :class:`AdapterUnavailable` unless ``adapter`` (None: the
        base model) can be served here: resident in the pool."""
        if not adapter:
            return
        if self.lora_pool is None:
            raise AdapterUnavailable(f"request names adapter {adapter!r} but model {self.name!r} "
                                 "was built without multi-LoRA serving")
        if adapter not in self.lora_pool:
            raise AdapterUnavailable(f"adapter {adapter!r} is not resident (have "
                                 f"{sorted(self.lora_pool.snapshot()['adapters'])})")

    def _acquire_adapter(self, adapter: str | None) -> int:
        """The pool row ``adapter`` binds a slot to (refcount taken; 0 for
        the base model), or :class:`AdapterUnavailable` ("not resident", or
        "without multi-LoRA")."""
        if not adapter:
            return 0
        self.check_adapter(adapter)
        try:
            return self.lora_pool.acquire(adapter)
        except UnknownAdapter as e:  # evicted since the check
            raise AdapterUnavailable(str(e)) from None

    def note_adapter_tokens(self, adapter: str | None, n: int) -> None:
        """The per-adapter served-token ledger (the scheduler's delivery
        loop), by NAME: a request that finished inside the delivered block
        has already released its slot."""
        if self.lora_pool is not None and adapter and self.lora_pool.note_tokens_name(adapter, n):
            DEFAULT_METRICS.lora_tokens.labels(
                self.name, DEFAULT_METRICS.adapter_label(adapter)).inc(int(n))

    def slot_adapter(self, slot: int) -> str | None:
        """The resident adapter bound to ``slot`` (None: the base model)."""
        if self.lora_pool is None:
            return None
        return self.lora_pool.name_of(int(self._slot_aidx[int(slot)]))

    def adapters_snapshot(self) -> dict | None:
        """The adapter pool's ledger (None with LoRA off): capacity,
        resident, evictions, loads and per adapter its row, bound slots,
        tokens served and loads, plus the pool's bytes."""
        if self.lora_pool is None:
            return None
        snap = self.lora_pool.snapshot()
        snap["bytes"] = self.lora_bytes
        m = DEFAULT_METRICS
        m.lora_resident.labels(self.name).set(snap["resident"])
        m.lora_evictions.labels(self.name).set(snap["evictions"])
        m.lora_bytes.labels(self.name).set(self.lora_bytes)
        return snap

    # ------------------------------------------------------- memory ledger

    def _reserve_memory(self, memory: MemoryManager | None) -> None:
        """Reserve this model's device byte classes on ``memory`` (default:
        the process's ledger of the device) for its lifetime; a model that
        is dropped without :meth:`release_memory` releases them when it is
        collected."""
        self.memory = memory if memory is not None else device_memory(self.device)
        self.param_bytes = sum(p.nbytes for p in self.params.parameters())
        self.memory.reserve(self._mem_key, self._byte_classes())
        weakref.finalize(self, self.memory.release, self._mem_key)
        weakref.finalize(self, host_memory().release, self._mem_key)

    def _byte_classes(self) -> dict[str, int]:
        c = self._cache
        return {
            "weights": self.param_bytes,
            "kv_pool": c["k"].nbytes + c["v"].nbytes,
            "kv_scales": (c["k_scale"].nbytes + c["v_scale"].nbytes) if "k_scale" in c else 0,
            "adapter_pool": self.lora_bytes,
            "spec_heads": self.spec_heads_bytes,
            "draft_weights": self.draft_weight_bytes,
            "draft_kv": self.draft_kv_bytes,
        }

    def release_memory(self) -> None:
        """Drop this model's rows from the device ledger and the host ledger
        (suspend records ledger host bytes on a model with no prefix tier
        too), once the device call in flight (one a closed scheduler left
        running in a thread) has ended: it holds the model's lock."""
        with self._lock:
            self.memory.release(self._mem_key)
            self._host_classes.clear()
            host_memory().release(self._mem_key)

    def _note_host_bytes(self, cls: str, nbytes: int) -> None:
        """Set one host-DRAM byte class of this model in the host ledger.
        A reservation replaces the owner's classes, so every class is
        re-reserved together: the suspend store never wipes the prefix
        tier's bytes, nor the other way round."""
        self._host_classes[str(cls)] = int(nbytes)
        host_memory().reserve(self._mem_key, dict(self._host_classes))

    def _note_dram_bytes(self, nbytes: int) -> None:
        """The prefix tier's byte callback (``prefix_dram``)."""
        self._note_host_bytes("prefix_dram", nbytes)
        DEFAULT_METRICS.prefix_tier_bytes.labels(self.name, "dram").set(int(nbytes))

    def note_suspend_bytes(self, nbytes: int) -> None:
        """The suspend store's byte callback (``suspend_dram``)."""
        self._note_host_bytes("suspend_dram", nbytes)

    def memory_snapshot(self) -> dict:
        """This model's rows in the card's ledger and the host ledger."""
        return {
            "owner": self._mem_key,
            "hbm": self.memory.snapshot()["owners"].get(self._mem_key),
            "host": host_memory().snapshot()["owners"].get(self._mem_key),
        }

    def pool_snapshot(self) -> dict:
        """The pool's blocks and byte classes beside the card's ledger; also
        refreshes the ``seldon_kv_*`` gauges (a scrape's, never the decode
        path's)."""
        with self._lock:
            snap = {
                "blocks": {"total": self.kv_blocks - 1, "free": len(self._free_blocks),
                           "prefix_index": (len(self.prefix_index)
                                            if self.prefix_index is not None else 0),
                           "slots": sum(len(b) for b in self._slot_blocks.values()),
                           "high_water": self._blocks_high_water,
                           "block_size": self.kv_block_size},
                "bytes": {**self._byte_classes(),
                          "prefix_dram": (self.host_store.bytes
                                          if self.host_store is not None else 0),
                          "per_slot": self.kv_bytes_per_slot()},
                "hbm": self.memory.snapshot(),
                "prefix_evictions": (self.prefix_index.evicted
                                     if self.prefix_index is not None else 0),
            }
        m, b = DEFAULT_METRICS, snap["blocks"]
        for state in ("free", "prefix_index", "slots"):
            m.kv_blocks.labels(self.name, state).set(b[state])
        m.kv_blocks_high_water.labels(self.name).set(b["high_water"])
        for cls in ("weights", "kv_pool", "kv_scales", "adapter_pool"):
            m.kv_bytes.labels(self.name, cls).set(snap["bytes"].get(cls, 0))
        m.kv_prefix_evictions.labels(self.name).set(snap["prefix_evictions"])
        return snap

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
        row, _ = self.reserve_for_prompt(slot, None, total_tokens)
        return row

    def reserve_for_prompt(
        self, slot: int, prompt: np.ndarray | None, total_tokens: int,
        adapter: str | None = None,
    ) -> tuple[np.ndarray, int]:
        """Prompt-aware reservation: with prefix reuse on, the longest chain
        of the prompt's full blocks already in the index is REFERENCED
        (shared, immutable) instead of allocated, and only the rest comes
        from the free pool (unreferenced index blocks are reclaimed, and
        demoted to the DRAM tier when it is on, before
        :class:`OutOfKVBlocks` is raised).  Demoted levels that extend the
        match are promoted into the leading owned blocks with one indexed
        copy.  Returns ``(table row, prefix_len)``: the caller skips
        ``prefix_len`` tokens of prefill.

        ``adapter`` binds the slot to a resident LoRA adapter's row for the
        request's lifetime (refcounted, released with the slot) and salts
        the prefix keys: an adapter changes K/V, so its chains never serve
        another adapter or the base model.  An adapter that is not resident,
        or any adapter on a model without LoRA, raises
        :class:`AdapterUnavailable`."""
        slot = int(slot)
        total = min(int(total_tokens), self.cfg.max_seq)
        need = -(-total // self.kv_block_size)
        salt = adapter_salt(adapter)
        with self._lock:  # the event loop releases while admissions run in a thread
            self.release_slot(slot)  # a stale reservation on this slot is dead
            aidx = self._acquire_adapter(adapter)
            matched: list[int] = []
            promoted: list[tuple] = []
            if self.prefix_index is not None and prompt is not None:
                # never the WHOLE prompt: the suffix program needs at least
                # one real token to produce the first sampled logits
                max_reuse = min((int(prompt.size) - 1) // self.kv_block_size, need)
                if max_reuse > 0:
                    matched = self.prefix_index.match(prompt, max_reuse, salt=salt)
                if self.host_store is not None and max_reuse > len(matched):
                    # demoted levels extending the match come out of the
                    # free pool like owned blocks: the need is the same
                    promoted = self.host_store.match(prompt, len(matched) + 1, max_reuse,
                                                     salt=salt)
            own_need = need - len(matched)
            if len(self._free_blocks) < own_need:
                self._demote_and_free(own_need - len(self._free_blocks))
            if len(self._free_blocks) < own_need:
                if matched:
                    self.prefix_index.release(prompt, len(matched), salt=salt)
                if aidx:
                    self.lora_pool.release_ref(aidx)
                raise OutOfKVBlocks(f"need {own_need} KV blocks, {len(self._free_blocks)} free")
            got = self._free_blocks[-own_need:] if own_need else []
            if own_need:
                del self._free_blocks[-own_need:]
            n_promoted = 0
            if promoted:
                try:
                    self._promote(got[: len(promoted)], promoted)
                    n_promoted = len(promoted)
                    self.host_store.drop([e[0] for e in promoted])
                    self.dram_hits += 1
                except Exception:  # noqa: BLE001 - costs the shortcut, not the request
                    log.warning("generative model %r: DRAM prefix promotion failed; "
                                "prefilling instead", self.name, exc_info=True)
            self._slot_blocks[slot] = got
            self._slot_aidx[slot] = aidx
            if salt:
                self._slot_salt[slot] = salt
            row = np.zeros(self.max_blocks_per_slot, np.int32)
            row[: len(matched)] = matched
            row[len(matched):need] = got
            self._slot_row[slot] = row.copy()
            self._slot_promoted[slot] = n_promoted
            used = (self.kv_blocks - 1) - len(self._free_blocks)
            self._blocks_high_water = max(self._blocks_high_water, used)
            prefix_len = (len(matched) + n_promoted) * self.kv_block_size
            if prefix_len:
                DEFAULT_METRICS.prefix_tokens_reused.labels(self.name).inc(prefix_len)
            if self.prefix_index is not None and prompt is not None:
                self._slot_prompt[slot] = np.asarray(prompt, np.int32).copy()
                self._slot_matched[slot] = len(matched)
                peer = self._credit_peer_tier(prompt, len(matched), salt)
                # the tier that spared the prefill, for the usage meter
                tier = ("dram" if n_promoted else "peer" if peer
                        else "hbm" if matched else "none")
                self._slot_saved[slot] = (prefix_len, tier)
        return row, prefix_len

    def reservation_snapshot(self, slot: int) -> dict | None:
        """The host's bookkeeping of ``slot``'s reservation (None when it
        holds none): the timeline's admit event."""
        slot = int(slot)
        if self._slot_row.get(slot) is None:
            return None
        matched = self._slot_matched.get(slot, 0)
        promoted = self._slot_promoted.get(slot, 0)
        return {
            "blocks_reused": matched,
            "blocks_promoted": promoted,
            "blocks_allocated": len(self._slot_blocks.get(slot, ())),
            "prefix_tokens": (matched + promoted) * self.kv_block_size,
            "tier": self._slot_saved.get(slot, (0, "none"))[1],
        }

    def reservation_saved(self, slot: int) -> tuple[int, str]:
        """``(prefix tokens not prefilled, tier)`` of ``slot``'s reservation:
        the tier is ``hbm`` (the index), ``dram``, ``peer`` or ``none``."""
        return self._slot_saved.get(int(slot), (0, "none"))

    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s owned blocks to the pool and drop its shared-
        prefix refs (idempotent).  With prefix reuse on, the completed
        prompt's FULL owned blocks are absorbed into the index (zero-ref,
        evictable) instead of freed, so the next prompt sharing the prefix
        finds them; a prompt whose prefill never completed (cancelled or
        failed) gives none.  The slot's adapter ref goes back and its id
        becomes the null adapter's."""
        slot = int(slot)
        with self._lock:  # the event loop releases while admissions run in a thread
            matched = self._slot_matched.pop(slot, 0)
            self._slot_saved.pop(slot, None)
            self._slot_promoted.pop(slot, None)
            prompt = self._slot_prompt.pop(slot, None)
            blocks = self._slot_blocks.pop(slot, None)
            salt = self._slot_salt.pop(slot, b"")
            aidx = int(self._slot_aidx[slot])
            if aidx:
                self._slot_aidx[slot] = 0
                self.lora_pool.release_ref(aidx)
            filled = slot in self._slot_filled
            self._slot_filled.discard(slot)
            self._slot_row.pop(slot, None)
            if matched and prompt is not None:
                self.prefix_index.release(prompt, matched, salt=salt)
            if not blocks:
                return
            if prompt is not None and filled:
                # owned blocks are table positions [matched, need); the first
                # (full prompt blocks - matched) hold complete prompt K/V only
                full = int(prompt.size) // self.kv_block_size
                insertable = blocks[: max(0, full - matched)]
                if insertable:
                    # under the slot's adapter salt: adapter chains never cross
                    rejected = self.prefix_index.insert(prompt, insertable, matched, salt=salt)
                    absorbed = set(insertable) - set(rejected)
                    blocks = [b for b in blocks if b not in absorbed]
            self._free_blocks.extend(blocks)
            if self.prefix_index is not None:
                DEFAULT_METRICS.prefix_blocks.labels(self.name).set(len(self.prefix_index))

    @property
    def free_block_count(self) -> int:
        return len(self._free_blocks)

    # ------------------------------------------ KV handoff and prefix tiers
    #
    # Exports, imports, demotions, promotions and peer installs are gathers
    # and indexed copies on the pool, in place (no pool copy), each moving
    # its blocks in ONE host<->device copy.  The scheduler runs imports,
    # demotions, promotions and installs at its sync points, never inside
    # a decode block.

    def _pool_keys(self) -> list[str]:
        return [k for k in ("k", "v", "k_scale", "v_scale") if k in self._cache]

    def _fetch_blocks(self, phys) -> dict[str, torch.Tensor]:
        """Blocks ``phys`` of every pool tensor (K, V and an int8 pool's
        scales, ``(layers, n, block_size, ...)`` each) on the host, through
        one device-to-host copy of their bytes."""
        idx = self._h2d(np.asarray(phys, np.int64))
        with self._lock:
            parts = [self._cache[key].index_select(1, idx) for key in self._pool_keys()]
            flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).cpu()
        out, off = {}, 0
        for key, p in zip(self._pool_keys(), parts):
            n = p.numel() * p.element_size()
            out[key] = flat[off: off + n].view(p.dtype).reshape(p.shape)
            off += n
        return out

    def _put_blocks(self, phys, blocks: dict) -> None:
        """Write host blocks (``(layers, n, block_size, ...)`` per pool
        tensor) into the pool at ``phys``: one host-to-device copy of their
        bytes, then one in-place ``index_copy_`` per pool tensor.  Float
        blocks take the pool's float dtype; int8 blocks and their scales
        are the pool's bytes verbatim (callers check the layout)."""
        keys = self._pool_keys()
        parts = [torch.as_tensor(blocks[key]).to(self._cache[key].dtype).contiguous()
                 for key in keys]
        flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts]).to(self.device)
        idx = self._h2d(np.asarray(phys, np.int64))
        off = 0
        with self._lock:
            for key, p in zip(keys, parts):
                n = p.numel() * p.element_size()
                self._cache[key].index_copy_(1, idx, flat[off: off + n].view(p.dtype).view(p.shape))
                off += n

    def _check_blocks(self, what: str, k, v, k_scale, v_scale, depth: int) -> tuple:
        """``(k, v, k_scale, v_scale)`` as tensors after the shape and layout
        checks an import or install makes: a config, block-size or layout
        skew raises :class:`GraphUnitError`."""
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        cfg, bs = self.cfg, self.kv_block_size
        expect = (cfg.n_layers, depth, bs, cfg.n_kv_heads, cfg.head_dim)
        if tuple(k.shape) != expect or tuple(v.shape) != expect:
            raise GraphUnitError(
                f"{what} KV shape {tuple(k.shape)} does not match this pool's {expect} "
                "(config or block-size skew)"
            )
        if bool(self.kv_dtype) != (k_scale is not None):
            raise GraphUnitError(
                f"{what} KV dtype skew: the pool is {self.kv_dtype or 'float'} but the "
                f"blocks {'carry' if k_scale is not None else 'lack'} int8 scales; pools "
                "must share kv_cache_dtype"
            )
        if k_scale is None:
            if not (k.is_floating_point() and v.is_floating_point()):
                raise GraphUnitError(f"{what} KV of dtype {k.dtype} into a float pool")
            return k, v, None, None
        k_scale, v_scale = torch.as_tensor(k_scale), torch.as_tensor(v_scale)
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise GraphUnitError(f"{what} KV of dtype {k.dtype} into an int8 pool")
        if tuple(k_scale.shape) != expect[:4] or tuple(v_scale.shape) != expect[:4]:
            raise GraphUnitError(
                f"{what} KV scale shape {tuple(k_scale.shape)} does not match this pool's "
                f"{expect[:4]}"
            )
        return k, v, k_scale, v_scale

    def export_slot_kv(self, slot: int, prompt_len: int) -> tuple:
        """``slot``'s prompt blocks on the host for a handoff: ``(k, v)``,
        ``(layers, ceil(prompt_len / bs), bs, kv_heads, head_dim)`` each, or
        ``(k, v, k_scale, v_scale)`` from an int8 pool (its bytes verbatim).
        The slot's reservation pins the blocks, shared prefix blocks too,
        until the owner releases it."""
        row = self._slot_row.get(int(slot))
        if row is None:
            raise GraphUnitError(f"slot {slot} holds no reservation to export")
        nb = -(-int(prompt_len) // self.kv_block_size)
        got = self._fetch_blocks(row[:nb])
        return tuple(got[key] for key in self._pool_keys())

    def export_spec_state(self, slot: int) -> dict | None:
        """The proposer state a handoff carries (codec v5): the method and,
        for ``heads``, the slot's last verified hidden (one device-to-host
        copy).  ``draft`` carries no tensor (the importer prefills its draft
        pool from the prompt); ``None`` for ``ngram`` and no speculation
        (the history ring is rebuilt from the prompt)."""
        if not self.spec_method or self.spec_method == "ngram":
            return None
        state: dict = {"method": self.spec_method}
        if self.spec_method == "heads":
            with self._lock:
                state["hlast"] = self._hlast[int(slot)].cpu()
        return state

    def attach_imported(
        self, slot: int, prompt: np.ndarray, k, v, *, reserve_tokens: int = 0,
        k_scale=None, v_scale=None, first_token: int | None = None,
        spec_state: dict | None = None, adapter: str | None = None,
    ) -> None:
        """Install another engine's exported prompt KV into ``slot``: reserve
        blocks (longest-prefix reuse applies: blocks this pool already
        holds for the leading prompt blocks are referenced, not rewritten;
        equal prefixes hold equal bytes), copy the novel blocks in, set the
        slot's position and table, and seed speculation (the history ring
        from the prompt and ``first_token``; the carried Medusa hidden, or
        zeros; the draft pool's prefill).  The slot then decodes as if it
        had prefilled here.  An int8 pool takes the int8 blocks and scales
        verbatim.  A shape, layout or block-size skew raises
        :class:`GraphUnitError`, a full pool :class:`OutOfKVBlocks`; a
        failed import releases every block it took.  ``adapter`` binds the
        slot to that resident adapter (the KV was made through it)."""
        prompt = np.asarray(prompt, np.int32).ravel()
        L = int(prompt.size)
        if L < 1:
            raise GraphUnitError("empty prompt")
        bs = self.kv_block_size
        nb = -(-L // bs)
        k, v, k_scale, v_scale = self._check_blocks("imported", k, v, k_scale, v_scale, nb)
        slot = int(slot)
        with self._lock, torch.no_grad():
            row, prefix_len = self.reserve_for_prompt(slot, prompt, L + max(0, int(reserve_tokens)),
                                                      adapter=adapter)
            skip = prefix_len // bs
            try:
                if skip < nb:
                    parts = {"k": k, "v": v, "k_scale": k_scale, "v_scale": v_scale}
                    self._put_blocks(row[skip:nb], {key: parts[key][:, skip:]
                                                    for key in self._pool_keys()})
                self._cache["pos"][slot] = L
                self._cache["table"][slot] = self._h2d(row)
                if self.spec_draft:
                    seed = seed_history(prompt, self.spec_hist)
                    if first_token is not None:
                        seed[L % self.spec_hist] = int(first_token)
                    self._hist[slot] = self._h2d(seed)
                if self._hlast is not None:
                    # a frame without the hidden costs the first pass's
                    # acceptance, never output
                    hl = (spec_state or {}).get("hlast")
                    self._hlast[slot] = (torch.as_tensor(hl).to(self.device, self._hlast.dtype)
                                         if hl is not None else 0)
                self.draft_prefill_dispatch(slot, prompt)
            except BaseException:
                self.release_slot(slot)
                raise
            self._pos_ceiling[slot] = L
            self._slot_filled.add(slot)  # its prompt blocks hold complete K/V
            self.imports += 1

    def _demote_and_free(self, shortfall: int) -> None:
        """Evict up to ``shortfall`` blocks of zero-ref prefix chains into
        the free pool, demoting the victims' blocks into the DRAM store
        first (one device-to-host copy for the whole victim set).  Without
        the DRAM tier this is plain eviction."""
        if self.prefix_index is None or shortfall <= 0:
            return
        victims = self.prefix_index.evict_entries(shortfall)
        if not victims:
            return
        if self.host_store is not None:
            try:
                got = self._fetch_blocks([b for _k, _d, b in victims])
                # shallowest level first, so a rejected level truncates its
                # chain's tail instead of stranding it
                order = sorted(range(len(victims)),
                               key=lambda j: (victims[j][0][0], len(victims[j][0][1])))
                rejected: list[tuple] = []
                for i in order:
                    key, depth, _block = victims[i]
                    if any(key[0] == r[0] and key[1].startswith(r[1]) for r in rejected):
                        continue
                    level = {name: t[:, i].clone() for name, t in got.items()}
                    if not self.host_store.put(key, depth, level["k"], level["v"],
                                               level.get("k_scale"), level.get("v_scale")):
                        rejected.append(key)
            except Exception:  # noqa: BLE001 - the blocks are freed either way
                log.warning("generative model %r: DRAM prefix demotion failed; dropping %d "
                            "evicted blocks", self.name, len(victims), exc_info=True)
        self._free_blocks.extend(b for _k, _d, b in victims)

    def _credit_peer_tier(self, prompt: np.ndarray, n_matched: int, salt: bytes = b"") -> bool:
        """Count a peer hit when a matched level came from a peer pull no
        admission has used yet (the credit is used up: later matches of
        those levels are plain index hits); returns whether it counted."""
        if n_matched and self._peer_chains:
            keys = {HostPrefixStore.level_key(prompt, lvl, self.kv_block_size, salt)
                    for lvl in range(1, n_matched + 1)}
            if keys & self._peer_chains:
                self._peer_chains -= keys
                self.peer_hits += 1
                return True
        return False

    def _promote(self, blocks: list[int], entries: list[tuple]) -> None:
        """Copy DRAM store entries (``(key, depth, k, v, k_scale, v_scale)``,
        one block each) into pool ``blocks``."""
        names = self._pool_keys()
        col = {"k": 2, "v": 3, "k_scale": 4, "v_scale": 5}
        self._put_blocks(blocks, {name: torch.stack([e[col[name]] for e in entries], 1)
                                  for name in names})

    def export_prefix_kv(self, tokens: np.ndarray, max_blocks: int = 64,
                         adapter: str | None = None) -> tuple | None:
        """Serve a peer's prefix pull: the longest chain this pool holds for
        ``tokens`` under ``adapter``'s salt (index levels, then the DRAM
        levels that extend them) as ``(depth, k, v, k_scale, v_scale)`` on
        the host, KV ``(layers, depth, block_size, kv_heads, head_dim)``;
        None on no match, a wrong adapter's probe included.  The index
        levels are ref-pinned while they are fetched, so an admission's
        eviction cannot free or demote them mid-export."""
        if self.prefix_index is None:
            return None
        salt = adapter_salt(adapter)
        tokens = np.asarray(tokens, np.int32).ravel()
        cap = min(int(max_blocks), int(tokens.size) // self.kv_block_size,
                  self.max_blocks_per_slot)
        if cap < 1:
            return None
        blocks: dict | None = None
        pinned = self.prefix_index.acquire(tokens, cap, salt=salt)
        depth = len(pinned)
        if pinned:
            try:
                blocks = self._fetch_blocks([b for _k, _d, b in pinned])
            finally:
                self.prefix_index.release(tokens, depth, salt=salt)
        if self.host_store is not None and depth < cap:
            ext = self.host_store.match(tokens, depth + 1, cap, salt=salt)
            if ext:
                col = {"k": 2, "v": 3, "k_scale": 4, "v_scale": 5}
                more = {name: torch.stack([e[col[name]] for e in ext], 1)
                        for name in self._pool_keys()}
                blocks = more if blocks is None else {
                    name: torch.cat([blocks[name], more[name]], 1) for name in blocks}
                depth += len(ext)
        if not depth:
            return None
        self.peer_serves += 1
        return depth, blocks["k"], blocks["v"], blocks.get("k_scale"), blocks.get("v_scale")

    def install_prefix_chain(self, tokens: np.ndarray, k, v, k_scale=None, v_scale=None,
                             adapter: str | None = None) -> int:
        """Install a peer-pulled chain into the pool and the index (the
        scheduler calls it at a sync point), under ``adapter``'s salt (the
        KV was made through that adapter, which must be resident here).
        Only levels deeper than what is resident are installed, as zero-ref
        index entries, evictable like an absorbed prompt.  Returns the
        levels installed (0 when all were resident or the pool has no block
        to spare); a failure frees every block it took."""
        if self.prefix_index is None:
            raise GraphUnitError(f"model {self.name!r} has no prefix index to install into")
        if adapter and (self.lora_pool is None or adapter not in self.lora_pool):
            raise GraphUnitError(f"pulled chain names adapter {adapter!r} but it is not "
                                 "resident on this engine")
        salt = adapter_salt(adapter)
        tokens = np.asarray(tokens, np.int32).ravel()
        bs = self.kv_block_size
        depth = int(k.shape[1]) if getattr(k, "ndim", 0) == 5 else 0
        if depth < 1:
            raise GraphUnitError(f"pulled chain KV shape {tuple(k.shape)} has no block")
        k, v, k_scale, v_scale = self._check_blocks("pulled chain", k, v, k_scale, v_scale, depth)
        if int(tokens.size) < depth * bs:
            raise GraphUnitError("pulled chain tokens do not cover its blocks")
        with self._lock, torch.no_grad():
            have = self.prefix_index.peek_depth(tokens, depth, salt)
            if have >= depth:
                return 0
            n_new = depth - have
            if len(self._free_blocks) < n_new:
                self._demote_and_free(n_new - len(self._free_blocks))
            if len(self._free_blocks) < n_new:
                return 0  # the pool is too full to cache a pull; nothing taken
            got = self._free_blocks[-n_new:]
            del self._free_blocks[-n_new:]
            try:
                parts = {"k": k, "v": v, "k_scale": k_scale, "v_scale": v_scale}
                self._put_blocks(got, {key: parts[key][:, have:] for key in self._pool_keys()})
                rejected = self.prefix_index.insert(tokens, got, have, salt=salt)
            except BaseException:
                self._free_blocks.extend(got)
                raise
            self._free_blocks.extend(rejected)
            for lvl in range(have + 1, depth + 1):
                self._peer_chains.add(HostPrefixStore.level_key(tokens, lvl, bs, salt))
            absorbed = n_new - len(rejected)
            self.peer_installs += absorbed
            return absorbed

    # ----------------------------------------------------------- prefill

    def _count_prefill(self, payload: dict, *, reused: bool = False) -> None:
        """A chunked admission counts ONE logical prefill (on its final
        chunk) plus one ``prefill_chunks`` tick per chunk dispatched;
        ``prefills_reused`` counts only admissions whose reservation matched
        a shared prefix, never the suffix calls chunking itself makes.  The
        logical prefill's end marks the slot's prompt as written."""
        ch = payload.get("chunk")
        if ch is None:
            self.prefills += 1
            self.prefills_reused += int(reused)
            self._slot_filled.add(payload["slot"])
            return
        self.prefill_chunks += 1
        if ch["last"]:
            self.prefills += 1
            self.prefills_reused += int(ch["reused"])
            self._slot_filled.add(payload["slot"])

    def _sample_first(self, logits, payload: dict) -> torch.Tensor:
        temp = torch.full((1,), float(payload["temperature"]), device=self.device)
        gen = self._generator(payload["seed"])
        return llama.sample_tokens(logits[None], temp, gen, self.top_k)[0]

    def _exec_prefill(self, payload: dict) -> torch.Tensor:
        """Cold prefill of ``payload["padded"]`` into the slot's blocks; the
        sampled token stays on the device."""
        heads = self.spec_method == "heads"
        with self._lock, torch.no_grad():
            res = llama.prefill_slot_paged(
                self.params, self._h2d(payload["padded"]), payload["length"], payload["slot"],
                self._h2d(payload["blocks"]), self._cache, self.cfg, seq_impl=self.seq_impl,
                return_hidden=heads, op=self._prefill_op, lora=self._lora,
                adapter_id=payload.get("aid", 0),
            )
            tok = self._sample_first(res[0], payload)
            self._prompt_landed(payload, tok, res[2] if heads else None)
            self._count_prefill(payload)
        return tok

    def _exec_prefill_suffix(self, payload: dict) -> torch.Tensor:
        """Suffix prefill over the ``prefix_len`` rows the slot's blocks
        already hold (a reused prefix or earlier chunks)."""
        heads = self.spec_method == "heads"
        with self._lock, torch.no_grad():
            res = llama.prefill_suffix_paged(
                self.params, self._h2d(payload["padded"]), payload["prefix_len"],
                payload["length"], payload["slot"], self._h2d(payload["blocks"]),
                self._h2d(payload["suffix_blocks"]), self._cache, self.cfg,
                prefix_window=payload["window"], return_hidden=heads, op=self._prefill_op,
                lora=self._lora, adapter_id=payload.get("aid", 0),
            )
            tok = self._sample_first(res[0], payload)
            self._prompt_landed(payload, tok, res[2] if heads else None)
            self._count_prefill(payload, reused=True)
        return tok

    def _prefix_window(self, prefix_len: int) -> int:
        """Smallest power-of-two multiple of the block size covering
        ``prefix_len``, capped at max_seq."""
        w = self.kv_block_size
        while w < prefix_len:
            w *= 2
        return min(w, self.cfg.max_seq)

    def _padded(self, seg: np.ndarray) -> np.ndarray:
        padded = np.zeros((1, self.fit_bucket(seg.size)), np.int32)
        padded[0, : seg.size] = seg
        return padded

    def _suffix_payload(self, seg: np.ndarray, prefix_len: int, length: int, slot: int,
                        row: np.ndarray, temperature: float, seed: int) -> dict:
        """The suffix program's inputs for ``seg``, the prompt's tokens at
        ``[prefix_len, length)``; a bucket that runs past the reservation
        pads its block list with the sink 0."""
        padded = self._padded(seg)
        pb = prefix_len // self.kv_block_size
        suffix_blocks = np.zeros(padded.shape[1] // self.kv_block_size, np.int32)
        avail = row[pb: pb + suffix_blocks.size]
        suffix_blocks[: avail.size] = avail
        return {
            "padded": padded, "prefix_len": int(prefix_len), "length": int(length),
            "slot": int(slot), "blocks": row, "suffix_blocks": suffix_blocks,
            "window": self._prefix_window(prefix_len), "temperature": float(temperature),
            "seed": int(seed), "aid": int(self._slot_aidx[int(slot)]),
        }

    def admit_dispatch(
        self, slot: int, prompt: np.ndarray, temperature: float, seed: int,
        reserve_tokens: int = 0, adapter: str | None = None,
    ) -> torch.Tensor:
        """Prefill ``prompt`` (1-D ids) into ``slot`` WITHOUT fetching the
        sampled token (a 0-d device tensor is returned), so several
        admissions cost one host fetch (:meth:`fetch_tokens`).  A reused
        prefix skips its prefill; a prompt longer than ``prefill_chunk``
        runs its chunks back to back (the scheduler paces them instead,
        through :meth:`admit_chunk_plan`, while streams decode).  With
        ``spec_method='draft'`` the draft model's pool is prefilled with the
        whole prompt first (the draft model serves no adapter).  ``adapter``
        binds the slot (:meth:`reserve_for_prompt`): its prefill, chunks and
        decode steps gather that adapter's row."""
        prompt = np.asarray(prompt, np.int32).ravel()
        L = int(prompt.size)
        if L < 1:
            raise GraphUnitError("empty prompt")
        if self.prefill_chunk and L > self.prefill_chunk:
            plan = self.admit_chunk_plan(slot, prompt, temperature, seed, reserve_tokens,
                                         adapter=adapter)
            tok = None
            for i in range(len(plan["payloads"])):
                tok = self.prefill_chunk_dispatch(plan, i)
            return tok
        self.fit_bucket(L)  # a prompt too long raises before any block is reserved
        with self._lock:
            row, prefix_len = self.reserve_for_prompt(
                slot, prompt, L + max(0, int(reserve_tokens)), adapter=adapter
            )
            self._pos_ceiling[int(slot)] = L  # prefill wrote rows [0, L)
            self.draft_prefill_dispatch(slot, prompt)
            if prefix_len > 0:
                return self._exec_prefill_suffix(self._with_hist(self._suffix_payload(
                    prompt[prefix_len:], prefix_len, L, slot, row, temperature, seed), prompt))
            return self._exec_prefill(self._with_hist({
                "padded": self._padded(prompt), "length": L, "slot": int(slot),
                "blocks": row, "temperature": float(temperature), "seed": int(seed),
                "aid": int(self._slot_aidx[int(slot)]),
            }, prompt))

    def admit_chunk_plan(
        self, slot: int, prompt: np.ndarray, temperature: float, seed: int,
        reserve_tokens: int = 0, adapter: str | None = None,
    ) -> dict:
        """Reserve ``slot``'s blocks and lay the admission out as prefill
        chunks of ``prefill_chunk`` tokens, after the reused prefix if one
        matched.  Nothing touches the device here: the scheduler dispatches
        one chunk per decode sync point (:meth:`prefill_chunk_dispatch`).
        Chunk 0 (when nothing was reused) is the cold prefill; every later
        chunk is the suffix program over the slot's own blocks; the last
        samples with the admission's seed, as the monolithic prefill does."""
        prompt = np.asarray(prompt, np.int32).ravel()
        L = int(prompt.size)
        if L < 1:
            raise GraphUnitError("empty prompt")
        with self._lock:
            row, prefix_len = self.reserve_for_prompt(
                slot, prompt, L + max(0, int(reserve_tokens)), adapter=adapter
            )
            self._pos_ceiling[int(slot)] = L
        C = self.prefill_chunk or L
        starts = list(range(prefix_len, L, C))
        payloads = []
        for idx, s in enumerate(starts):
            e = min(s + C, L)
            meta = {"last": idx == len(starts) - 1, "reused": prefix_len > 0}
            if s == 0:
                payloads.append(("prefill", self._with_hist({
                    "padded": self._padded(prompt[:e]), "length": e, "slot": int(slot),
                    "blocks": row, "temperature": float(temperature), "seed": int(seed),
                    "chunk": meta, "aid": int(self._slot_aidx[int(slot)]),
                }, prompt[:e])))
            else:
                payload = self._suffix_payload(prompt[s:e], s, e, slot, row, temperature, seed)
                payloads.append(("suffix", self._with_hist({**payload, "chunk": meta}, prompt[:e])))
        return {"slot": int(slot), "payloads": payloads, "prompt": prompt}

    def prefill_chunk_dispatch(self, plan: dict, i: int) -> torch.Tensor:
        """Dispatch chunk ``i`` of an :meth:`admit_chunk_plan` admission.
        Returns the chunk's sampled token on the device: only the final
        chunk's is the request's first token; the others are never
        fetched, so chunking adds no host sync.  The first chunk also
        prefills the draft model's pool with the whole prompt
        (``spec_method='draft'``)."""
        kind, payload = plan["payloads"][i]
        if i == 0:
            self.draft_prefill_dispatch(plan["slot"], plan["prompt"])
        if kind == "prefill":
            return self._exec_prefill(payload)
        return self._exec_prefill_suffix(payload)

    def fetch_tokens(self, toks: list[torch.Tensor]) -> list[int]:
        """One device->host fetch for several admissions' first tokens."""
        if not toks:
            return []
        return [int(t) for t in torch.stack(toks).cpu().tolist()]

    def admit(self, slot: int, prompt: np.ndarray, temperature: float, seed: int,
              reserve_tokens: int = 0, adapter: str | None = None) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled token."""
        return self.fetch_tokens(
            [self.admit_dispatch(slot, prompt, temperature, seed, reserve_tokens, adapter)]
        )[0]

    # ------------------------------------------------------ pool accounting

    def kv_bytes_per_block(self) -> int:
        """Device bytes one KV block costs in this pool (scales included)."""
        return sum(
            self._cache[key].nbytes // self.kv_blocks
            for key in ("k", "v", "k_scale", "v_scale") if key in self._cache
        )

    def kv_bytes_per_slot(self) -> int:
        """Device bytes one max_seq slot costs in this pool's layout."""
        return llama.paged_kv_slot_bytes(
            self.cfg, self.kv_block_size, kv_dtype=self.kv_dtype, dtype=self.dtype
        )

    def kv_slots_per_chip(self, hbm_bytes: int | None = None) -> int:
        """Max-seq sequences this pool layout fits on the device after the
        weights.  The budget defaults to ``SCT_HBM_GB`` when set, else the
        card's memory (``torch.cuda.get_device_properties``); a CPU model
        needs one of the two."""
        if hbm_bytes is None:
            if self.device.type != "cuda" and not os.environ.get("SCT_HBM_GB"):
                raise ValueError("kv_slots_per_chip on the CPU needs hbm_bytes or SCT_HBM_GB")
            hbm_bytes = hbm_budget_bytes(self.device)
        param_bytes = sum(p.nbytes for p in self.params.parameters())
        return max(0, int((hbm_bytes - param_bytes) // self.kv_bytes_per_slot()))

    def prefix_snapshot(self) -> dict | None:
        """The KV prefix index's state (None when reuse is off).  Served on
        the event loop (``/stats/cache``, ``/stats/summary``), so it takes no
        model lock, which a warmup holds for seconds: the index and the DRAM
        tier lock their own state."""
        if self.prefix_index is None:
            return None
        snap = self.prefix_index.snapshot()
        snap.update(
            free_blocks=len(self._free_blocks), pool_blocks=self.kv_blocks - 1,
            prefills=self.prefills, prefills_reused=self.prefills_reused,
            kv_imports=self.imports, digest=self.prefix_index.digest(),
        )
        # the same six fields for every tier, zero where a tier has no
        # such flow, as the JAX package reports them
        tiers = {
            "hbm": {"hits": snap["hits"], "misses": snap["misses"], "promotions": 0,
                    "demotions": snap["evicted"],
                    "bytes": len(self.prefix_index) * self.kv_bytes_per_block(),
                    "pull_count": 0},
            "peer": {"hits": self.peer_hits, "misses": 0, "promotions": self.peer_installs,
                     "demotions": 0, "bytes": 0, "pull_count": self.peer_serves},
        }
        if self.host_store is not None:
            st = self.host_store.snapshot()
            tiers["dram"] = {
                **{key: st[key] for key in ("hits", "misses", "promotions", "demotions",
                                            "bytes")},
                "pull_count": 0, "dram_hits": self.dram_hits,
                **{key: st[key] for key in ("entries", "budget_bytes", "evictions",
                                            "rejected")},
                "digest": self.host_store.digest(),
            }
        snap["tiers"] = tiers
        return snap

    # -------------------------------------------------------- embeddings

    def embed_dispatch(self, prompt: np.ndarray) -> torch.Tensor:
        """Enqueue one prompt's pooled-embedding forward at its prefill
        bucket (the prefill's row tiles included) and return the ``(E,)``
        f32 vector on the device WITHOUT fetching it: the scheduler fetches
        a wave of them at once."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size == 0:
            raise GraphUnitError("empty prompt")
        padded = self._h2d(self._padded(prompt))
        with self._lock, torch.no_grad():
            vec = llama.embed_pooled(self.params, padded, int(prompt.size), self.cfg,
                                     seq_impl=self.seq_impl, op=self._prefill_op)
            self.embeds += 1
        return vec

    def embed_fetch(self, vecs: list[torch.Tensor]) -> np.ndarray:
        """ONE device->host fetch for a wave of :meth:`embed_dispatch`
        vectors -> ``(n, E)`` float32."""
        out = torch.stack(vecs).cpu().numpy()
        with self._lock:
            self.embed_fetches += 1
        return out

    def embed(self, prompt: np.ndarray) -> np.ndarray:
        """One prompt's mean-pooled final hidden state, ``(E,)`` float32."""
        return self.embed_fetch([self.embed_dispatch(prompt)])[0]

    # ------------------------------------------------------------ decode

    def _window_for(self, active: np.ndarray, extra: int) -> int:
        """Smallest power-of-two window (min 64, capped at max_seq) covering
        every ACTIVE slot's position ceiling after ``extra`` more tokens (a
        speculative block asks for ``k * (1 + spec_draft)`` rows)."""
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

    def _block_buffers(self) -> None:
        """The static buffers of the decode blocks, allocated once, outside
        any graph capture: the inputs ``(4, S)`` int32 (tokens, active, eos,
        remaining) and the temperatures; the final carry, laid out as the
        inputs, so that a continued block's inputs are one device copy;
        per ``k`` the ``(2, rows, S)`` int32 tokens and mask (``(3, rows,
        S)`` with ``conf_signal``: the f32 margins ride as a third plane of
        their bits) and two host buffers they are copied into (pinned on
        the card), one per block in flight, so a continued block never
        overwrites the outputs of the block before it is fetched."""
        S, dev = self.n_slots, self.device
        self._gin = torch.zeros(4, S, dtype=torch.int32, device=dev)
        self._gtemps = torch.zeros(S, dtype=torch.float32, device=dev)
        self._gcarry = torch.zeros(4, S, dtype=torch.int32, device=dev)
        self._gout: dict[int, torch.Tensor] = {}
        self._hout: dict[int, list[torch.Tensor]] = {}
        self._hnext = 0
        self._carried = False  # _gcarry holds a block's carry

    def _out_buffers(self, k: int) -> None:
        if k not in self._gout:
            shape = (2 + int(self.conf_signal), k * self._tps, self.n_slots)
            self._gout[k] = torch.zeros(shape, dtype=torch.int32, device=self.device)
            pin = self.device.type == "cuda"
            self._hout[k] = [torch.zeros(shape, dtype=torch.int32, pin_memory=pin)
                             for _ in range(2)]

    def _block_body(self, k: int, window: int) -> None:
        """``k`` decode steps (or verify passes) for every slot, from the
        static inputs to the static outputs: the body a graph captures and
        the eager loop runs.  ``eos`` (-1 = none) and the remaining budgets
        are enforced on the device, so a slot stops writing the pool the
        step it finishes."""
        tok, act, eos_t, rem = self._gin[0], self._gin[1].bool(), self._gin[2], self._gin[3]
        temps, gen = self._gtemps, self._gen
        toks_seq, act_seq, conf_seq = [], [], []
        for _ in range(k):
            if self.spec_draft:
                out, emitted, tok, act, rem, margin = self._verify_pass(
                    tok, act, rem, temps, gen, eos_t, window)
                toks_seq.append(out.T)
                act_seq.append(emitted.T)
                if margin is not None:
                    conf_seq.append(margin.T)
                continue
            logits, _ = llama.decode_slots_paged(
                self.params, tok, self._cache, act, self.cfg, window=window,
                kernel=self.decode_kernel, lora=self._lora, adapter_ids=self._gaid,
            )
            new = llama.sample_tokens(logits, temps, gen, self.top_k)
            if self.conf_signal:
                conf_seq.append(_conf_margin(logits)[None])
            new = torch.where(act, new, tok)
            rem = torch.where(act, rem - 1, rem)
            done = (new == eos_t) | (rem <= 0)
            toks_seq.append(new[None])
            act_seq.append(act[None])
            tok, act = new, act & ~done
        planes = [torch.cat(toks_seq), torch.cat(act_seq).to(torch.int32)]
        if conf_seq:
            planes.append(torch.cat(conf_seq).contiguous().view(torch.int32))
        self._gout[k].copy_(torch.stack(planes))
        self._gcarry.copy_(torch.stack([tok, act.to(torch.int32), eos_t, rem]))

    def _counter_rows(self) -> int:
        """Split counters the body's paged-attention launches use at most."""
        rows = paged_attention.counter_rows(self.n_slots, self._tps, self.cfg.n_heads,
                                            self.cfg.n_kv_heads)
        if self._draft_cfg is not None:
            rows = max(rows, paged_attention.counter_rows(
                self.n_slots, 1, self._draft_cfg.n_heads, self._draft_cfg.n_kv_heads))
        return rows

    def _graph(self, k: int, window: int) -> dict | None:
        """The CUDA graph of a ``k``-step block over ``window`` (captured
        at first use: :meth:`warmup` captures every window bucket), or None
        on the CPU and on the eager yardstick."""
        if self.device.type != "cuda" or self._eager_on_card:
            return None
        key = (k, window) + self._program_config
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(k, window)
            self.program_compiles += 1
            self._note_capture(f"decode k={k} window={window}", entry["capture_s"])
        else:
            self.program_hits += 1
        return entry

    def _note_capture(self, label: str, seconds: float) -> None:
        """Count a capture in ``seldon_program_compiles``; one after warmup
        (a request paid for it) also records a ``program.compile`` span."""
        DEFAULT_METRICS.program_compiles.labels(self.name).inc()
        if not self._in_warmup:
            RECORDER.record_span("program.compile", trace_id=make_trace_id(), parent_id=None,
                                 start=time.time() - seconds, duration_s=seconds,
                                 service=self.name,
                                 attrs={"variant": label, "model": self.name})
            log.warning("generative model %r: capture after warmup, %s (%.3f s)",
                        self.name, label, seconds)

    def _capture(self, k: int, window: int) -> dict:
        """Capture the block body for ``(k, window)``.  The body runs once
        eagerly first, on the capture stream with every slot inactive (it
        writes the sink block only), so that kernels are loaded and library
        workspaces and paged attention's split counters exist outside the
        graph; the capture itself runs nothing.  Every graph shares one
        memory pool: their intermediates die inside a replay and replays
        never overlap.  The sampler is registered with every graph, so a
        replay draws from its current seed and offset as an eager block
        would.  The capture section (the process-wide lock, the garbage
        collector paused) is held from the warm-up run to the last sync,
        since the syncs and the emptied allocator cache around a capture
        would invalidate another thread's.  Returns the
        graph, its kernel launches per replay, the capture's seconds and
        the pool bytes it added."""
        dev = self.device
        self._out_buffers(k)
        with capture_section():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(dev)
            stream = self._capture_stream
            saved = self._gcarry.clone()  # the warm-up run must not clobber a live carry
            self._gin.zero_()  # every slot inactive
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                paged_attention.reserve_counters(dev, self._counter_rows())
                self._block_body(k, window)
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self._gen)
            torch.cuda.empty_cache()  # as the capture does first: the pool's bytes are the delta
            reserved = torch.cuda.memory_reserved(dev)
            snap = _build.snapshot_launches()
            try:
                with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self._block_body(k, window)
            finally:
                launches = _build.take_captured(snap)
            if self._graph_pool is None:
                self._graph_pool = graph.pool()
            self._gcarry.copy_(saved)
            torch.cuda.synchronize(dev)
            return {"graph": graph, "launches": launches,
                    "capture_s": time.perf_counter() - t0,
                    "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}

    def _launch_block(self, entry: dict | None, k: int, seed: int, act_np: np.ndarray,
                      window: int) -> tuple:
        """Run one block from the static inputs (a replay of ``entry``, else
        the eager body), enqueue the copy of its tokens and mask into the
        next host buffer and return the block's handle."""
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        start = end = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self._gen.manual_seed(int(seed))
        if entry is None:
            self._block_body(k, window)
        else:
            entry["graph"].replay()
            _build.add_launches(entry["launches"])
        host = self._hout[k][self._hnext]
        self._hnext ^= 1
        host.copy_(self._gout[k], non_blocking=cuda)
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._carried = True
        self._pos_ceiling[act_np] += k * self._tps
        self.steps += k
        return (host, start, end, time.perf_counter() - t0, act_np, k)

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
        the pool the step it finishes.  One host fetch per call:
        :meth:`step_k_dispatch`, then :meth:`step_k_fetch`.

        With speculation on each step is a verify pass (:meth:`_verify_pass`)
        and the results have ``k * (1 + spec_draft)`` rows, pass by pass,
        with the EMITTED mask in place of the was-active mask; the position
        ceiling assumes every row at dispatch and is tightened to what the
        fetched mask says landed."""
        return self.step_k_fetch(self.step_k_dispatch(
            tokens, active, temperature, seed, eos, remaining, k, window=window))

    def step_k_dispatch(
        self,
        tokens: np.ndarray,
        active: np.ndarray,
        temperature: np.ndarray,
        seed: int,
        eos: np.ndarray,
        remaining: np.ndarray,
        k: int,
        window: int | None = None,
    ) -> tuple:
        """Enqueue one ``k``-step block from host arrays WITHOUT fetching its
        tokens: the inputs are copied into the static buffers, the block's
        graph is replayed (the body runs eagerly on the CPU), the copy of
        its outputs to a host buffer is enqueued behind it, and a handle
        for :meth:`step_k_fetch` comes back."""
        act_np = np.asarray(active, bool).copy()
        k = int(k)
        window = window or self._window_for(act_np, k * self._tps)
        packed = np.stack([
            np.asarray(tokens, np.int32), act_np.astype(np.int32),
            np.asarray(eos, np.int32), np.asarray(remaining, np.int32),
        ])
        with self._lock, torch.no_grad():
            self._out_buffers(k)
            entry = self._graph(k, window)
            # pageable host memory is staged at once: no wait on queued work
            self._gin.copy_(torch.from_numpy(packed), non_blocking=True)
            self._gtemps.copy_(torch.from_numpy(np.asarray(temperature, np.float32)),
                               non_blocking=True)
            if self._lora is not None:  # bindings change only at sync points
                self._gaid.copy_(torch.from_numpy(self._slot_aidx), non_blocking=True)
            return self._launch_block(entry, k, seed, act_np, window)

    def step_k_continue(self, active: np.ndarray, seed: int, k: int,
                        window: int | None = None) -> tuple:
        """Enqueue the next ``k``-step block from the previous block's device
        carry (tokens, active mask, eos and budgets: one device copy, no
        host round trip; the adapter ids stay as dispatched).  The caller
        guarantees that no host-side state changed since that block was
        dispatched (no admission, no reap, no release of a pinned slot); a
        slot that finished inside it rides along inactive.  Stream order puts the previous block's copy to the
        host before this block's replay."""
        act_np = np.asarray(active, bool).copy()
        k = int(k)
        window = window or self._window_for(act_np, k * self._tps)
        with self._lock, torch.no_grad():
            if not self._carried:
                raise RuntimeError(f"generative model {self.name!r}: decode continue without "
                                   "a carried block")
            self._out_buffers(k)
            entry = self._graph(k, window)
            self._gin.copy_(self._gcarry)
            handle = self._launch_block(entry, k, seed, act_np, window)
            self.overlapped += 1
            return handle

    def step_k_fetch(self, handle: tuple) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched block and return its ``(rows, S)`` tokens
        and mask (``rows = k`` plain, ``k * (1 + spec_draft)`` speculative):
        THE one host sync of the block, counted whatever the pipeline did.
        With ``conf_signal`` the block's margins came in the same copy and
        are stashed in :attr:`last_conf_seq`."""
        host, start, end, seconds, act_np, k = handle
        if end is not None:
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3  # the block on the card
        out = host.numpy().copy()  # the buffer serves the block after next
        tps = self._tps
        self.last_conf_seq = out[2].view(np.float32) if self.conf_signal else None
        emitted_n = int(out[1].sum())
        with self._lock:
            self.host_syncs += 1
            self.decode_blocks += 1
            self.last_block_s = seconds
            self.block_seconds += seconds
            RECORDER.record_stage(STAGE_DEVICE_STEP, seconds)
            self.tokens_emitted += emitted_n
            if self.spec_draft and act_np.any():
                emitted = out[1].sum(axis=0).astype(np.int64)
                self._pos_ceiling[act_np] -= k * tps - emitted[act_np]
                # productive passes only: a slot that finished mid-block
                # rides the rest of it inactive, as in the plain path
                productive = int(out[1].reshape(k, tps, -1).any(axis=1).sum())
                self.spec_emitted_tokens += int(emitted.sum())
                self.spec_verify_passes += productive
                self._note_spec(int(emitted.sum()), productive)
        # the metric sinks: host values of this one fetch, no other sync
        record_host_sync(self.name)
        self._m_device_step.observe(seconds)
        if emitted_n and seconds > 0 and self._peak_flops:
            self._m_mfu.set(emitted_n * self.flops_per_token / seconds / self._peak_flops)
        return out[0], out[1].astype(bool)

    def _note_spec(self, emitted: int, passes: int) -> None:
        """The acceptance ledger's families, plain and by proposer."""
        m, name = DEFAULT_METRICS, self.name
        method = self.spec_method or "ngram"
        ratio = self.spec_emitted_tokens / max(1, self.spec_verify_passes)
        m.spec_emitted.labels(name).inc(emitted)
        m.spec_verify_passes.labels(name).inc(passes)
        m.spec_accepted_per_step.labels(name).set(ratio)
        m.spec_emitted_by_method.labels(name, method).inc(emitted)
        m.spec_verify_passes_by_method.labels(name, method).inc(passes)
        m.spec_accepted_per_step_by_method.labels(name, method).set(ratio)

    def note_itl(self, seconds: float) -> None:
        """One inter-token-latency sample (the scheduler's delivery)."""
        self._m_itl.observe(seconds)

    def program_snapshot(self) -> dict:
        """The decode-block programs: captures, replays of a cached graph,
        blocks continued from a carry, and each graph's capture seconds,
        pool bytes and kernel launches per replay."""
        with self._lock:
            graphs = [{"k": key[0], "window": key[1], "capture_s": e["capture_s"],
                       "pool_bytes": e["pool_bytes"], "launches": dict(e["launches"][0])}
                      for key, e in sorted(self._graphs.items(), key=lambda kv: kv[0][:2])]
            return {"program_compiles": self.program_compiles,
                    "program_hits": self.program_hits, "overlapped": self.overlapped,
                    "graphs": graphs}

    # ------------------------------------------------------ warmup/reset

    def warmup(self) -> int:
        """Run every prefill bucket, one suffix prefill when prefix reuse or
        chunking is on, and one decode block per window bucket once (the
        kernel build, the allocator and cuBLAS handles are then off the
        request path; on the card each of those blocks captures its CUDA
        graph, so no request pays for a capture).  With speculation on the
        blocks are verify passes and, for ``draft``, each admission
        prefills the draft pool too; with ``embed`` each bucket also runs
        one pooled-embedding forward.  A no-op once traffic has touched the
        cache."""
        with self._lock:
            if self.prefills or self.steps:
                return 0
            self._in_warmup = True
            try:
                return self._warmup_locked()
            finally:
                self._in_warmup = False

    def _warmup_locked(self) -> int:
        n = 0
        # the decode blocks first: a capture empties the allocator's
        # cache, which the prefills then fill again before traffic
        S = self.n_slots
        for w in self._window_buckets():
            self.step_k(
                np.zeros(S, np.int32), np.zeros(S, bool), np.zeros(S, np.float32), 0,
                np.full(S, -1, np.int32), np.zeros(S, np.int32), self.decode_block,
                window=w,
            )
            n += 1
        for b in self.prefill_buckets:
            self.admit(0, np.ones(b, np.int32), 0.0, 0)
            n += 1
        if self.embed_enabled:
            self.embed_fetch([self.embed_dispatch(np.ones(b, np.int32))
                              for b in self.prefill_buckets])
            n += len(self.prefill_buckets)
        if self.prefix_index is not None or self.prefill_chunk:
            bs = self.kv_block_size
            row = self.reserve_blocks(0, 2 * bs)
            self._exec_prefill_suffix(self._with_hist(
                self._suffix_payload(np.ones(bs, np.int32), bs, 2 * bs, 0, row, 0.0, 0),
                np.ones(2 * bs, np.int32)))
            n += 1
        self.reset()
        if self.prefix_index is not None:  # warmup's hits are not traffic
            self.prefix_index = PrefixIndex(self.kv_block_size)
        if self.host_store is not None:
            self.host_store = HostPrefixStore(self.kv_block_size, self._dram_bytes,
                                              on_bytes=self._note_dram_bytes)
        self._zero_tier_counters()
        self.prefills = self.steps = self.decode_blocks = self.host_syncs = 0
        self.prefills_reused = self.prefill_chunks = 0
        self.tokens_emitted, self.block_seconds = 0, 0.0
        self.spec_emitted_tokens = self.spec_verify_passes = self.draft_prefills = 0
        self.embeds = self.embed_fetches = 0
        self._blocks_high_water = 0
        return n

    def reset(self) -> None:
        """Zero every slot position, reclaim every reservation and empty the
        prefix index (every entry is unreferenced once the slots are) and
        the DRAM tier."""
        with self._lock:
            self._pos_ceiling[:] = 0
            for slot in list(self._slot_blocks):
                self.release_slot(slot)
            if self.prefix_index is not None:
                self._free_blocks.extend(self.prefix_index.flush())
            if self.host_store is not None:  # demoted chains must not outlive a reset
                self.host_store.flush()
            self._peer_chains.clear()
            self._cache["pos"].zero_()
            self._carried = False


@dataclasses.dataclass(eq=False)  # identity eq: fields hold arrays/futures
class _Request:
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    future: asyncio.Future
    out: list[int] = dataclasses.field(default_factory=list)
    t0: float = 0.0
    # a handoff's prefill half: prefill, pin the slot, resolve (slot, token)
    prefill_only: bool = False
    # a handoff's decode half: the first token and the blocks to import
    imported: dict | None = None
    # fired per delivered token on the event loop; a hook that raises is
    # logged and detached
    on_token: Callable[[int], None] | None = None
    # a pooled-embedding request: no slot, no KV; served in a wave at a
    # sync point and resolved with its (E,) vector
    embed_only: bool = False
    # the cascade's confidence: the sum and count of the top-2 margins of
    # the decode tokens delivered to this request
    conf_sum: float = 0.0
    conf_n: int = 0
    # the named LoRA adapter the request decodes through (None: the base
    # model, the pool's null row)
    adapter: str | None = None
    # QoS: the priority class and the absolute time.monotonic() deadline
    # (None: no SLO), read from the request's context at submit
    priority: str = qos.PRIO_INTERACTIVE
    deadline: float | None = None
    # the outcome went to the usage meter (exactly once)
    metered: bool = False
    # forensics: the request's timeline entry (obs/timeline.py) and the
    # live span it was submitted under, the first terminal reason (eos,
    # budget, ...), the last delivery (the inter-token latency), and the
    # device seconds and prefix tokens it was charged
    timeline: Any = None
    span: Any = None
    done_reason: str | None = None
    t_last_tok: float = 0.0
    u_device_s: float = 0.0
    u_saved_tokens: int = 0
    u_saved_tier: str = "none"


class GenerationScheduler:
    """Continuous-batching front: admits queued requests into free slots at
    each sync point (between decode blocks), runs blocks, delivers tokens
    and reaps finished slots.  The intake is bounded (``maxsize``,
    default 256): overflow raises :class:`QueueFull`.

    With the model's ``prefill_chunk`` on, an admission whose prompt is
    longer than a chunk arrives while decode streams are live is paced:
    one chunk per sync point (``chunks_paced`` counts the chunks dispatched
    while streams were live), so a long
    prompt delays the live streams by one chunk per decode block, not by
    its whole prefill.  An idle scheduler admits it at once.  Each sync
    point costs at most one host fetch for all the first tokens it
    produced; intermediate chunks' tokens are never fetched.

    A request may name a LoRA adapter (``adapter=``): its slot is bound to
    the adapter's pool row at admission and released with it, and the
    tokens its decode blocks deliver tick the adapter's ledger.

    QoS, from the request's context (``qos/context.py``): a ``batch``
    request may fill only half the intake (``_batch_cap``); the queue pops
    interactive requests first, then by arrival; a request whose deadline
    passes fails with :class:`DeadlineExceeded` at the next sync point,
    from the queue before a prefill is spent on it, between two prefill
    chunks, or mid-decode (its slot is reaped; the tokens the block in
    flight still makes for it are dropped).  The active admission
    controller's brownout clamps ``max_new_tokens`` at submit.  Every
    request's prefill, decode tokens, share of each block's device
    seconds and outcome go to the usage meter (``obs/metering.py``).

    Pooled-embedding requests (:meth:`submit_embed`) ride the same bounded
    intake but take no slot: the waiting ones are served as one wave at
    the next sync point, with one host fetch for the wave.  With the
    model's ``conf_signal`` on, each request's decode tokens carry their
    top-2 logit margins (fetched with the block), summed per request
    (``info["confidence"]`` of :meth:`submit`).

    The two halves of a handoff between engines enter here too:
    :meth:`submit_prefill` prefills into a slot that stays PINNED (out of
    admission, its blocks unreclaimable) until :meth:`release_external`
    returns it, and :meth:`submit_imported` admits another engine's
    prompt KV and decodes it.  Imports, releases of pinned slots and
    peer-pulled prefix installs (:meth:`install_prefix`) all happen at a
    sync point, never while a decode block is in flight.

    On a packed card (:meth:`attach_arbiter`) every device call of the run
    loop runs under the arbiter's grant, taken at a sync point and given
    back once the pipeline drains to the next, on a park and on every
    error path; a holder whose co-tenant waits yields at the next block.
    :meth:`request_preempt` (the arbiter's verb) and :meth:`drain_begin`
    suspend the active slots at the next sync point into the suspend store
    and hold admissions; :meth:`request_resume` and :meth:`drain_finish`
    re-queue the records as imports of the original requests (their
    ``t0`` keeps their place), which continue bit-exactly: no seed is drawn
    while a stream is parked, and the carry token is not delivered twice.
    A drain's records can instead go to a peer (:meth:`drain_take`,
    :meth:`complete_migrated`, :meth:`drain_abort`).

    The pipeline overlaps (``overlap``, on by default when ``decode_block
    > 1``; ``SCT_GEN_OVERLAP=0`` turns it off): while block N's tokens are
    fetched, block N+1 is already dispatched from block N's device carry
    (:meth:`GenerativeModel.step_k_continue`).  The chain breaks for a
    named cause (``overlap_breaks``): ``carry-dirty`` (a host-side reap
    left the carry stale), ``arbiter-yield`` (a co-tenant waits for the
    grant, or a preemption or drain is due), ``admission`` (a request
    waits), ``kv-starved``
    (an admission waits for blocks), ``handoff-release`` (a pinned slot
    goes back to the pool), ``chunked-prefill`` (a chunk is due) or
    ``dispatch-error``.  Either way each block costs one host sync."""

    def __init__(self, model: GenerativeModel, *, maxsize: int | None = None,
                 overlap: bool | None = None):
        self.model = model
        if overlap is None:
            overlap = os.environ.get("SCT_GEN_OVERLAP", "1") != "0"
        self.overlap = bool(overlap) and model.decode_block > 1
        self.overlap_breaks: collections.Counter = collections.Counter()
        # requests failed with DeadlineExceeded, by where they were
        # ("generation-queue", "prefill", "decode")
        self.deadline_reaps: collections.Counter = collections.Counter()
        self._waiting: list[_Request] = []
        # admitted to a slot but not to the KV pool (OutOfKVBlocks): retried
        # ahead of the queue as completions free blocks
        self._overflow: list[_Request] = []
        # chunked admissions in progress, oldest first:
        # {"req", "slot", "plan", "i": next chunk}
        self._prefilling: list[dict] = []
        self.chunks_paced = 0
        # slots pinned by submit_prefill, their pending releases, and the
        # peer-pulled chains waiting for a sync point
        self._external: set[int] = set()
        self._external_release: list[int] = []
        self._prefix_installs: list[tuple[dict, asyncio.Future]] = []
        self._maxsize = (int(maxsize) if maxsize is not None
                         else int(os.environ.get("SCT_GEN_QUEUE_MAX", "256")))
        self._batch_cap = max(1, self._maxsize // 2) if self._maxsize else 0
        # slot -> the request reaped from it while a block may still be in
        # flight: the tokens that block makes for it are wasted
        self._reaped_rows: dict[int, _Request] = {}
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._closed = False
        # (prompt length, seconds from submit to first token) per request
        self.ttft: collections.deque[tuple[int, float]] = collections.deque(maxlen=4096)
        # random base so sampled streams differ across restarts; within one
        # process the sequence is deterministic
        self._seed = int.from_bytes(os.urandom(4), "little")
        # chip packing: the device arbiter this scheduler's device work runs
        # under (None: a sole tenant), the preemption and drain flags, the
        # generations parked in the suspend store, and the queue-wait EWMA
        # the arbiter reads as pressure
        self._arbiter = None
        self._arb_key: str | None = None
        self._arb_draft_key: str | None = None  # a draft model's prefills
        self._preempt = False
        self._draining = False
        self._quiesced = asyncio.Event()
        self._suspended: list[dict] = []
        self._suspend_store: SuspendStore | None = None
        self._suspend_seq = 0
        self._qwait_ewma: float | None = None
        self._qwait_stamp = 0.0
        self.suspends = 0
        self.resumes = 0
        self.suspend_rejected = 0
        self.drains = 0
        self.drained_out = 0

    def _next_seed(self) -> int:
        self._seed = (self._seed + 1) % (2**31 - 1)
        return self._seed

    def _ensure_run_task(self) -> None:
        """(Re)spawn the run loop on the CURRENT event loop, with a fresh
        wake event bound to it."""
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(self._run())

    def _validate_prompt(self, prompt) -> np.ndarray:
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
        return prompt

    async def _enqueue(self, req: _Request):
        """Queue ``req`` (bounded intake, a batch request to half of it) and
        wait for its future."""
        depth = len(self._waiting) + len(self._overflow)
        cap = self._maxsize if req.priority == qos.PRIO_INTERACTIVE else self._batch_cap
        if self._maxsize and depth >= cap:
            self._meter_end(req, "shed")
            self._note_shed(req.priority, depth, cap)
            raise QueueFull(f"generation queue is full ({depth} waiting, cap {cap} "
                            f"for {req.priority})")
        self._ensure_run_task()
        self._begin_tl(req, "prefill" if req.prefill_only else "embed" if req.embed_only
                       else "imported" if req.imported is not None else "generate")
        self._tl(req, "queued", span=False, depth=len(self._waiting))
        self._waiting.append(req)
        self._wake.set()
        try:
            return await req.future
        except asyncio.CancelledError:
            # the client is gone: withdraw before a slot is spent (in-slot
            # requests are reaped by the run loop via the cancelled future)
            for q in (self._waiting, self._overflow):
                if req in q:
                    q.remove(req)
                    self._meter_end(req, "reaped")
                    self._end_tl(req, "disconnect", stage="queue")
            raise

    # -- lifecycle timelines (obs/timeline.py): every event is stamped from
    # values the host already holds; nothing here reads a device tensor

    def _begin_tl(self, req: _Request, kind: str = "generate") -> None:
        req.timeline = TIMELINE.begin(
            current_trace_id(), model=self.model.name, kind=kind,
            prompt_tokens=int(req.prompt.size), max_new_tokens=int(req.max_new_tokens),
            priority=req.priority)

    def _tl(self, req: _Request, name: str, span: bool = True, **attrs) -> None:
        """One lifecycle event on the request's timeline and, bounded, on the
        span it was submitted under."""
        if req.timeline is not None:
            req.timeline.event(name, **attrs)
        if span and req.span is not None and len(req.span.span.events) < 256:
            req.span.event(name, **attrs)

    def _end_tl(self, req: _Request, reason: str, **attrs) -> None:
        """The terminal event (the first reason wins), with what the
        request spent."""
        if req.done_reason is None:
            req.done_reason = reason
        usage = {"device_ms": round(req.u_device_s * 1e3, 3),
                 "tokens_in": int(req.prompt.size), "tokens_out": len(req.out)}
        if req.u_saved_tokens:
            usage.update(tokens_saved=int(req.u_saved_tokens), saved_tier=req.u_saved_tier)
        attrs["usage"] = usage
        if req.timeline is not None:
            req.timeline.end(reason, **attrs)
        if req.span is not None and len(req.span.span.events) < 256:
            req.span.event("terminal", reason=reason, **attrs)

    def _finish_tl(self, req: _Request) -> None:
        """A completed request's terminal event, after the event that
        delivered its last token."""
        self._end_tl(req, req.done_reason or "budget", tokens=len(req.out))

    def _note_shed(self, priority: str, depth: int, cap: int) -> None:
        """A queue shed leaves a terminal-only timeline entry."""
        tl = TIMELINE.begin(current_trace_id(), model=self.model.name, priority=priority)
        if tl is not None:
            tl.end("shed", depth=depth, cap=cap,
                   usage={"device_ms": 0.0, "tokens_in": 0, "tokens_out": 0})

    def _deadline_miss(self, req: _Request, stage: str) -> None:
        """Count a deadline reap at ``stage`` (``generation-queue``,
        ``prefill``, ``decode``, ``suspended``)."""
        self.deadline_reaps[stage] += 1
        qos.note_deadline_miss(stage, req.priority)
        DEFAULT_METRICS.qos_deadline_miss.labels(self.model.name, stage).inc()
        if req.span is not None:
            req.span.event("qos-drop", reason="deadline", stage=stage)

    def _meter_end(self, req: _Request, outcome: str) -> None:
        """Fold a request's outcome (``completed``, ``shed`` or ``reaped``:
        a deadline, a disconnect or an error) into the usage meter, once.
        A reaped request's delivered tokens count as wasted.  An embed has
        no outcome of its own (it serves another request, or one row of an
        ``/embeddings`` call)."""
        if req.metered or req.embed_only:
            return
        req.metered = True
        key = (self.model.name, req.adapter or "", req.priority)
        if outcome == "reaped":
            METER.add(*key, requests_reaped=1, tokens_wasted=len(req.out))
        else:
            METER.add(*key, **{f"requests_{outcome}": 1})

    def _meter_admit(self, req: _Request, slot: int) -> None:
        """An admission's prefill: the prompt tokens prefilled on the device
        and the prefix tokens a tier spared."""
        saved, tier = self.model.reservation_saved(slot)
        saved = min(saved, int(req.prompt.size))
        fields = {"tokens_prefill": int(req.prompt.size) - saved}
        if saved and tier != "none":
            fields[f"tokens_saved_{tier}"] = saved
            req.u_saved_tokens += saved
            req.u_saved_tier = tier
        METER.add(self.model.name, req.adapter or "", req.priority, **fields)

    def overlap_snapshot(self) -> dict:
        """Whether the pipeline overlaps, the blocks continued from a
        carry, and the breaks of the chain by cause."""
        return {"overlap": self.overlap, "overlapped": self.model.overlapped,
                "breaks": dict(self.overlap_breaks)}

    def _request(self, prompt, max_new_tokens, temperature, eos_id, **kw) -> _Request:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        return _Request(prompt, int(max_new_tokens), float(temperature), eos_id, fut,
                        t0=time.perf_counter(), priority=qos.get_priority(),
                        deadline=qos.get_deadline(), span=current_span(), **kw)

    async def submit(
        self,
        prompt: np.ndarray,
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: int | None = None,
        on_token: Callable[[int], None] | None = None,
        info: dict | None = None,
        adapter: str | None = None,
    ) -> np.ndarray:
        """Generate up to ``max_new_tokens`` ids for a 1-D prompt, through
        the resident LoRA ``adapter`` when one is named.
        ``on_token`` fires on the event loop for each token as it is
        delivered (the first at admission, then one decode block's at a
        time).  ``info``, an out-parameter, gets ``confidence`` (the mean
        top-2 logit margin over the delivered decode tokens; the prefill's
        first token carries none) and ``conf_tokens`` on completion when
        the model's ``conf_signal`` is on."""
        prompt = self._validate_prompt(prompt)
        if max_new_tokens < 1:
            return np.zeros(0, np.int32)
        max_new_tokens = min(int(max_new_tokens), self.model.cfg.max_seq - int(prompt.size))
        # a brownout shortens answers before it refuses them
        max_new_tokens = qos.clamp_max_new_tokens(max_new_tokens)
        req = self._request(prompt, max_new_tokens, temperature, eos_id, on_token=on_token,
                            adapter=adapter or None)
        out = await self._enqueue(req)
        if info is not None and req.conf_n:
            info["confidence"] = req.conf_sum / req.conf_n
            info["conf_tokens"] = req.conf_n
        return out

    async def submit_embed(self, prompt: np.ndarray) -> np.ndarray:
        """A prompt's mean-pooled final hidden state, ``(E,)`` float32: the
        request rides the bounded intake, takes no slot and no KV, and is
        served with the other waiting ones at the next sync point."""
        prompt = self._validate_prompt(prompt)
        return await self._enqueue(self._request(prompt, 1, 0.0, None, embed_only=True))

    async def _admit_embeds(self, reqs: list[_Request]) -> None:
        """Serve one wave of embed requests: every forward is dispatched,
        then ONE host fetch brings the wave's vectors back; a bad prompt
        fails alone."""

        def dispatch_and_fetch():
            placed, errors = [], []
            for req in reqs:
                try:
                    placed.append((req, self.model.embed_dispatch(req.prompt)))
                except Exception as exc:  # noqa: BLE001 - routed to the future
                    errors.append((req, exc))
            try:
                vecs = self.model.embed_fetch([v for _, v in placed]) if placed else []
            except Exception as exc:  # noqa: BLE001 - fails the wave, not the loop
                errors += [(req, exc) for req, _ in placed]
                placed, vecs = [], []
            return placed, errors, vecs

        t0 = time.perf_counter()
        placed, errors, vecs = await asyncio.to_thread(dispatch_and_fetch)
        wave_s = time.perf_counter() - t0  # the wave's wall time ends in its one fetch
        wave_toks = sum(int(r.prompt.size) for r, _ in placed) or 1
        for (req, _), vec in zip(placed, vecs):
            n = int(req.prompt.size)
            req.u_device_s += wave_s * n / wave_toks
            METER.add(self.model.name, req.adapter or "", req.priority,
                      device_s=wave_s * n / wave_toks, tokens_prefill=n)
            self._tl(req, "embed", tokens=n)
            if not req.future.done():
                req.future.set_result(vec)
            self._end_tl(req, "embedded", dim=int(vec.shape[-1]))
        for req, exc in errors:
            if not req.future.done():
                req.future.set_exception(exc)
            self._end_tl(req, "error", stage="embed")

    async def submit_prefill(self, prompt: np.ndarray, *, temperature: float = 0.0,
                             adapter: str | None = None) -> tuple[int, int]:
        """A handoff's prefill half: prefill ``prompt`` (through ``adapter``)
        into a free slot and return ``(slot, first_token)`` without
        decoding.  The slot stays PINNED until :meth:`release_external`
        returns it, so its blocks can be exported at leisure and a failed
        handoff leaks nothing."""
        prompt = self._validate_prompt(prompt)
        return await self._enqueue(self._request(prompt, 1, temperature, None,
                                                 prefill_only=True, adapter=adapter or None))

    async def submit_imported(
        self, prompt: np.ndarray, *, first_token: int, k, v, max_new_tokens: int = 32,
        temperature: float = 0.0, eos_id: int | None = None, k_scale=None, v_scale=None,
        spec_state: dict | None = None, on_token: Callable[[int], None] | None = None,
        adapter: str | None = None,
    ) -> np.ndarray:
        """A handoff's decode half: go on with a generation whose prompt KV
        (``k``/``v``, and an int8 pool's scales) and first sampled token
        another engine made, through ``adapter`` when the KV was made
        through one.  The blocks are imported at the next sync point; the
        result, the first token included, is what a unified engine returns
        for the same request."""
        prompt = self._validate_prompt(prompt)
        max_new_tokens = qos.clamp_max_new_tokens(min(
            max(1, int(max_new_tokens)), self.model.cfg.max_seq - int(prompt.size)))
        return await self._enqueue(self._request(
            prompt, max_new_tokens, temperature, eos_id,
            imported={"first_token": int(first_token), "k": k, "v": v, "k_scale": k_scale,
                      "v_scale": v_scale, "spec": spec_state},
            on_token=on_token, adapter=adapter or None,
        ))

    def release_external(self, slot: int) -> None:
        """Return a :meth:`submit_prefill`-pinned slot; the release runs at
        the next sync point (idempotent there)."""
        self._external_release.append(int(slot))
        if self._wake is not None:
            self._wake.set()

    def _drain_external_releases(self) -> None:
        while self._external_release:
            slot = self._external_release.pop()
            self._external.discard(slot)
            self.model.release_slot(slot)

    async def install_prefix(self, tokens: np.ndarray, k, v, *, k_scale=None,
                             v_scale=None, adapter: str | None = None) -> int:
        """Install a peer-pulled prefix chain (made through ``adapter``) into
        the pool and the index at the next sync point; resolves to the
        chain levels installed."""
        if self._closed:
            raise RuntimeError("GenerationScheduler is closed")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._prefix_installs.append(({"tokens": tokens, "k": k, "v": v, "k_scale": k_scale,
                                       "v_scale": v_scale, "adapter": adapter}, fut))
        self._ensure_run_task()
        self._wake.set()
        return await fut

    async def _drain_prefix_installs(self) -> None:
        while self._prefix_installs:
            payload, fut = self._prefix_installs.pop(0)
            try:
                n = await asyncio.to_thread(
                    self.model.install_prefix_chain, payload["tokens"], payload["k"],
                    payload["v"], payload["k_scale"], payload["v_scale"], payload["adapter"],
                )
            except Exception as e:  # noqa: BLE001 - routed to the caller
                if not fut.done():
                    fut.set_exception(e)
                continue
            if not fut.done():
                fut.set_result(n)

    # ------------------------------------------------- chip packing (arbiter)
    #
    # The scheduler's side of time-sharing a card: the device grant covers
    # the device work of a sync point and the blocks chained from it until
    # their fetch; preemption and resume are verbs the arbiter calls, acted
    # on between blocks, never inside one.

    def attach_arbiter(self, arbiter, *, priority: str = qos.PRIO_INTERACTIVE,
                       slo_ms: float | None = None) -> None:
        """Join a packed card: register with ``arbiter`` under the model's
        name (the arbiter de-duplicates colliding names) and run every
        device call of the run loop under its grant.  With a draft model
        (``spec_method='draft'``) a second, batch-class registrant,
        ``"{name}/draft"``, covers its prompt prefills: they stop running
        inline at admission and drain at the next sync point under the
        draft grant, so an interactive co-tenant's blocks never queue
        behind draft warm-up work."""
        self._arbiter = arbiter
        self._arb_key = arbiter.register(self.model.name, scheduler=self,
                                         priority=priority, slo_ms=slo_ms)
        if self.model.spec_method == "draft":
            self._arb_draft_key = arbiter.register(f"{self.model.name}/draft",
                                                   scheduler=self, priority=qos.PRIO_BATCH)
            self.model.defer_draft_prefill = True

    def detach_arbiter(self) -> None:
        if self._arbiter is not None:
            if self._arb_draft_key is not None:
                self._arbiter.unregister(self._arb_draft_key)
                self._arb_draft_key = None
                self.model.defer_draft_prefill = False
            self._arbiter.unregister(self._arb_key)
            self._arbiter = None
            self._arb_key = None

    async def _drain_draft_prefills(self) -> None:
        """Run the deferred draft-model prefills under the batch-class
        draft grant (at a sync point only, never between a block's dispatch
        and its fetch, so the one-sync-a-block audit holds)."""
        if not self.model._pending_draft_prefill:
            return
        # local refs: close() detaches the arbiter concurrently with the run
        # loop, and the release must pair with the acquire made here
        arb, key = self._arbiter, self._arb_draft_key
        if arb is None or key is None:
            await asyncio.to_thread(self.model.drain_draft_prefills)
            return
        await arb.acquire(key)
        try:
            await asyncio.to_thread(self.model.drain_draft_prefills)
        finally:
            arb.release(key)

    async def _arb_acquire(self) -> None:
        if self._arbiter is not None:
            # _arb_release pairs it on every park, drain and error path
            await self._arbiter.acquire(self._arb_key)

    def _arb_release(self) -> None:
        # idempotent: a parked co-tenant must never wait on a scheduler that
        # is itself waiting
        if self._arbiter is not None:
            self._arbiter.release(self._arb_key)

    def _arb_contended(self) -> bool:
        return self._arbiter is not None and self._arbiter.contended(self._arb_key)

    def queue_pressure(self) -> float:
        """Deadline pressure in seconds: the larger of the queue-wait EWMA,
        decayed with a 1 s half-life, and the oldest live waiter's age.
        Host bookkeeping only: the arbiter reads it at grant edges."""
        now = time.perf_counter()
        oldest = max((now - r.t0 for r in self._waiting if not r.future.done()), default=0.0)
        ewma = 0.0
        if self._qwait_ewma is not None:
            # a drained burst's pressure fades instead of preempting
            # co-tenants forever
            ewma = self._qwait_ewma * (0.5 ** max(0.0, now - self._qwait_stamp))
        return max(ewma, oldest)

    def _note_queue_wait(self, req: _Request) -> None:
        """Fold one admission's queue wait into the EWMA.  A resumed suspend
        record is skipped: its ``t0`` is the original submission, so its
        suspension would read as queue pressure."""
        if req.imported is not None and req.imported.get("resumed"):
            return
        wait = max(0.0, time.perf_counter() - req.t0)
        e = self._qwait_ewma
        self._qwait_ewma = wait if e is None else 0.8 * e + 0.2 * wait
        self._qwait_stamp = time.perf_counter()

    def _wake_loop(self) -> None:
        if self._wake is not None:
            self._wake.set()

    def request_preempt(self) -> None:
        """Arbiter verb: suspend the active slots at the next sync point and
        hold admissions until resumed."""
        self._preempt = True
        self._wake_loop()

    def request_resume(self) -> None:
        """Arbiter verb: lift the preemption; the suspended records re-queue
        at the next sync point and resume bit-exactly."""
        self._preempt = False
        self._wake_loop()

    def _get_suspend_store(self) -> SuspendStore:
        if self._suspend_store is None:
            self._suspend_store = SuspendStore(suspend_budget_bytes(),
                                               on_bytes=self.model.note_suspend_bytes)
        return self._suspend_store

    def _park_record(self, req: _Request, frame: bytes) -> bool:
        """Put one suspend record in the store; False when it does not fit."""
        self._suspend_seq += 1
        key = (id(req), self._suspend_seq)
        if not self._get_suspend_store().put(key, frame):
            return False
        self._suspended.append({"req": req, "key": key, "bytes": len(frame),
                                "t_park": time.perf_counter()})
        return True

    async def _suspend_active(self, slots, active) -> int:
        """The preemption verb's device half, at a sync point with no block
        in flight: each active slot's KV (prompt and emitted tokens but the
        last) is exported as ONE handoff frame (int8 blocks and scales
        verbatim) into the suspend store, and the slot's blocks go back.
        The request stays alive (its future, its streaming hook); only its
        device residency is taken.  A record the store refuses leaves its
        slot running.  Returns the slots suspended."""
        from seldon_core_tpu_torch.disagg.handoff import encode_handoff

        victims = [i for i in range(len(slots))
                   if slots[i] is not None and active[i] and slots[i].out]
        if not victims:
            return 0
        for i in victims:
            self._tl(slots[i], EVENT_PREEMPT, victim=self.model.name)

        def export() -> list:
            frames = []
            for i in victims:
                req = slots[i]
                n = len(req.out)
                # the KV covers prompt + out[:-1] (the carry's KV is not
                # written yet); out[-1] rides as the frame's first token, so
                # the resume reserves (L + n - 1) + (max_new - n + 1): the
                # uninterrupted reservation
                hist = np.concatenate([req.prompt, np.asarray(req.out[:-1], np.int32)])
                try:
                    kv = self.model.export_slot_kv(i, int(hist.size))
                    ks, vs = (kv[2], kv[3]) if len(kv) == 4 else (None, None)
                    frames.append(encode_handoff(
                        hist, int(req.out[-1]), kv[0], kv[1],
                        block_size=self.model.kv_block_size,
                        max_new_tokens=req.max_new_tokens - n + 1,
                        temperature=req.temperature, eos_id=req.eos_id,
                        k_scale=ks, v_scale=vs, priority=req.priority,
                        adapter=req.adapter, spec_state=self.model.export_spec_state(i),
                    ))
                except Exception:  # noqa: BLE001 - the slot stays resident
                    log.exception("suspend export failed for slot %d; leaving it resident", i)
                    frames.append(None)
            return frames

        frames = await asyncio.to_thread(export)
        n_susp = 0
        for i, frame in zip(victims, frames):
            if frame is None:
                continue
            req = slots[i]
            if not self._park_record(req, frame):
                self.suspend_rejected += 1  # over the suspend budget: it keeps running
                self._tl(req, "suspend-rejected", bytes=len(frame))
                continue
            before = self.model.free_block_count
            self.model.release_slot(i)
            slots[i] = None
            active[i] = False
            self.suspends += 1
            n_susp += 1
            self._tl(req, EVENT_SUSPEND, victim=self.model.name, tokens=len(req.out),
                     blocks_freed=self.model.free_block_count - before, bytes=len(frame))
        return n_susp

    def _meter_unpark(self, rec: dict) -> None:
        """Charge a record's bytes x seconds parked as it leaves the store
        (resume, reap, drain or close)."""
        req = rec["req"]
        METER.add(self.model.name, req.adapter or "", req.priority,
                  suspend_byte_s=rec["bytes"] * (time.perf_counter() - rec["t_park"]))

    def _take_record(self, rec: dict) -> bytes | None:
        """Pop ``rec``'s frame from the store, charged; None (and the
        request ended) when its client left or its frame is gone."""
        self._meter_unpark(rec)
        req = rec["req"]
        frame = self._suspend_store.take(rec["key"]) if self._suspend_store else None
        if req.future.done():
            self._meter_end(req, "reaped")
            self._end_tl(req, "disconnect", stage="suspended")
            return None
        if frame is None:
            req.future.set_exception(GraphUnitError("suspend record lost from the store"))
            self._meter_end(req, "reaped")
            self._end_tl(req, "error", stage="suspended")
        return frame

    def _drain_resumes(self) -> None:
        """The resume verb, at a sync point with the preemption lifted: each
        suspend record becomes an imported admission of the ORIGINAL
        request, re-queued (its ``t0`` sorts it ahead of younger work of its
        class)."""
        from seldon_core_tpu_torch.disagg.handoff import decode_handoff

        while self._suspended:
            rec = self._suspended.pop(0)
            frame = self._take_record(rec)
            if frame is None:
                continue
            payload = decode_handoff(frame)
            rec["req"].imported = {
                "first_token": int(payload["first_token"]), "k": payload["k"],
                "v": payload["v"], "k_scale": payload.get("k_scale"),
                "v_scale": payload.get("v_scale"),
                "prompt": np.asarray(payload["prompt"], np.int32),
                "reserve_tokens": int(payload["max_new_tokens"]), "resumed": True,
                "spec": payload.get("spec_state"),
            }
            self.resumes += 1
            self._tl(rec["req"], "resume-queued", span=False)
            self._waiting.append(rec["req"])

    def _reap_suspended(self) -> None:
        """A suspended request whose client left or whose deadline passed
        gives its record back at once."""
        if not self._suspended:
            return
        now = time.monotonic()
        keep = []
        for rec in self._suspended:
            req = rec["req"]
            if not req.future.done() and (req.deadline is None or now < req.deadline):
                keep.append(rec)
                continue
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"deadline expired while suspended after {len(req.out)} tokens"))
                self._deadline_miss(req, "suspended")
                self._end_tl(req, "deadline-reap", stage="suspended", tokens=len(req.out))
            self._take_record(rec)
        self._suspended[:] = keep

    async def _park(self) -> None:
        """Preempted (or draining) with nothing device-resident: give the
        grant back, tell a drain it is quiesced, let the arbiter evaluate
        its policy off a grant edge, and wait for a wake, at most 50 ms (the
        deadline reaps of held and suspended requests)."""
        self._arb_release()
        if self._draining:
            self._quiesced.set()
        for q in (self._waiting, self._overflow):
            for r in q:
                self._tl(r, "paused", span=False, cause="preempted")
        self._wake.clear()
        if self._arbiter is not None:
            # with the interactive side quiet no grant edge may come to
            # trigger this scheduler's resume
            self._arbiter.poll()
        if not self._preempt:
            return
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(self._wake.wait(), timeout=0.05)

    # -- live drain: the scheduler's verbs of /admin/drain

    def drain_begin(self) -> None:
        """Pause admission and suspend every active slot at the next sync
        point (the export preemption uses).  Pair with :meth:`drain_finish`
        once the frames moved to a peer, or to resume them here."""
        self._draining = True
        # clear, never replace: drain_wait_quiesced may hold this event
        self._quiesced.clear()
        self.drains += 1
        self._preempt = True
        self._wake_loop()
        if self._task is None or self._task.done():
            self._quiesced.set()  # no run loop: nothing is device-resident

    async def drain_wait_quiesced(self, timeout_s: float = 30.0) -> bool:
        """Wait until no slot is device-resident (records are parked, and
        slots the store refused ran to their end)."""
        try:
            await asyncio.wait_for(self._quiesced.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    def drain_take(self) -> list[tuple[_Request, bytes]]:
        """Pop every parked record as ``(request, frame)``: the migration's
        payload.  The caller owns each request's completion from here
        (:meth:`complete_migrated`, or :meth:`drain_abort`)."""
        out = []
        while self._suspended:
            rec = self._suspended.pop(0)
            frame = self._take_record(rec)
            if frame is not None:
                self.drained_out += 1
                self._tl(rec["req"], "drain-export", bytes=len(frame))
                out.append((rec["req"], frame))
        return out

    def drain_abort(self, pairs: list[tuple[_Request, bytes]]) -> None:
        """The peer refused or died: re-park the frames so that
        :meth:`drain_finish` resumes them here; a failed migration never
        kills a generation."""
        for req, frame in pairs:
            if req.future.done():
                continue
            if self._park_record(req, frame):
                self._tl(req, "drain-abort", span=False)
            else:
                req.future.set_exception(GraphUnitError("drain abort: suspend store full"))
                self._meter_end(req, "reaped")
                self._end_tl(req, "error", stage="suspended")

    def complete_migrated(self, req: _Request, tokens) -> None:
        """Finish a migrated request with the peer's tokens: ``tokens[0]``
        is the carry, delivered here before the drain; the rest go through
        the request's hook and its future resolves with the whole output,
        so the client sees ONE stream."""
        for t in list(tokens)[1:]:
            if self._token_done(req, int(t)):
                break
        if not req.future.done():
            req.future.set_result(np.asarray(req.out, np.int32))
            self._meter_end(req, "completed")
            self._note_completed(req)
        self._finish_tl(req)

    def drain_finish(self) -> None:
        """Lift the drain: admission resumes and the records still parked
        (no peer, or after :meth:`drain_abort`) resume here bit-exactly."""
        self._draining = False
        self._preempt = False
        self._wake_loop()

    def adopt_seed(self, seed: int) -> None:
        """The drain peer's side: adopt the source's sampling-seed counter,
        so that a migrated sampled stream draws the seeds its uninterrupted
        run would have."""
        self._seed = int(seed) % (2**31 - 1)

    def packing_snapshot(self) -> dict:
        """This deployment's packing ledger (``GET /stats/breakdown``)."""
        return {
            "arbitrated": self._arbiter is not None,
            "preempted": self._preempt,
            "draining": self._draining,
            "drains": self.drains,
            "drained_out": self.drained_out,
            "suspended": len(self._suspended),
            "suspends": self.suspends,
            "resumes": self.resumes,
            "suspend_rejected": self.suspend_rejected,
            "queue_pressure_ms": round(self.queue_pressure() * 1e3, 3),
            "suspend_store": (self._suspend_store.snapshot()
                              if self._suspend_store is not None else None),
        }

    async def close(self) -> None:
        self._closed = True
        self.detach_arbiter()
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
            self._meter_end(req, "reaped")
            self._end_tl(req, "error", cause="closed")
        self._waiting.clear()

    # ---------------------------------------------------------------- loop

    def _token_done(self, req: _Request, tok: int) -> bool:
        if not req.out:
            req.t_last_tok = time.perf_counter()
            ttft = req.t_last_tok - req.t0
            self.ttft.append((int(req.prompt.size), ttft))
            RECORDER.record_stage(STAGE_TTFT, ttft)
            # the bucket's exemplar names the trace (SCT_METRICS_EXEMPLARS):
            # a p99 spike links to GET /stats/timeline?trace=
            observe_exemplar(DEFAULT_METRICS.ttft.labels(self.model.name), ttft,
                             req.timeline.trace_id if req.timeline is not None else None)
            if req.span is not None:
                req.span.event("first-token", ttft_ms=round(ttft * 1e3, 3))
        req.out.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:  # noqa: BLE001 - a broken listener must not stall the loop
                log.exception("on_token hook failed; detaching it")
                req.on_token = None
        if req.eos_id is not None and tok == req.eos_id:
            req.done_reason = req.done_reason or "eos"
            return True
        if len(req.out) >= req.max_new_tokens:
            req.done_reason = req.done_reason or "budget"
            return True
        return False

    def _note_completed(self, req: _Request) -> None:
        """The generated-token counter and the request's decode rate."""
        if req.out and req.t0:
            m = DEFAULT_METRICS
            m.generated_tokens.labels(self.model.name).inc(len(req.out))
            dur = time.perf_counter() - req.t0
            if dur > 0:
                m.tokens_per_s.labels(self.model.name).set(len(req.out) / dur)

    def _finish(self, req: _Request, slot: int, slots, active, *, terminal: bool = True) -> None:
        """A request that made its last token: resolved, its slot freed; its
        terminal event unless the caller stamps it after a block event."""
        if req.future.done():  # its client left: nothing was delivered
            self._meter_end(req, "reaped")
        else:
            req.future.set_result(np.asarray(req.out, np.int32))
            self._meter_end(req, "completed")
            self._note_completed(req)
        slots[slot] = None
        active[slot] = False
        self.model.release_slot(slot)
        if terminal:
            self._finish_tl(req)

    def _reap(self, slots, active) -> int:
        """Drop requests whose client vanished (cancelled future) or whose
        deadline passed (failed here with :class:`DeadlineExceeded`): from
        the queues before a prefill is spent, from slots between prefill
        chunks (the slot's blocks go back unwritten to the index, as for an
        aborted prefill) or mid-generation.  Returns the decoding slots
        reaped: the device carry still thinks them active, so the next
        block must be dispatched from host state.  Their blocks may go back
        to the pool while a continued block is in flight: nothing reserves
        them before the next sync point, which waits for that block, and
        the tokens it makes for them are dropped as wasted."""
        now = time.monotonic()

        def gone(req: _Request, stage: str, where: str) -> str | None:
            """None while the request lives, else ``disconnect`` (its client
            left) or ``deadline-reap`` (failed here)."""
            if req.future.done():
                return "disconnect"
            if req.deadline is None or now < req.deadline:
                return None
            req.future.set_exception(DeadlineExceeded(f"deadline expired {where}"))
            self._deadline_miss(req, stage)
            return "deadline-reap"

        for q in (self._waiting, self._overflow):
            keep = []
            for r in q:
                why = gone(r, "generation-queue", f"after {time.perf_counter() - r.t0:.3f}s "
                                                  "waiting in the generation queue")
                if why is None:
                    keep.append(r)
                    continue
                self._meter_end(r, "reaped")
                if why == "deadline-reap":  # a withdrawn request ended at its cancel
                    self._end_tl(r, why, stage="queue")
            q[:] = keep
        for ent in list(self._prefilling):
            why = gone(ent["req"], "prefill", f"after {ent['i']} prefill chunks")
            if why is not None:
                self._prefilling.remove(ent)
                self.model.release_slot(ent["slot"])
                self._meter_end(ent["req"], "reaped")
                self._end_tl(ent["req"], why, stage="prefill", chunks=ent["i"])
        reaped = 0
        for i, req in enumerate(slots):
            why = None if req is None else gone(
                req, "decode", f"mid-generation after {len(req.out)} tokens")
            if why is not None:
                slots[i] = None
                if active[i]:
                    reaped += 1
                    self._reaped_rows[i] = req
                active[i] = False
                self.model.release_slot(i)
                self._meter_end(req, "reaped")
                self._end_tl(req, why, stage="decode", tokens=len(req.out))
        return reaped

    def _deliver(self, toks_seq, act_seq, slots, cur, active) -> None:
        """Fan one fetched block's ``(rows, S)`` tokens out to their requests:
        ``rows`` is ``k``, or ``k * (1 + spec_draft)`` with speculation on,
        where ``act_seq`` marks the tokens each pass emitted.  A request that
        finishes mid-block (mid-pass too) frees its slot at once and gets
        none of the slot's later rows.  Each delivered token's margin, from
        the block's fetch, adds to its request's confidence, and the tokens
        delivered to a request that names an adapter tick that adapter's
        ledger."""
        conf_seq = self.model.last_conf_seq
        if conf_seq is not None and conf_seq.shape != toks_seq.shape:
            conf_seq = None  # a stale stash: never misattribute
        delivered: collections.Counter = collections.Counter()
        reqs = list(slots)  # completions below null the live entries
        counts = [0] * len(slots)
        finished: set[int] = set()
        for step_i in range(toks_seq.shape[0]):
            for i, req in enumerate(slots):
                if req is None or not act_seq[step_i, i]:
                    continue
                tok = int(toks_seq[step_i, i])
                cur[i] = tok
                counts[i] += 1
                if conf_seq is not None:
                    req.conf_sum += float(conf_seq[step_i, i])
                    req.conf_n += 1
                if req.adapter:
                    delivered[req.adapter] += 1
                if self._token_done(req, tok):
                    self._finish(req, i, slots, active, terminal=False)
                    finished.add(i)
        for adapter, n in delivered.items():
            self.model.note_adapter_tokens(adapter, n)
        # per slot: an inter-token-latency sample (the delivery gap over the
        # tokens it carried) and the timeline's block event, the terminal
        # after it for a request this block finished
        now = time.perf_counter()
        spec_d, tps = self.model.spec_draft, self.model._tps
        for i, req in enumerate(reqs):
            if req is None or not counts[i]:
                continue
            if req.t_last_tok:
                self.model.note_itl((now - req.t_last_tok) / counts[i])
            req.t_last_tok = now
            if req.timeline is not None or req.span is not None:
                attrs = {"tokens": counts[i]}
                if spec_d and toks_seq.shape[0] % tps == 0:
                    passes = int(act_seq[:, i].reshape(-1, tps).any(axis=1).sum())
                    attrs.update(passes=passes, drafted=passes * spec_d,
                                 accepted=max(0, counts[i] - passes))
                self._tl(req, "block", **attrs)
            if i in finished:
                self._finish_tl(req)
        # the tokens this block made for slots reaped while it was in flight
        wasted = set()
        for i, req in self._reaped_rows.items():
            if reqs[i] is None:  # no admission took the slot since
                reqs[i], counts[i] = req, int(act_seq[:, i].sum())
                wasted.add(i)
        self._reaped_rows.clear()
        self._meter_block(reqs, counts, wasted, act_seq)

    def _meter_block(self, reqs, counts, wasted: set[int], act_seq) -> None:
        """Split one fetched block's device seconds over the slots it served
        by token share (a slot that made 3 of its 12 tokens is charged a
        quarter), with each slot's decode tokens and accepted drafts; the
        ``wasted`` slots' tokens were dropped.  A block that made no token
        charges the deployment's base row."""
        name, block_s = self.model.name, self.model.last_block_s
        block_tokens = sum(counts)
        if block_s and not block_tokens:
            METER.add(name, device_s=block_s)
        spec_d, tps = self.model.spec_draft, self.model._tps
        for i, req in enumerate(reqs):
            if req is None or not counts[i]:
                continue
            fields = {"device_s": block_s * counts[i] / block_tokens,
                      "tokens_decode": counts[i]}
            req.u_device_s += fields["device_s"]
            if i in wasted:
                fields["tokens_wasted"] = counts[i]
            elif spec_d and act_seq.shape[0] % tps == 0:
                passes = int(act_seq[:, i].reshape(-1, tps).any(axis=1).sum())
                accepted = max(0, counts[i] - passes)
                if accepted:
                    fields["tokens_spec_accepted"] = accepted
                    fields[f"tokens_spec_accepted_{self.model.spec_method}"] = accepted
            METER.add(name, req.adapter or "", req.priority, **fields)

    def _fail_inflight(self, slots, active, exc: BaseException) -> None:
        prefilling = {e["slot"] for e in self._prefilling}  # not in the decode batch
        for i, req in enumerate(slots):
            if req is not None:
                if not req.future.done():
                    req.future.set_exception(exc)
                self._meter_end(req, "reaped")
                self._end_tl(req, "error", stage="decode")
            slots[i] = None
            if i not in prefilling:
                self.model.release_slot(i)
        active[:] = False

    def _start(self, req: _Request, slot: int, tok: int, slots, cur, temps, active) -> None:
        """A prefilled request's first token: it joins the decode batch."""
        slots[slot] = req
        cur[slot] = tok
        temps[slot] = req.temperature
        active[slot] = True
        if self._token_done(req, tok):
            self._finish(req, slot, slots, active)

    async def _sync_point(self, batch, slots, cur, temps, active) -> None:
        """Admit ``batch`` into free slots and advance the oldest chunked
        admission by one chunk; ONE host fetch brings back every first
        token this produced."""
        prefilling = {e["slot"] for e in self._prefilling}
        free = [i for i in range(len(slots))
                if not active[i] and i not in prefilling and i not in self._external]
        # pace chunks only while decode streams are live
        live = bool(active.any())
        chunk_c = self.model.prefill_chunk if live else 0
        head = self._prefilling[0] if self._prefilling else None

        def dispatch_and_fetch():
            placed, errors, starved, chunked = [], [], [], []
            for req, slot in zip(batch, free):
                try:
                    if req.imported is not None:  # a handoff: import, no prefill
                        # (a resumed suspend record carries its extended
                        # prompt, prompt + tokens emitted but the carry, and
                        # the budget left)
                        imp = req.imported
                        self.model.attach_imported(
                            slot, imp.get("prompt", req.prompt), imp["k"], imp["v"],
                            reserve_tokens=imp.get("reserve_tokens", req.max_new_tokens),
                            k_scale=imp["k_scale"], v_scale=imp["v_scale"],
                            first_token=imp["first_token"], spec_state=imp["spec"],
                            adapter=req.adapter,
                        )
                        placed.append((req, slot, imp["first_token"]))
                        continue
                    if chunk_c and not req.prefill_only and req.prompt.size > chunk_c:
                        # reserve only: the chunks go one per sync point
                        plan = self.model.admit_chunk_plan(
                            slot, req.prompt, req.temperature, self._next_seed(),
                            reserve_tokens=req.max_new_tokens, adapter=req.adapter,
                        )
                        chunked.append({"req": req, "slot": slot, "plan": plan, "i": 0})
                        continue
                    tok = self.model.admit_dispatch(
                        slot, req.prompt, req.temperature, self._next_seed(),
                        reserve_tokens=req.max_new_tokens, adapter=req.adapter,
                    )
                    placed.append((req, slot, tok))
                except OutOfKVBlocks:
                    starved.append(req)
                except Exception as exc:  # noqa: BLE001 - routed to the future
                    errors.append((req, exc))
            ent = head if head is not None else (chunked[0] if chunked else None)
            toks = [t for _, _, t in placed]  # device tensors; an import's is an int
            chunk_err = None
            if ent is not None:
                try:
                    tok = self.model.prefill_chunk_dispatch(ent["plan"], ent["i"])
                    if ent["i"] == len(ent["plan"]["payloads"]) - 1:
                        toks.append(tok)  # the request's first token
                except Exception as exc:  # noqa: BLE001 - routed to the future
                    chunk_err = exc
            # one host fetch for every first token of this sync point
            fetched = iter(self.model.fetch_tokens(
                [t for t in toks if isinstance(t, torch.Tensor)]))
            toks = [next(fetched) if isinstance(t, torch.Tensor) else int(t) for t in toks]
            return placed, toks, errors, starved, chunked, ent, chunk_err

        placed, toks, errors, starved, chunked, ent, chunk_err = await asyncio.to_thread(
            dispatch_and_fetch
        )
        self._prefilling.extend(chunked)
        # the admit events read the host's reservation bookkeeping, and name
        # the proposer a request's drafts came from
        smkw = {"spec_method": self.model.spec_method} if self.model.spec_draft else {}

        def admit_attrs(req: _Request, slot: int) -> dict:
            attrs = self.model.reservation_snapshot(slot) or {}
            if req.adapter:
                attrs["adapter"] = req.adapter
            return attrs

        for e in chunked:
            self._tl(e["req"], "admit", slot=e["slot"], chunked=True,
                     chunks=len(e["plan"]["payloads"]), **admit_attrs(e["req"], e["slot"]),
                     **smkw)
        for req in starved:
            self._tl(req, "kv-starved", span=False)
        self._overflow.extend(starved)
        chunk_i = ent["i"] if ent is not None else 0
        if chunk_err is not None:
            errors.append((ent["req"], chunk_err))
            self._prefilling.remove(ent)
            self.model.release_slot(ent["slot"])
        for req, exc in errors:
            if not isinstance(exc, GraphUnitError):
                log.error("prefill admission failed", exc_info=exc)
            if not req.future.done():
                req.future.set_exception(exc)
            self._meter_end(req, "reaped")
            if chunk_err is not None and req is ent["req"]:
                self._end_tl(req, "error", stage="prefill", chunks=chunk_i)
            else:
                self._end_tl(req, "error", stage="admit")
        now = time.perf_counter()
        for req in [r for r, _, _ in placed] + [e["req"] for e in chunked]:
            if req.imported is None and not req.prefill_only:
                RECORDER.record_stage(STAGE_QUEUE_WAIT, now - req.t0)
            if not req.prefill_only:
                self._note_queue_wait(req)
        for e in chunked:
            self._meter_admit(e["req"], e["slot"])
        for (req, slot, _), tok in zip(placed, toks):
            if req.imported is None:  # an import was prefilled by its sender
                self._meter_admit(req, slot)
            if req.imported is not None and req.imported.get("resumed"):
                # a resumed suspend record: its carry token was delivered
                # before the suspension, so the slot is re-armed without
                # delivering it again
                req.imported = None  # the record's host arrays go
                req.t_last_tok = time.perf_counter()  # the park is no inter-token gap
                self._tl(req, EVENT_RESUME, slot=slot, tokens=len(req.out),
                         **admit_attrs(req, slot))
                slots[slot] = req
                cur[slot] = tok
                temps[slot] = req.temperature
                active[slot] = True
                continue
            if not req.prefill_only:
                attrs = admit_attrs(req, slot)
                if req.imported is not None:
                    attrs["imported"] = True
                self._tl(req, "admit", slot=slot, **attrs, **smkw)
                self._start(req, slot, tok, slots, cur, temps, active)
            elif req.future.done():  # the client left during the prefill
                self.model.release_slot(slot)
                self._meter_end(req, "reaped")
                self._end_tl(req, "disconnect", stage="prefill")
            else:  # pinned until release_external
                self.ttft.append((int(req.prompt.size), time.perf_counter() - req.t0))
                self._external.add(slot)
                self._tl(req, "admit", slot=slot, prefill_only=True, **admit_attrs(req, slot),
                         **smkw)
                req.future.set_result((slot, int(tok)))
                self._meter_end(req, "completed")
                self._end_tl(req, "exported", slot=slot)
        if ent is not None and chunk_err is None:
            self.chunks_paced += int(live)
            n_chunks = len(ent["plan"]["payloads"])
            last = ent["i"] == n_chunks - 1
            self._tl(ent["req"], "chunk", i=ent["i"], of=n_chunks, last=last)
            ent["i"] += 1
            if last:
                self._prefilling.remove(ent)
                self._start(ent["req"], ent["slot"], toks[-1], slots, cur, temps, active)

    def _break_cause(self, carry_dirty: bool) -> str | None:
        """Why the next block may not continue from the device carry, or
        None when it may."""
        if carry_dirty:
            return "carry-dirty"
        if self._preempt or self._arb_contended():
            # a packed card: a co-tenant wants the device, or this scheduler
            # must suspend; the block boundary yields before another block
            # (and another seed) goes from the carry
            return "arbiter-yield"
        if self._waiting:
            return "admission"
        if self._overflow:
            return "kv-starved"
        if self._external_release:
            return "handoff-release"
        if self._prefilling:
            return "chunked-prefill"
        return None

    async def _run(self) -> None:
        S = self.model.n_slots
        slots: list[_Request | None] = [None] * S
        cur = np.zeros(S, np.int32)
        temps = np.zeros(S, np.float32)
        active = np.zeros(S, bool)
        k = self.model.decode_block
        # the dispatched block whose tokens are not fetched yet, and whether
        # the device carry still matches the host's bookkeeping
        pending: tuple | None = None
        carry_dirty = True
        try:
            while True:
                if self._closed:
                    raise asyncio.CancelledError
                if self._reap(slots, active):
                    carry_dirty = True
                self._reap_suspended()
                if pending is None:
                    pending = await self._sync_and_dispatch(slots, cur, temps, active, k)
                    carry_dirty = False
                    continue
                # the overlap: block N+1 goes from block N's device carry
                # before block N's tokens are fetched, unless host-side
                # state must change first
                nxt = None
                if self.overlap and active.any():
                    cause = self._break_cause(carry_dirty)
                    if cause is None:
                        try:
                            nxt = await asyncio.to_thread(
                                self.model.step_k_continue, active.copy(), self._next_seed(), k)
                        except Exception:  # noqa: BLE001 - the next block goes from host state
                            log.exception("overlapped dispatch failed; dispatching from the host")
                            cause, carry_dirty = "dispatch-error", True
                    if cause is not None:
                        self.overlap_breaks[cause] += 1
                        for i, req in enumerate(slots):
                            if req is not None and active[i]:
                                self._tl(req, "overlap-break", cause=cause)
                try:
                    toks_seq, act_seq = await asyncio.to_thread(self.model.step_k_fetch, pending)
                except Exception as exc:  # noqa: BLE001 - fails the in-flight requests
                    log.error("decode block failed; failing %d requests",
                              int(active.sum()), exc_info=exc)
                    if nxt is not None:  # chained off the failed block: drain it
                        with contextlib.suppress(Exception):
                            await asyncio.to_thread(self.model.step_k_fetch, nxt)
                    pending, carry_dirty = None, True
                    self._arb_release()
                    self._fail_inflight(slots, active, exc)
                    continue
                pending = nxt
                if pending is None:
                    # the pipeline drained to a sync point: the grant rotates
                    # before the host delivers, so a parked co-tenant's
                    # dispatch overlaps this bookkeeping
                    self._arb_release()
                self._deliver(toks_seq, act_seq, slots, cur, active)
        except asyncio.CancelledError:
            err = RuntimeError("GenerationScheduler closed")
            for _payload, fut in self._prefix_installs:
                if not fut.done():
                    fut.set_exception(err)
            self._prefix_installs.clear()
            self._external.clear()
            self._external_release.clear()
            for req in ([e["req"] for e in self._prefilling] + self._overflow
                        + [r for r in slots if r is not None]):
                if not req.future.done():
                    req.future.set_exception(err)
                self._meter_end(req, "reaped")
                self._end_tl(req, "error", cause="closed")
            self._prefilling.clear()
            self._overflow.clear()
            for i in range(S):
                self.model.release_slot(i)
            for rec in self._suspended:
                self._meter_unpark(rec)
                if not rec["req"].future.done():
                    rec["req"].future.set_exception(err)
                self._meter_end(rec["req"], "reaped")
                self._end_tl(rec["req"], "error", cause="closed")
            self._suspended.clear()
            if self._suspend_store is not None:
                self._suspend_store.flush()
            self._arb_release()
            raise

    async def _sync_and_dispatch(self, slots, cur, temps, active, k: int) -> tuple | None:
        """A sync point (no block in flight): pinned slots go back, pulled
        chains are installed, queued requests are admitted and a chunk
        advances; then a block is dispatched from host state.  Returns its
        handle, or None when nothing decodes (parked or failed)."""
        S = len(slots)
        # no block is in flight, so pinned slots may go back to the pool and
        # pulled chains may take blocks; on a packed card every device call
        # from here to the block's fetch runs under the device grant.  The
        # draft prefills deferred at the last admissions run first, under
        # their own batch-class grant, while this scheduler holds none
        self._drain_external_releases()
        await self._drain_draft_prefills()
        if self._prefix_installs:
            await self._arb_acquire()
            await self._drain_prefix_installs()
        if self._preempt and active.any():
            # the preemption (or drain) verb: the active slots go to the
            # suspend store; the next dispatch goes from host state
            await self._arb_acquire()
            await self._suspend_active(slots, active)
        if self._suspended and not self._preempt:
            self._drain_resumes()  # the resume verb: re-queued as imports
        if self._preempt and not active.any() and not self._prefilling:
            await self._park()
            return None
        if (not active.any() and not self._waiting and not self._overflow
                and not self._prefilling and not self._external_release
                and not self._prefix_installs):
            # fully idle: the grant goes back (an idle co-tenant never holds
            # the device), then park until a submit wakes us (no await
            # between the emptiness check and clear)
            self._arb_release()
            self._wake.clear()
            await self._wake.wait()
            return None
        # the admissions are taken before the embed wave is awaited: an embed
        # that arrives meanwhile waits for the next wave, never for a slot.
        # A preempted scheduler admits nothing, embeds included: the device
        # belongs to the co-tenant until the arbiter resumes it
        embeds = [] if self._preempt else [r for r in self._waiting if r.embed_only]
        if embeds:
            self._waiting[:] = [r for r in self._waiting if not r.embed_only]
        cap_free = 0 if self._preempt else (
            S - int(active.sum()) - len(self._prefilling) - len(self._external))
        batch = []
        while self._overflow and len(batch) < cap_free:
            batch.append(self._overflow.pop(0))
        if self._waiting and len(batch) < cap_free:
            # interactive first, then by arrival
            self._waiting.sort(key=lambda r: (qos.priority_rank(r.priority), r.t0))
        while self._waiting and len(batch) < cap_free:
            batch.append(self._waiting.pop(0))
        if batch or embeds or self._prefilling or active.any():
            # the sync point's device work (prefills, a chunk, the block and
            # the blocks chained from it) runs under the grant
            await self._arb_acquire()
        if embeds:
            await self._admit_embeds(embeds)
        if batch or self._prefilling:
            await self._sync_point(batch, slots, cur, temps, active)
        if not active.any():
            self._arb_release()  # nothing to dispatch: before any park below
            if self._prefilling:
                return None  # chunks still advancing: each turn does device work
            cap_free = S - len(self._prefilling) - len(self._external)
            if (self._external and (self._waiting or self._overflow)
                    and (cap_free == 0 or not self._waiting)
                    and not self._external_release and not self._prefix_installs):
                # nothing can be admitted: every free slot, or the blocks the
                # overflow needs, is pinned by a handoff in flight.  Park
                # until a release or a submit wakes the loop (no await
                # between the check and clear); the timeout reaps parked
                # clients within 50 ms.
                for q in (self._waiting, self._overflow):
                    for r in q:
                        self._tl(r, "paused", span=False, cause="externals-pinned")
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass
                return None
            if self._overflow:
                # nothing in flight can free blocks: these requests exceed
                # the pool outright
                err = GraphUnitError(
                    "request KV reservation exceeds the configured pool "
                    f"({self.model.kv_blocks - 1} blocks of {self.model.kv_block_size})"
                )
                for req in self._overflow:
                    if not req.future.done():
                        req.future.set_exception(err)
                    self._meter_end(req, "reaped")
                    self._end_tl(req, "error", stage="admit")
                self._overflow.clear()
            return None
        eos = np.array(
            [r.eos_id if r is not None and r.eos_id is not None else -1 for r in slots], np.int32,
        )
        remaining = np.array(
            [max(0, r.max_new_tokens - len(r.out)) if r is not None else 0 for r in slots],
            np.int32,
        )
        try:
            return await asyncio.to_thread(
                self.model.step_k_dispatch, cur.copy(), active.copy(), temps.copy(),
                self._next_seed(), eos, remaining, k,
            )
        except Exception as exc:  # noqa: BLE001 - fails the in-flight requests
            log.error("decode dispatch failed; failing %d requests", int(active.sum()),
                      exc_info=exc)
            self._arb_release()
            self._fail_inflight(slots, active, exc)
            return None


class GenerativeComponent(SeldonComponent):
    """Graph unit serving a generative decoder.

    Wire contract (MODEL unit):

    * ``data.ndarray`` (B, L) int token ids -> (B, <=max_new) generated ids,
      rows right-padded with ``-1`` where EOS ended a row early;
    * ``strData`` JSON ``{"tokens": [[...], ...] | [...], "max_new_tokens":
      N, "temperature": t, "eos_id": e}`` -> ``strData`` JSON ``{"tokens":
      [[...], ...] | [...]}`` (a flat prompt gets a flat reply); with the
      model's ``conf_signal`` on the reply also carries ``"confidence"``,
      each row's mean top-2 logit margin (a list for a batch), which a
      cascade router reads; the tokens are those of the signal off.  A
      strData ``"adapter"`` names the LoRA adapter the rows decode through,
      overriding the unit's default ``adapter``; ``"adapter": null`` is the
      base model.
    """

    # cumulative gauges that tolerate races: an annotation lock would
    # serialize the requests continuous batching runs together
    SAFE_ANNOTATIONS = True

    def __init__(
        self,
        model: GenerativeModel,
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: int | None = None,
        queue_max: int | None = None,
        overlap: bool | None = None,
        adapter: str | None = None,
        pack_class: str | None = None,
        pack_slo_ms: float | None = None,
    ):
        self.model = model
        self.scheduler = GenerationScheduler(model, maxsize=queue_max, overlap=overlap)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        # the deployment's default LoRA adapter (None: the base model)
        self.adapter = adapter or None
        # greedy decode is a pure function of the prompt
        self.DETERMINISTIC = self.temperature == 0.0
        # chip packing: the deployment's QoS class and queue-wait SLO band
        # on a packed card.  It joins the process's arbiter through
        # register_packed (the engine's co-resident boot) or SCT_PACK=1; a
        # sole tenant never touches it
        self.pack_class = qos.parse_priority(pack_class) if pack_class else None
        self.pack_slo_ms = float(pack_slo_ms) if pack_slo_ms else None
        if os.environ.get("SCT_PACK", "0") == "1":
            self.register_packed()

    def register_packed(self, arbiter=None) -> None:
        """Attach the scheduler to the device arbiter (the process's by
        default) under the deployment's packing class and SLO; a second
        call is a no-op."""
        if self.scheduler._arbiter is not None:
            return
        if arbiter is None:
            from seldon_core_tpu_torch.executor.arbiter import get_arbiter

            arbiter = get_arbiter()
        self.scheduler.attach_arbiter(arbiter, priority=self.pack_class or qos.PRIO_INTERACTIVE,
                                      slo_ms=self.pack_slo_ms)

    def warmup(self) -> int:
        return self.model.warmup()

    def warmup_variants(self) -> list[str]:
        """The programs warmup made: a decode block per window bucket (a
        captured graph on the card) and a prefill per bucket."""
        m = self.model
        return ([f"decode:k{m.decode_block}:w{w}" for w in m._window_buckets()]
                + [f"prefill:{b}" for b in m.prefill_buckets])

    async def close(self) -> None:
        await self.scheduler.close()
        await asyncio.to_thread(self.model.release_memory)

    def metrics(self) -> list[dict[str, Any]]:
        m, n = self.model, self.model.name
        return [
            {"key": f"{n}_decode_steps", "type": "GAUGE", "value": m.steps},
            {"key": f"{n}_prefills", "type": "GAUGE", "value": m.prefills},
            {"key": f"{n}_decode_blocks", "type": "GAUGE", "value": m.decode_blocks},
            {"key": f"{n}_host_syncs", "type": "GAUGE", "value": m.host_syncs},
            {"key": f"{n}_prefills_reused", "type": "GAUGE", "value": m.prefills_reused},
            {"key": f"{n}_prefill_chunks", "type": "GAUGE", "value": m.prefill_chunks},
            {"key": f"{n}_spec_verify_passes", "type": "GAUGE", "value": m.spec_verify_passes},
            {"key": f"{n}_spec_emitted_tokens", "type": "GAUGE", "value": m.spec_emitted_tokens},
            {"key": f"{n}_overlapped_blocks", "type": "GAUGE", "value": m.overlapped},
            {"key": f"{n}_program_compiles", "type": "GAUGE", "value": m.program_compiles},
        ]

    def resolve_adapter(self, body: dict) -> str | None:
        """The adapter a request body selects: its ``"adapter"`` when the key
        is there (null: the base model), else the unit's default."""
        adapter = body.get("adapter", self.adapter) if isinstance(body, dict) else self.adapter
        return str(adapter) if adapter else None

    async def _generate_rows(self, rows, max_new_tokens, temperature, eos_id, infos=None,
                             adapter: str | None = None):
        """Submit ``rows`` together; ``infos`` (a list) gets one confidence
        dict per row."""
        if infos is not None:
            infos.extend({} for _ in rows)
        return list(await asyncio.gather(*(
            self.scheduler.submit(
                row, max_new_tokens=max_new_tokens, temperature=temperature, eos_id=eos_id,
                info=infos[i] if infos is not None else None, adapter=adapter,
            )
            for i, row in enumerate(rows)
        )))

    async def embed_rows(self, rows: list[np.ndarray]) -> np.ndarray:
        """Mean-pooled final hidden states of a batch of prompts, ``(B, E)``
        float32, from this unit's own weights (the ``/embeddings`` route):
        each row rides the scheduler's intake, and the run loop serves the
        waiting ones as a wave with one host fetch."""
        outs = await asyncio.gather(*(self.scheduler.submit_embed(row) for row in rows))
        return np.stack([np.asarray(o, np.float32) for o in outs])

    async def stream_groups(
        self,
        prompt,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        eos_id: int | None = None,
        adapter: str | None = None,
    ) -> AsyncIterator[list[int]]:
        """Yield the generated ids in the groups they are delivered in: the
        first token at admission, then one decode block's at a time (the
        tokens a block delivered are all queued before this coroutine runs
        again).  Leaving the iteration early cancels the request, whose
        slot the scheduler then frees.  ``adapter`` as the scheduler's
        (the caller resolves the unit's default)."""
        q: asyncio.Queue = asyncio.Queue()
        end = object()
        task = asyncio.create_task(self.scheduler.submit(
            np.asarray(prompt, np.int32).ravel(),
            max_new_tokens=self.max_new_tokens if max_new_tokens is None else max_new_tokens,
            temperature=self.temperature if temperature is None else temperature,
            eos_id=self.eos_id if eos_id is None else eos_id,
            on_token=q.put_nowait, adapter=adapter,
        ))
        task.add_done_callback(lambda _t: q.put_nowait(end))
        served = 0
        try:
            done = False
            while not done:
                group = [await q.get()]
                while not q.empty():
                    group.append(q.get_nowait())
                if group[-1] is end:
                    group.pop()
                    done = True
                served += len(group)
                if group:
                    yield [int(t) for t in group]
            # surface a failed submit, and any token the hook did not carry
            rest = task.result()[served:]
            if rest.size:
                yield [int(t) for t in rest]
        finally:
            if not task.done():
                task.cancel()

    async def stream(
        self,
        prompt,
        *,
        max_new_tokens: int | None = None,
        temperature: float | None = None,
        eos_id: int | None = None,
        adapter: str | None = None,
    ) -> AsyncIterator[int]:
        """Yield generated token ids as they decode: the first after the
        prefill, the rest ``decode_block`` at a time per device fetch."""
        groups = self.stream_groups(prompt, max_new_tokens=max_new_tokens,
                                    temperature=temperature, eos_id=eos_id, adapter=adapter)
        async with contextlib.aclosing(groups):
            async for group in groups:
                for tok in group:
                    yield tok

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
            rows, self.max_new_tokens, self.temperature, self.eos_id, adapter=self.adapter
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
            adapter = self.resolve_adapter(body)
        except (json.JSONDecodeError, TypeError, KeyError, ValueError) as e:
            raise GraphUnitError(f"bad generative request: {e}") from e
        infos: list[dict] | None = [] if self.model.conf_signal else None
        outs = await self._generate_rows(rows, max_new, temperature, eos, infos, adapter)
        result = [o.tolist() for o in outs]
        reply: dict = {"tokens": result[0] if single else result}
        if infos is not None:
            confs = [i.get("confidence") for i in infos]
            reply["confidence"] = confs[0] if single else confs
        return Payload(json.dumps(reply), [], DataKind.STRING, p.meta)
