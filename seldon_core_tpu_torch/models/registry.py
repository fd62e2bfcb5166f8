"""Model-family registry for the generative graph unit (JAX_GENERATIVE).

The counterpart of the JAX package's ``models/registry.py::
build_generative_component`` for the llama family and its presets.  Graph
parameters of features the port does not serve yet raise
:class:`GraphUnitError` naming themselves whenever they are set to
anything but their off value; none is ever ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from seldon_core_tpu_torch import resolve_device
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.models import llama
from seldon_core_tpu_torch.models.weights import init_params, params_from_jax

PRESETS = {
    "llama3-8b": llama.Config.llama3_8b,
    "llama3-1b": llama.Config.llama3_1b,
    "tiny": llama.Config.tiny,
}

# parameters of the JAX package's generative unit that belong to later
# slices of the port (trained Medusa heads from a checkpoint, mesh,
# checkpoints, chip packing)
LATER_SLICE_PARAMS = ("spec_heads_path", "mesh", "checkpoint", "pack_class", "pack_slo_ms")


def _is_off(value: Any) -> bool:
    return value is None or value is False or value == 0 or value == ""


def resolve_config(preset: str | None = None, **overrides) -> llama.Config:
    if preset is None:
        cfg = llama.Config()
    else:
        try:
            cfg = PRESETS[preset]()
        except KeyError:
            raise KeyError(f"unknown llama preset {preset!r}; have {sorted(PRESETS)}") from None
    if overrides:
        fields = {f.name for f in dataclasses.fields(llama.Config)}
        unknown = sorted(set(overrides) - fields)
        if unknown:
            raise TypeError(f"unknown generative parameters {unknown}")
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def build_generative_component(
    family: str = "llama",
    *,
    preset: str | None = None,
    cfg: llama.Config | None = None,
    n_slots: int = 4,
    rng: int = 0,
    dtype: torch.dtype | None = None,
    params: Any = None,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    eos_id: int | None = None,
    seq_impl: str = "flash",
    decode_block: int = 16,
    kv_block_size: int = 16,
    kv_blocks: int | None = None,
    queue_max: int | None = None,
    top_k: int = 0,
    decode_kernel: bool = True,
    kv_cache_dtype: str | None = None,
    kv_prefix_reuse: bool | None = None,
    prefill_chunk: int | None = None,
    prefix_dram_gb: float | None = None,
    spec_draft: int | None = None,
    spec_ngram: int | None = None,
    spec_hist: int = 64,
    spec_method: str | None = None,
    spec_heads: int | None = None,
    spec_draft_model: str | None = None,
    overlap: bool | None = None,
    conf_signal: bool | None = None,
    embed: bool | None = None,
    lora_rank: int | None = None,
    lora_slots: int | None = None,
    lora_targets: str | None = None,
    lora_adapters: Any = None,
    adapter: str | None = None,
    device: str = "cuda",
    **overrides,
):
    """Build a continuous-batching generative graph unit on ``device``.

    ``params`` is a :class:`~seldon_core_tpu_torch.models.llama.Llama` or
    the JAX package's ``init_params`` pytree (numpy leaves); without it the
    weights are made from the seed ``rng``.  On ``cuda`` the attention runs
    in the hand-written kernels only: ``seq_impl`` must be ``"flash"`` and
    ``decode_kernel`` True.  ``kv_cache_dtype="int8"`` stores the paged pool
    quantized with per-(position, head) scales, ``kv_prefix_reuse`` shares
    prompt-prefix KV blocks across requests and ``prefill_chunk`` prefills
    long prompts in chunks paced between decode blocks, as in the JAX
    package; ``prefix_dram_gb`` (with ``kv_prefix_reuse``; env
    ``SCT_PREFIX_DRAM_GB``) keeps evicted prefix blocks in that many GiB of
    host DRAM and promotes them back on a match.  ``spec_draft`` turns on speculative decoding with the
    proposer ``spec_method`` (``ngram``, ``heads`` with ``spec_heads``
    heads made from the model's ``lm_head``, or ``draft`` with
    ``spec_draft_model``); ``spec_ngram``/``spec_hist`` size the n-gram
    proposer.  ``overlap`` (default on when ``decode_block > 1``; env
    ``SCT_GEN_OVERLAP=0`` turns it off) dispatches each decode block from
    the previous block's device carry before that block's tokens are
    fetched.  ``conf_signal`` (env ``SCT_CASCADE_CONF_SIGNAL=1``) computes
    the top-2 logit margin inside the decode blocks and adds each row's
    mean to a strData reply (``"confidence"``, read by a cascade router);
    ``embed`` (env ``SCT_EMBED=1``) warms the pooled-embedding path the
    ``/api/v0.1/embeddings`` route serves.  ``lora_rank``/``lora_slots``/
    ``lora_targets``/``lora_adapters`` (env ``SCT_LORA_RANK``,
    ``SCT_LORA_SLOTS``, ``SCT_LORA_TARGETS``, ``SCT_LORA_ADAPTERS``) turn on
    batched multi-LoRA serving: one stacked adapter pool gathered per slot
    inside every prefill, decode block and verify pass; ``adapter`` is the
    deployment's default adapter, which a request's ``"adapter"``
    overrides."""
    from seldon_core_tpu_torch.executor.generation import (
        GenerativeComponent,
        GenerativeModel,
    )

    for name in LATER_SLICE_PARAMS:
        if name in overrides:
            value = overrides.pop(name)
            if not _is_off(value):
                raise GraphUnitError(
                    f"generative parameter {name}={value!r} is not served by the "
                    "PyTorch port yet"
                )
    if family != "llama":
        raise KeyError(f"family {family!r} has no generative contract; have ['llama']")
    if seq_impl in ("ring", "ulysses"):
        raise GraphUnitError(
            f"seq_impl={seq_impl!r} (sequence parallelism) is not served by the "
            "PyTorch port yet"
        )
    if seq_impl not in ("flash", "dense"):
        raise TypeError(f"seq_impl must be one of dense/flash, got {seq_impl!r}")
    dev = resolve_device(device)
    if cfg is None:
        cfg = resolve_config(preset, **overrides)
    elif overrides:
        raise TypeError(f"unknown generative parameters {sorted(overrides)}")
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(int(rng))
        model_params = init_params(cfg, gen, dtype=dtype or torch.float32, device=dev)
    elif isinstance(params, llama.Llama):
        model_params = params
    else:
        model_params = params_from_jax(params, cfg, dtype=dtype, device=dev)
    model = GenerativeModel(
        cfg,
        model_params,
        n_slots=n_slots,
        dtype=dtype,
        seq_impl=seq_impl,
        name=f"{family}:{preset or 'default'}",
        decode_block=decode_block,
        kv_block_size=kv_block_size,
        kv_blocks=kv_blocks,
        top_k=top_k,
        decode_kernel=bool(decode_kernel),
        kv_cache_dtype=kv_cache_dtype,
        prefill_chunk=prefill_chunk,
        prefix_reuse=kv_prefix_reuse,
        prefix_dram_gb=None if prefix_dram_gb is None else float(prefix_dram_gb),
        spec_draft=spec_draft,
        spec_ngram=spec_ngram,
        spec_hist=spec_hist,
        spec_method=spec_method,
        spec_heads=spec_heads,
        spec_draft_model=spec_draft_model,
        conf_signal=conf_signal,
        embed=embed,
        lora_rank=lora_rank,
        lora_slots=lora_slots,
        lora_targets=lora_targets,
        lora_adapters=lora_adapters,
        device=dev,
    )
    return GenerativeComponent(
        model,
        max_new_tokens=max_new_tokens,
        temperature=temperature,
        eos_id=eos_id,
        queue_max=queue_max,
        overlap=overlap,
        adapter=adapter,
    )
