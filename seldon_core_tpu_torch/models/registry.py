"""Model-family registry: the zoo's predict units (JAX_MODEL) and the
generative unit (JAX_GENERATIVE).

The counterpart of the JAX package's ``models/registry.py``:
``build_component`` builds a :class:`ModelComponent` over a
:class:`CompiledModel` of one zoo family (``mlp``, ``cnn``, ``resnet``,
``bert``) and preset, and ``build_generative_component`` the llama
family's generative unit.  Graph parameters of features the port does not
serve yet raise :class:`GraphUnitError` naming themselves whenever they
are set to anything but their off value; none is ever ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from seldon_core_tpu_torch import resolve_device
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.models import bert, cnn, llama, mlp, resnet
from seldon_core_tpu_torch.models.weights import init_params, params_from_jax, zoo_from_flax


@dataclasses.dataclass(frozen=True)
class Family:
    """One zoo family: its config, module class, seeded init, presets and
    the warm-up input a batch of its rows looks like."""

    config_cls: type
    module: type
    init_params: Callable  # (cfg, generator, dtype, device) -> module
    presets: dict[str, Callable[[], Any]]
    example_input: Callable[[Any, int], np.ndarray]  # (cfg, batch) -> array


def _f32(shape):
    return np.zeros(shape, np.float32)


FAMILIES: dict[str, Family] = {
    "mlp": Family(
        mlp.Config, mlp.MLP, mlp.init_params,
        presets={"default": mlp.Config,
                 "tiny": lambda: mlp.Config(in_features=16, hidden=32, n_classes=3)},
        example_input=lambda c, b: _f32((b, c.in_features)),
    ),
    "cnn": Family(
        cnn.Config, cnn.CNN, cnn.init_params,
        presets={"default": cnn.Config, "tiny": lambda: cnn.Config(image_size=8, hidden=32)},
        example_input=lambda c, b: _f32((b, c.image_size * c.image_size * c.channels)),
    ),
    "resnet": Family(
        resnet.Config, resnet.ResNet, resnet.init_params,
        presets={"resnet50": resnet.Config,
                 "tiny": lambda: resnet.Config(stage_sizes=(1, 1), width=8, n_classes=10,
                                               image_size=32)},
        example_input=lambda c, b: _f32((b, c.image_size, c.image_size, c.channels)),
    ),
    "bert": Family(
        bert.Config, bert.Bert, bert.init_params,
        presets={"base": bert.Config,
                 "tiny": lambda: bert.Config(vocab_size=128, hidden=32, n_layers=2, n_heads=2,
                                             ffn=64, max_len=64)},
        example_input=lambda c, b: np.ones((b, 16), np.int32),
    ),
}


def get_family(name: str) -> Family:
    try:
        return FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown model family {name!r}; have {sorted(FAMILIES)}") from None


def resolve_family_config(family: str, preset: str | None = None, **overrides) -> Any:
    """A zoo family's config: the preset (default: the config's defaults)
    with ``overrides`` of its fields; an unknown field raises TypeError."""
    fam = get_family(family)
    if preset is None:
        cfg = fam.config_cls()
    else:
        try:
            cfg = fam.presets[preset]()
        except KeyError:
            raise KeyError(f"unknown {family} preset {preset!r}; have "
                           f"{sorted(fam.presets)}") from None
    if overrides:
        fields = {f.name for f in dataclasses.fields(fam.config_cls)}
        unknown = sorted(set(overrides) - fields)
        if unknown:
            raise TypeError(f"unknown JAX_MODEL parameters {unknown} for family {family!r} "
                            f"(config fields: {sorted(fields)})")
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def example_input(family: str, cfg: Any, batch: int = 1) -> np.ndarray:
    return get_family(family).example_input(cfg, batch)


def _resolve_params(params: Any, checkpoint: str | None) -> Any:
    """Explicit params, then the ``checkpoint``'s tree, then None (the
    caller makes seeded weights), as the JAX registry resolves them.  A
    file that cannot be read as a checkpoint raises by name."""
    from seldon_core_tpu_torch.executor.checkpoint import load_params

    if params is not None or _is_off(checkpoint):
        return params
    try:
        return load_params(str(checkpoint))
    except (OSError, ValueError, KeyError) as e:
        raise GraphUnitError(f"checkpoint {checkpoint!r} cannot be read: {e}") from e


def _fit_checkpoint(build: Callable, what: str, checkpoint: str | None):
    """Run ``build()`` (weights onto the module); a checkpoint's tree that
    does not fit the resolved config raises by name."""
    try:
        return build()
    except (KeyError, ValueError, TypeError, AttributeError) as e:
        if _is_off(checkpoint):
            raise
        raise GraphUnitError(f"checkpoint {checkpoint!r} does not fit the {what}: {e}") from e


def build_compiled(family: str, *, preset: str | None = None, cfg: Any = None, rng: int = 0,
                   dtype: torch.dtype | None = None, buckets=None, params: Any = None,
                   checkpoint: str | None = None, device: str = "cuda", **overrides):
    """A :class:`CompiledModel` of ``family`` on ``device``.  ``params`` is
    the family's port module or the JAX package's flax variables tree;
    without it the weights come from ``checkpoint`` (an npz of
    ``executor/checkpoint.py``, written by either package), else from the
    seed ``rng``."""
    from seldon_core_tpu_torch.executor.compiled import BucketSpec, CompiledModel

    fam = get_family(family)
    dev = resolve_device(device)
    if cfg is None:
        cfg = resolve_family_config(family, preset, **overrides)
    elif overrides:
        # an explicit cfg leaves nothing for overrides to apply to
        raise TypeError(f"unknown JAX_MODEL parameters {sorted(overrides)} for family "
                        f"{family!r} (config fields: "
                        f"{sorted(f.name for f in dataclasses.fields(fam.config_cls))})")
    params = _resolve_params(params, checkpoint)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(int(rng))
        module = fam.init_params(cfg, gen, dtype=None, device=dev)
    elif isinstance(params, fam.module):
        module = params
    else:
        module = _fit_checkpoint(lambda: zoo_from_flax(family, params, cfg, device=dev),
                                 f"{family} config {cfg}", checkpoint)
    return CompiledModel(module, buckets=buckets or BucketSpec(), dtype=dtype,
                         name=f"{family}:{preset or 'default'}", device=dev)


def build_component(family: str, *, preset: str | None = None, cfg: Any = None,
                    class_names: list[str] | None = None, batching: bool = True,
                    max_batch: int = 64, max_delay_ms: float = 2.0,
                    max_queue: int | None = None, input_dtype: str | None = None,
                    input_shape: tuple[int, ...] | None = None, **kwargs):
    """A JAX_MODEL graph unit: a :class:`ModelComponent` over
    :func:`build_compiled` (``kwargs``: its options and the family's config
    overrides).  ``input_dtype`` (e.g. ``"uint8"`` images, normalized on
    the device) warms the buckets for that wire dtype, and ``input_shape``
    for that row shape (e.g. ``(128,)``: BERT rows of 128 tokens; the
    family's example row otherwise, 16 tokens for BERT)."""
    from seldon_core_tpu_torch.executor.component import ModelComponent

    if cfg is None:
        # resolved here so that the warm-up example comes from the same config
        fields = {f.name for f in dataclasses.fields(get_family(family).config_cls)}
        overrides = {k: kwargs.pop(k) for k in list(kwargs) if k in fields}
        cfg = resolve_family_config(family, preset, **overrides)
    # leftovers must be build_compiled options: anything else raises there
    model = build_compiled(family, preset=preset, cfg=cfg, **kwargs)
    warmup = example_input(family, cfg, 1)
    if input_shape is not None:
        warmup = np.ones((1,) + tuple(input_shape), warmup.dtype)
    if input_dtype is not None:
        warmup = warmup.astype(np.dtype(input_dtype))
    return ModelComponent(model, class_names=class_names, batching=batching,
                          max_batch=max_batch, max_delay_ms=max_delay_ms,
                          max_queue=max_queue, warmup_example=warmup)


PRESETS = {
    "llama3-8b": llama.Config.llama3_8b,
    "llama3-1b": llama.Config.llama3_1b,
    "tiny": llama.Config.tiny,
}

# parameters of the JAX package's generative unit that belong to later
# slices of the port (the mesh: multi-GPU)
LATER_SLICE_PARAMS = ("mesh",)


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
    checkpoint: str | None = None,
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
    spec_heads_path: str | None = None,
    spec_draft_model: str | None = None,
    overlap: bool | None = None,
    conf_signal: bool | None = None,
    embed: bool | None = None,
    lora_rank: int | None = None,
    lora_slots: int | None = None,
    lora_targets: str | None = None,
    lora_adapters: Any = None,
    adapter: str | None = None,
    pack_class: str | None = None,
    pack_slo_ms: float | None = None,
    device: str = "cuda",
    **overrides,
):
    """Build a continuous-batching generative graph unit on ``device``.

    ``params`` is a :class:`~seldon_core_tpu_torch.models.llama.Llama` or
    the JAX package's ``init_params`` pytree; without it the weights come
    from ``checkpoint`` (an npz of ``executor/checkpoint.py`` written by
    either package, or by ``models/convert.py``; a tree whose shapes do
    not fit the resolved config raises by name), else from the seed
    ``rng``.  On ``cuda`` the attention runs
    in the hand-written kernels only: ``seq_impl`` must be ``"flash"`` and
    ``decode_kernel`` True.  ``kv_cache_dtype="int8"`` stores the paged pool
    quantized with per-(position, head) scales, ``kv_prefix_reuse`` shares
    prompt-prefix KV blocks across requests and ``prefill_chunk`` prefills
    long prompts in chunks paced between decode blocks, as in the JAX
    package; ``prefix_dram_gb`` (with ``kv_prefix_reuse``; env
    ``SCT_PREFIX_DRAM_GB``) keeps evicted prefix blocks in that many GiB of
    host DRAM and promotes them back on a match.  ``spec_draft`` turns on speculative decoding with the
    proposer ``spec_method`` (``ngram``, ``heads`` with ``spec_heads``
    heads made from the model's ``lm_head`` or trained heads read from
    ``spec_heads_path``, or ``draft`` with ``spec_draft_model``);
    ``spec_ngram``/``spec_hist`` size the n-gram proposer.  ``overlap`` (default on when ``decode_block > 1``; env
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
    overrides.  ``pack_class`` (``interactive`` or ``batch``) and
    ``pack_slo_ms`` are the deployment's QoS class and queue-wait SLO band
    on a packed card, read when the engine registers co-resident
    deployments with the device arbiter (``ENGINE_CO_PREDICTORS``, or
    ``SCT_PACK=1``); a packed ``spec_method='draft'`` defers its draft
    model's prompt prefills to the scheduler's sync points, under a
    second, batch-class registrant."""
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
    params = _resolve_params(params, checkpoint)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(int(rng))
        model_params = init_params(cfg, gen, dtype=dtype or torch.float32, device=dev)
    elif isinstance(params, llama.Llama):
        model_params = params
    else:
        model_params = _fit_checkpoint(
            lambda: params_from_jax(params, cfg, dtype=dtype, device=dev),
            f"llama config {cfg}", checkpoint)
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
        spec_heads_path=spec_heads_path,
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
        pack_class=pack_class,
        pack_slo_ms=None if _is_off(pack_slo_ms) else float(pack_slo_ms),
    )
