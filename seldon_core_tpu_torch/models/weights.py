"""Llama weights for the port: carried over from the JAX package's pytree,
or made from a seed.

``params_from_jax`` takes the nested dict the JAX package's
``models/llama.py::init_params`` returns (as numpy arrays, or anything ``np.asarray``
accepts) and builds a :class:`~seldon_core_tpu_torch.models.llama.Llama`
key by key with the stacked layout kept, so the two frameworks run the
same numbers.  ``init_params`` makes full-width weights from a
``torch.Generator`` directly on the device, with the JAX package's
initial distribution (normal / sqrt(hidden), norms at one); the numbers
differ from JAX's, since the generators do.  ``medusa_heads_from_jax``
carries the JAX package's Medusa head block (``{"w1", "head"}``) the same
way, for a model that drafts with those heads, and ``lora_from_jax`` the
JAX package's stacked LoRA adapter pool or one adapter's factors
(``{target: {"a", "b"}}``), so both frameworks serve the same adapters.

``zoo_from_flax`` carries a zoo family's flax variables (``{"params":
..., "batch_stats": ...}``) onto the port's module of that family, whose
attribute paths are flax's module paths.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.models import zoo
from seldon_core_tpu_torch.models.llama import LAYER_KEYS, Config, Llama, param_shapes


def _flatten(tree: dict) -> dict:
    flat = {}
    for key, value in tree.items():
        if key == "layers":
            for lk in LAYER_KEYS:
                flat[f"layers/{lk}"] = value[lk]
        else:
            flat[key] = value
    return flat


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    # a writable copy (device arrays export read-only views); float types
    # numpy lacks (ml_dtypes bfloat16) arrive as float32
    a = np.array(a, dtype=a.dtype if a.dtype.kind == "f" else np.float32)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: Config, *, dtype=None, device="cpu") -> Llama:
    """The JAX ``init_params`` pytree -> :class:`Llama` on ``device``.
    ``dtype`` None keeps each array's float type (bf16 arrays, which numpy
    cannot hold natively, arrive as float32)."""
    tensors = {key: _tensor(arr, dtype, device) for key, arr in _flatten(tree).items()}
    return Llama(cfg, tensors)


def medusa_heads_from_jax(heads: dict, dtype=None, device="cpu") -> dict:
    """The JAX ``init_medusa_heads`` block (``w1 (K, E, E)``, ``head (K, E,
    V)``) -> the same dict of tensors on ``device``."""
    if set(heads) != {"w1", "head"}:
        raise ValueError(f"Medusa heads need keys ['head', 'w1'], got {sorted(heads)}")
    return {key: _tensor(heads[key], dtype, device) for key in ("w1", "head")}


def lora_from_jax(tree: dict, dtype=None, device="cpu") -> dict:
    """The JAX ``init_lora_params`` pool (``{target: {"a": (L, A, in.., r),
    "b": (L, A, r, out..)}}``) or one adapter's ``lora_adapter_factors``
    (``(L, in.., r)`` / ``(L, r, out..)``) -> the same dict of tensors on
    ``device``."""
    out = {}
    for target, fac in tree.items():
        if set(fac) != {"a", "b"}:
            raise ValueError(f"LoRA target {target!r} needs keys ['a', 'b'], got {sorted(fac)}")
        out[target] = {key: _tensor(fac[key], dtype, device) for key in ("a", "b")}
    return out


@torch.no_grad()
def init_params(cfg: Config, generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> Llama:
    """Seeded full-width weights, made on ``device`` one tensor at a time
    (the f32 staging copy never exceeds the largest single weight)."""
    s = 1.0 / math.sqrt(cfg.hidden)
    tensors = {}
    for key, shape in param_shapes(cfg).items():
        if key in ("ln_f", "layers/ln_att", "layers/ln_mlp"):
            tensors[key] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            tensors[key] = w.mul_(s).to(dtype)
    return Llama(cfg, tensors)


def _flat_tree(tree: Mapping, prefix: str = "") -> dict:
    """A nested flax variables mapping -> ``{"params/a/b/kernel": leaf}``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flat_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def _zoo_sources(module: nn.Module) -> dict:
    """Port state key -> (flax variable path, layout change) for every
    weight of a zoo module: flax's ``Dense``/``DenseGeneral`` kernels are
    ``(in.., out..)`` where ``Linear.weight`` is ``(out, in)``, ``Conv``
    kernels HWIO where torch's are OIHW, ``Embed`` tables and norms carry
    over as they are, and BatchNorm's statistics live in ``batch_stats``."""
    def linear(w, shape):
        return w.reshape(shape[1], shape[0]).T

    def hwio(w, shape):
        return w.transpose(3, 2, 0, 1)

    def same(w, shape):
        return w.reshape(shape)

    leaves = {
        nn.Linear: {"weight": ("params", "kernel", linear), "bias": ("params", "bias", same)},
        nn.Conv2d: {"weight": ("params", "kernel", hwio), "bias": ("params", "bias", same)},
        nn.Embedding: {"weight": ("params", "embedding", same)},
        nn.LayerNorm: {"weight": ("params", "scale", same), "bias": ("params", "bias", same)},
        zoo.BatchNorm: {"scale": ("params", "scale", same), "bias": ("params", "bias", same),
                        "mean": ("batch_stats", "mean", same),
                        "var": ("batch_stats", "var", same)},
    }
    sources = {}
    for path, mod in module.named_modules():
        for name, (collection, leaf, layout) in leaves.get(type(mod), {}).items():
            if getattr(mod, name, None) is not None:
                flax_path = "/".join([collection, *path.split("."), leaf])
                sources[f"{path}.{name}"] = (flax_path, layout)
    return sources


@torch.no_grad()
def zoo_from_flax(family: str, variables: Mapping[str, Any], cfg, *, dtype=None,
                  device="cpu") -> nn.Module:
    """The JAX package's ``init_params`` variables of a zoo family (numpy
    leaves, or anything ``np.asarray`` accepts) -> the port's module of that
    family on ``device``, key by key.  ``dtype`` None keeps each array's
    float type (bf16 arrays, which numpy cannot hold natively, arrive as
    float32).  A key the module needs and the tree lacks, or one the tree
    holds and the module has no place for, raises ``KeyError`` naming it."""
    from seldon_core_tpu_torch.models.registry import get_family

    with torch.device(device):
        module = get_family(family).module(cfg)
    flat = _flat_tree(variables)
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    for key, (flax_path, layout) in _zoo_sources(module).items():
        if flax_path not in flat:
            raise KeyError(f"{family} flax variables lack {flax_path!r} (the port's {key})")
        shape = tuple(state[key].shape)
        arr = np.asarray(flat.pop(flax_path))
        try:
            arr = layout(arr, shape)
            if arr.shape != shape:
                raise ValueError(f"{arr.shape} after the layout change")
        except ValueError as e:
            raise ValueError(f"{family} flax variable {flax_path!r} of shape {arr.shape} "
                             f"does not fit the port's {key} {shape}: {e}") from None
        t = _tensor(arr, dtype, device)
        owner, _, name = key.rpartition(".")
        sub = module.get_submodule(owner)
        if name in sub._parameters:
            sub._parameters[name] = nn.Parameter(t, requires_grad=False)
        else:
            sub._buffers[name] = t
    if flat:
        raise KeyError(f"{family} flax variables hold {sorted(flat)}, which the port's "
                       f"{family} has no place for")
    return module.eval().requires_grad_(False)
