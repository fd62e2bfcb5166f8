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

The other direction, so that the port writes what the JAX package reads:
``params_to_jax`` gives a :class:`Llama`'s pytree and ``zoo_to_flax`` a zoo
module's flax variables.  Every bridge takes what either package's
``load_params`` returns (numpy, ml_dtypes bfloat16 or torch leaves) and
carries bf16 through bit for bit.
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


def _host_tensor(arr) -> torch.Tensor:
    """A leaf as a torch tensor with its bits kept: a tensor as it is, a
    bfloat16 array (ml_dtypes) viewed through its 16-bit pattern, a float
    array copied (device arrays export read-only views), anything else
    as float32."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=a.dtype if a.dtype.kind == "f" else np.float32))


def _tensor(arr, dtype, device) -> torch.Tensor:
    t = _host_tensor(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: Config, *, dtype=None, device="cpu") -> Llama:
    """The JAX ``init_params`` pytree (numpy, ml_dtypes bfloat16 or torch
    leaves: what either package's ``load_params`` returns) -> :class:`Llama`
    on ``device``.  ``dtype`` None keeps each leaf's float type, bf16 bit
    for bit."""
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


def params_to_jax(model: Llama) -> dict:
    """:class:`Llama` -> the JAX ``init_params`` pytree (``tok_emb``, the
    stacked ``layers/{LAYER_KEYS}``, ``ln_f``, ``head``) of the module's own
    tensors, no copy: what ``save_params`` writes for the JAX package's
    ``load_params`` and ``build_generative_component(params=...)``."""
    return {"tok_emb": model.tok_emb.data,
            "layers": {k: model.layers[k].data for k in LAYER_KEYS},
            "ln_f": model.ln_f.data, "head": model.head.data}


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
    """Port state key -> (flax variable path, flax shape, kind) for every
    weight of a zoo module.  ``kind`` is the layout change: flax's
    ``Dense``/``DenseGeneral`` kernels are ``(in.., out..)`` where
    ``Linear.weight`` is ``(out, in)`` (``"linear"``), ``Conv`` kernels HWIO
    where torch's are OIHW (``"hwio"``); ``Embed`` tables and norms carry
    over as they are, and BatchNorm's statistics live in ``batch_stats``.
    BERT's ``query``/``key``/``value``/``out`` are ``DenseGeneral`` over
    ``(heads, head_dim)``: the flax shape splits that axis."""
    from seldon_core_tpu_torch.models import bert

    leaves = {
        nn.Linear: {"weight": ("params", "kernel", "linear"), "bias": ("params", "bias", "same")},
        nn.Conv2d: {"weight": ("params", "kernel", "hwio"), "bias": ("params", "bias", "same")},
        nn.Embedding: {"weight": ("params", "embedding", "same")},
        nn.LayerNorm: {"weight": ("params", "scale", "same"), "bias": ("params", "bias", "same")},
        zoo.BatchNorm: {"scale": ("params", "scale", "same"), "bias": ("params", "bias", "same"),
                        "mean": ("batch_stats", "mean", "same"),
                        "var": ("batch_stats", "var", "same")},
    }
    heads = {}  # a DenseGeneral's submodule path -> (heads, head_dim)
    for path, mod in module.named_modules():
        if isinstance(mod, bert.SelfAttention):
            for proj in ("query", "key", "value", "out"):
                heads[f"{path}.{proj}"] = (mod.cfg.n_heads, mod.cfg.head_dim)
    sources = {}
    for path, mod in module.named_modules():
        for name, (collection, leaf, kind) in leaves.get(type(mod), {}).items():
            t = getattr(mod, name, None)
            if t is None:
                continue
            shape = tuple(t.shape)
            if kind == "linear":
                shape = (shape[1], shape[0])
            elif kind == "hwio":
                shape = (shape[2], shape[3], shape[1], shape[0])
            if path in heads:  # DenseGeneral: (E, H, D) in, (H, D, E) out
                hd = heads[path]
                if path.endswith(".out"):
                    shape = hd + shape[1:] if name == "weight" else shape
                else:
                    shape = shape[:-1] + hd if name == "weight" else hd
            flax_path = "/".join([collection, *path.split("."), leaf])
            sources[f"{path}.{name}"] = (flax_path, shape, kind)
    return sources


def _to_port(w: torch.Tensor, kind: str, shape: tuple) -> torch.Tensor:
    """A flax variable -> the port's tensor of ``shape``."""
    if kind == "linear":
        return w.reshape(shape[1], shape[0]).T
    if kind == "hwio":
        return w.permute(3, 2, 0, 1)
    return w.reshape(shape)


def _to_flax(t: torch.Tensor, kind: str, flax_shape: tuple) -> torch.Tensor:
    """The port's tensor -> the flax variable of ``flax_shape``."""
    if kind == "linear":
        t = t.T
    elif kind == "hwio":
        t = t.permute(2, 3, 1, 0)
    return t.reshape(flax_shape)


@torch.no_grad()
def zoo_from_flax(family: str, variables: Mapping[str, Any], cfg, *, dtype=None,
                  device="cpu") -> nn.Module:
    """The JAX package's ``init_params`` variables of a zoo family (numpy,
    ml_dtypes bfloat16 or torch leaves: what either package's
    ``load_params`` returns, a FrozenDict included) -> the port's module of
    that family on ``device``, key by key.  ``dtype`` None keeps each
    leaf's float type, bf16 bit for bit.  A key the module needs and the
    tree lacks, or one the tree holds and the module has no place for,
    raises ``KeyError`` naming it."""
    from seldon_core_tpu_torch.models.registry import get_family

    with torch.device(device):
        module = get_family(family).module(cfg)
    flat = _flat_tree(variables)
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    for key, (flax_path, flax_shape, kind) in _zoo_sources(module).items():
        if flax_path not in flat:
            raise KeyError(f"{family} flax variables lack {flax_path!r} (the port's {key})")
        shape = tuple(state[key].shape)
        w = _host_tensor(flat.pop(flax_path))
        if tuple(w.shape) != flax_shape:
            raise ValueError(f"{family} flax variable {flax_path!r} of shape {tuple(w.shape)} "
                             f"does not fit the port's {key} {shape} (flax shape {flax_shape})")
        t = _to_port(w, kind, shape).contiguous().to(device=device, dtype=dtype or w.dtype)
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


@torch.no_grad()
def zoo_to_flax(family: str, module: nn.Module) -> dict:
    """The port's module of a zoo family -> the JAX package's variables of
    that family (``{"params": ..., "batch_stats": ...}``, nested dicts of
    contiguous CPU tensors in flax's shapes, each in the module's dtype):
    what ``save_params`` writes for the JAX package's ``load_params`` and
    ``build_compiled(params=...)``, and :func:`zoo_from_flax` inverts."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    out: dict = {}
    for key, (flax_path, flax_shape, kind) in _zoo_sources(module).items():
        *parents, leaf = flax_path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_flax(state[key].detach(), kind, flax_shape).contiguous().cpu()
    if not out:
        raise KeyError(f"a {family} module holds no weight the flax layout has")
    return out
