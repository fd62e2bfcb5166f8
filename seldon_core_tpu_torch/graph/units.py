"""Component contract and the built-in graph units the port serves.

A *component* is the object behind a graph node, duck-typed as in
the JAX package's ``graph/units.py``: ``predict(X, feature_names)`` (or
``predict_raw(payload)``) for a MODEL, with optional ``tags()`` /
``metrics()`` merged into the response meta.  Any method may be
``async def``.

Built-ins: ``SIMPLE_MODEL`` (the stub model) and ``JAX_GENERATIVE``, whose
name is kept so that a graph spec the JAX engine serves is served
unchanged; here it builds the PyTorch generative component.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from seldon_core_tpu_torch.graph.spec import Implementation


class GraphUnitError(Exception):
    """A unit rejected its input or its configuration (maps to Status
    FAILURE on the wire)."""


class SeldonComponent:
    """Optional convenience base class; duck typing is what matters."""

    def tags(self) -> dict[str, Any]:
        return {}

    def metrics(self) -> list[dict[str, Any]]:
        return []


class SimpleModel(SeldonComponent):
    """Stub model returning a constant 3-class score row per input row."""

    values = np.array([0.1, 0.9, 0.5])
    class_names = ["class0", "class1", "class2"]

    def predict(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        rows = X.shape[0] if getattr(X, "ndim", 0) >= 2 else 1
        return np.tile(self.values, (rows, 1))


def _parse_dtype(raw: Any, impl_name: str):
    """Map a graph-parameter dtype string to a torch dtype (None = f32)."""
    import torch

    dtypes = {"bfloat16": torch.bfloat16, "float16": torch.float16,
              "float32": None, None: None}
    if raw not in dtypes:
        raise GraphUnitError(
            f"{impl_name} dtype must be one of {sorted(k for k in dtypes if k)}, "
            f"got {raw!r}"
        )
    return dtypes[raw]


def _torch_generative(parameters: dict[str, Any], device: str) -> Any:
    """JAX_GENERATIVE: continuous-batching token generation on the port.

    Graph parameters as the JAX package reads them: ``family`` (default
    "llama"), ``preset``, ``n_slots``, ``max_new_tokens``, ``temperature``,
    ``top_k``, ``eos_id``, ``dtype``, ``rng`` (weight seed), ``seq_impl``,
    ``decode_block``, ``decode_kernel``, ``kv_block_size``, ``kv_blocks``,
    ``queue_max``, plus model-config overrides.  Parameters of features the
    port does not serve yet raise (models/registry.py)."""
    from seldon_core_tpu_torch.models import registry

    params = dict(parameters)
    family = params.pop("family", "llama")
    dtype = _parse_dtype(params.pop("dtype", None), "JAX_GENERATIVE")
    try:
        return registry.build_generative_component(
            family, dtype=dtype, device=device, **params
        )
    except (KeyError, TypeError, ValueError) as e:
        raise GraphUnitError(str(e)) from e


_BUILTINS: dict[Implementation, Callable[..., Any]] = {
    Implementation.SIMPLE_MODEL: lambda params, device: SimpleModel(),
    Implementation.JAX_GENERATIVE: _torch_generative,
}


def create_builtin(impl: Implementation, parameters: dict[str, Any],
                   device: str = "cuda") -> Any:
    """Instantiate a built-in implementation with its typed parameters."""
    try:
        factory = _BUILTINS[impl]
    except KeyError:
        raise GraphUnitError(
            f"no built-in implementation {impl.value!r} in this engine; it serves "
            f"{sorted(i.value for i in _BUILTINS)}"
        ) from None
    return factory(parameters, device)


def has_builtin(impl: Implementation) -> bool:
    return impl in _BUILTINS
