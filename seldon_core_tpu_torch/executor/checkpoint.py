"""Parameter checkpoints: the port's copy of the JAX package's
``executor/checkpoint.py``, in the same file format byte for byte.

A checkpoint is one ``.npz`` holding ``arr_0..arr_N`` plus two JSON
records stored as ``uint8`` arrays: ``__skeleton__``, the container tree
with every leaf replaced by ``None`` (dicts, lists and tuples; no pickle,
so loading a checkpoint from an untrusted source cannot execute code), and
``__manifest__``, ``{"version": 2, "leaves": [{"dtype": ...}, ...]}``
with ``{"dtype": "none"}`` for a leaf that is a real ``None``.  Leaves are
numbered depth first with every dict's keys in sorted order, as
``jax.tree_util`` flattens them, so either package reads the other's
files and the same tree gives the same two records.  ``bfloat16`` is
stored as its ``uint16`` bit pattern.  Writes are atomic (a temporary file
in the same directory, then ``os.replace``).

Leaves may be numpy arrays (or anything ``np.asarray`` takes) or torch
tensors on any device.  A bf16 tensor is saved through its ``int16`` view,
and :func:`load_params` returns a bf16 leaf as a ``torch.bfloat16`` tensor
viewed from the stored bits (on the CPU; other leaves are numpy arrays,
as the JAX loader returns them), so no float32 copy is ever staged.  The
JAX package may write a flax ``FrozenDict`` node (``"frozendict"``); the
port has no flax, loads it as a plain dict and never writes one.  A
sharded load (``mesh``, ``param_axes``) belongs to the multi-GPU slice and
raises by name.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Mapping

import numpy as np
import torch

_SKELETON_KEY = "__skeleton__"
_MANIFEST_KEY = "__manifest__"
_FORMAT_VERSION = 2


def _flatten(node: Any, leaves: list) -> Any:
    """Pytree container structure -> JSON-safe skeleton, appending leaves
    depth first (dict keys sorted).  ``None`` marks a leaf slot."""
    if isinstance(node, dict) and type(node) is dict:
        try:
            keys = sorted(node)
        except TypeError:  # as jax.tree_util refuses a dict it cannot order
            raise ValueError("Comparator raised exception while sorting pytree "
                             "dictionary keys.") from None
        # str(k) coercion would silently corrupt int-keyed trees at load
        # time (params[0] -> params["0"]); fail at save time instead
        bad = [k for k in node if not isinstance(k, str)]
        if bad:
            raise TypeError(
                f"checkpoint dict keys must be str; got {bad[:3]!r} — "
                "JSON skeletons cannot round-trip non-string keys"
            )
        return {"t": "dict", "items": {k: _flatten(node[k], leaves) for k in keys}}
    if isinstance(node, tuple):
        if hasattr(node, "_fields"):  # namedtuple: would flatten to tuple
            raise TypeError(
                f"checkpoint skeleton contains namedtuple {type(node).__name__}; "
                "convert to dict/tuple before save_params (a JSON skeleton "
                "cannot reconstruct the class)"
            )
        return {"t": "tuple", "items": [_flatten(v, leaves) for v in node]}
    if isinstance(node, list):
        return {"t": "list", "items": [_flatten(v, leaves) for v in node]}
    if isinstance(node, Mapping):
        raise TypeError(
            f"checkpoint skeleton contains unsupported container {type(node)!r}; "
            "supported: dict, list, tuple"
        )
    leaves.append(node)
    return None


def _host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf -> (the array to store, its manifest dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.hasobject:  # np.savez would pickle it
        raise TypeError(f"checkpoint leaf of type {type(leaf)!r} is not an array")
    name = arr.dtype.name
    if name == "bfloat16":  # an ml_dtypes array
        arr = arr.view(np.uint16)
    return arr, name


def save_params(path: str, params: Any) -> int:
    """Write ``params`` to ``path`` (.npz); returns the number of leaves.
    The write is atomic: readers never see a partial checkpoint."""
    leaves: list = []
    skeleton = _flatten(params, leaves)
    arrays: dict[str, np.ndarray] = {}
    manifest: list[dict[str, Any]] = []
    for i, leaf in enumerate(leaves):
        if leaf is None:
            manifest.append({"dtype": "none"})
            continue
        arrays[f"arr_{i}"], name = _host_array(leaf)
        manifest.append({"dtype": name})
    arrays[_SKELETON_KEY] = np.frombuffer(json.dumps(skeleton).encode(), dtype=np.uint8)
    arrays[_MANIFEST_KEY] = np.frombuffer(
        json.dumps({"version": _FORMAT_VERSION, "leaves": manifest}).encode(), dtype=np.uint8,
    )
    out_dir = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return len(leaves)


def _unflatten(node: Any, leaves) -> Any:
    if node is None:
        return next(leaves)
    kind = node["t"]
    if kind in ("dict", "frozendict"):
        return {k: _unflatten(v, leaves) for k, v in node["items"].items()}
    if kind == "tuple":
        return tuple(_unflatten(v, leaves) for v in node["items"])
    if kind == "list":
        return [_unflatten(v, leaves) for v in node["items"]]
    raise ValueError(f"unknown skeleton node kind {kind!r}")


def load_params(path: str, *, mesh: Any = None, param_axes: Any = None) -> Any:
    """Read a checkpoint back into its tree: numpy leaves, bf16 leaves as
    CPU ``torch.bfloat16`` tensors over the stored bits."""
    if mesh is not None or param_axes is not None:
        raise NotImplementedError(
            "load_params(mesh=, param_axes=): a sharded load is not served by the "
            "PyTorch port yet"
        )
    with np.load(path, allow_pickle=False) as z:
        skeleton = json.loads(z[_SKELETON_KEY].tobytes().decode())
        manifest = json.loads(z[_MANIFEST_KEY].tobytes().decode())
        if manifest.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {manifest.get('version')!r}")
        leaves = []
        for i, entry in enumerate(manifest["leaves"]):
            if entry["dtype"] == "none":
                leaves.append(None)
                continue
            arr = z[f"arr_{i}"]
            if entry["dtype"] == "bfloat16":
                arr = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
                    torch.bfloat16)
            leaves.append(arr)
    return _unflatten(skeleton, iter(leaves))
