"""KV handoff codec and its engine-side helpers.

The port's copy of the JAX package's ``disagg/handoff.py``, byte for byte
on the wire.  One handoff frame carries what a decode engine needs to go
on with a generation another engine prefilled: the prompt ids, the first
sampled token, the request's generation options, and the prompt's paged-KV
blocks as raw little-endian segments, in the step framing of
``executor/multihost.py`` under the key :data:`HANDOFF_KEY`.  A prefix-
chain frame (:data:`PREFIX_KEY`) carries one prefix chain's tokens and
full blocks for a peer replica's pull.

bfloat16 travels as its uint16 bit patterns and is viewed back at the
reader (torch views here; the JAX package uses ``ml_dtypes``), so a
handoff is bit-exact in every serving dtype.  An int8 pool's blocks and
scales travel verbatim.

Versions (``hv``): v1 float blocks; v2 the int8 layout; v3 the optional
tracing and QoS envelope (``traceparent``, ``origin_span``,
``deadline_ms``, ``priority``): written when a caller passes them and
kept when read, but the port has no tracing or QoS plane yet, so its own
frames leave them out and an import ignores them; v4 the optional
``adapter``, the LoRA adapter the KV was made through: the port's frames
write it, and a decode pool imports it only when that adapter is resident
there (:func:`check_pool` refuses it by name otherwise); v5 the optional
speculation envelope (``spec_method``, the Medusa ``spec_hlast``).  A
prefix-chain frame carries its chain's adapter the same way: the chain's
keys are salted with it on both engines.

Decoded blocks come back as torch CPU tensors in their own dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch.executor.multihost import decode_step, encode_step

HANDOFF_KEY = "sct:kv-handoff"
HANDOFF_VERSION = 5
PREFIX_KEY = "sct:kv-prefix"
PREFIX_VERSION = 1

_FLOAT_NAMES = ("float32", "float16", "bfloat16")


class HandoffError(Exception):
    """A frame that cannot be applied here: wrong key, a pool of another
    geometry or layout, an adapter this engine does not serve, or missing
    fields.  The sender falls back to local decode."""


def _pack_kv(x) -> tuple[np.ndarray, str]:
    """(frameable array, dtype name) of a torch tensor or numpy array;
    bfloat16 rides as uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.ascontiguousarray(x)
    name = str(x.dtype)
    return (x.view(np.uint16), name) if name == "bfloat16" else (x, name)


def _unpack_kv(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The torch tensor a frame segment holds (bfloat16 from its bits)."""
    arr = np.asarray(arr)
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise HandoffError(f"bfloat16 segment framed as {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if dtype_name not in _FLOAT_NAMES + ("int8",) or str(arr.dtype) != dtype_name:
        raise HandoffError(f"segment of dtype {arr.dtype} is not the frame's {dtype_name!r}")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _put_scales(payload: dict, k_scale, v_scale) -> None:
    ks, scale_dtype = _pack_kv(k_scale)
    vs, _ = _pack_kv(v_scale)
    payload["kv_quant"] = "int8"
    payload["scale_dtype"] = scale_dtype
    payload["k_scale"] = ks
    payload["v_scale"] = vs


def _read_blocks(payload: dict, what: str) -> None:
    """Views the frame's K/V (and int8 scales) back to tensors, in place."""
    kv_dtype = str(payload["kv_dtype"])
    payload["k"] = _unpack_kv(payload["k"], kv_dtype)
    payload["v"] = _unpack_kv(payload["v"], kv_dtype)
    if payload.get("kv_quant"):
        if str(payload["kv_quant"]) != "int8":
            raise HandoffError(f"unknown kv_quant {payload['kv_quant']!r} in {what} frame")
        for field in ("k_scale", "v_scale", "scale_dtype"):
            if field not in payload:
                raise HandoffError(f"{what} frame missing field {field!r}")
        sdt = str(payload["scale_dtype"])
        payload["k_scale"] = _unpack_kv(payload["k_scale"], sdt)
        payload["v_scale"] = _unpack_kv(payload["v_scale"], sdt)


def encode_handoff(
    prompt: np.ndarray,
    first_token: int,
    k,
    v,
    *,
    block_size: int,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: int | None = None,
    k_scale=None,
    v_scale=None,
    traceparent: str | None = None,
    origin_span: str | None = None,
    deadline_ms: float | None = None,
    priority: str | None = None,
    adapter: str | None = None,
    spec_state: dict[str, Any] | None = None,
) -> bytes:
    """Frame one prefilled request.  ``k``/``v`` are ``(layers,
    n_prompt_blocks, block_size, kv_heads, head_dim)`` (what
    ``GenerativeModel.export_slot_kv`` returns); from an int8 pool pass the
    int8 blocks with ``k_scale``/``v_scale (layers, n_prompt_blocks,
    block_size, kv_heads)``.  The fields and their order are the JAX
    encoder's, so equal inputs give equal bytes."""
    k, kv_dtype = _pack_kv(k)
    v, _ = _pack_kv(v)
    payload: dict[str, Any] = {
        "prompt": np.asarray(prompt, np.int32).ravel(),
        "first_token": int(first_token),
        "block_size": int(block_size),
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature),
        "eos_id": int(eos_id) if eos_id is not None else None,
        "kv_dtype": kv_dtype,
        "hv": HANDOFF_VERSION,
        "k": k,
        "v": v,
    }
    if traceparent:
        payload["traceparent"] = str(traceparent)
    if origin_span:
        payload["origin_span"] = str(origin_span)
    if deadline_ms is not None:
        payload["deadline_ms"] = max(1.0, float(deadline_ms))
    if priority:
        payload["priority"] = str(priority)
    if adapter:
        payload["adapter"] = str(adapter)
    if spec_state and spec_state.get("method"):
        # v5: warm proposer state for the importer's first pass; dropping
        # it costs acceptance, never output
        payload["spec_method"] = str(spec_state["method"])
        hlast = spec_state.get("hlast")
        if hlast is not None:
            hl, hl_dtype = _pack_kv(hlast)
            payload["spec_hlast"] = hl
            payload["spec_hlast_dtype"] = hl_dtype
    if k_scale is not None:
        _put_scales(payload, k_scale, v_scale)
    return encode_step(HANDOFF_KEY, payload)


def decode_handoff(buf: bytes) -> dict[str, Any]:
    """Inverse of :func:`encode_handoff`.  A frame of another key, a
    version newer than :data:`HANDOFF_VERSION` or a missing field raises
    :class:`HandoffError`; a torn frame, a wrong magic or a framing
    version skew raises ``ValueError``.  A v1 frame (no ``hv``) reads as
    the float layout."""
    key, payload = decode_step(buf)
    if key != HANDOFF_KEY:
        raise HandoffError(f"frame key {key!r} is not a KV handoff")
    hv = int(payload.get("hv", 1))
    if hv > HANDOFF_VERSION:
        raise HandoffError(
            f"handoff codec version {hv} is newer than this engine's {HANDOFF_VERSION}; "
            "refusing to guess at the KV layout"
        )
    for field in ("prompt", "first_token", "block_size", "k", "v", "kv_dtype"):
        if field not in payload:
            raise HandoffError(f"handoff frame missing field {field!r}")
    _read_blocks(payload, "handoff")
    if payload.get("spec_method"):
        spec: dict[str, Any] = {"method": str(payload["spec_method"])}
        if "spec_hlast" in payload:
            spec["hlast"] = _unpack_kv(payload["spec_hlast"],
                                       str(payload.get("spec_hlast_dtype", "float32")))
        payload["spec_state"] = spec
    return payload


def encode_prefix_chain(tokens: np.ndarray, k, v, *, block_size: int, k_scale=None,
                        v_scale=None, adapter: str | None = None) -> bytes:
    """Frame one prefix chain for a peer pull: ``k``/``v`` are ``(layers,
    depth, block_size, kv_heads, head_dim)``, shallowest level first, in
    the pool's storage representation; ``tokens`` the ``depth *
    block_size`` ids they cover (longer input is cut)."""
    tokens = np.asarray(tokens, np.int32).ravel()
    depth = int(k.shape[1])
    k, kv_dtype = _pack_kv(k)
    v, _ = _pack_kv(v)
    payload: dict[str, Any] = {
        "tokens": tokens[: depth * int(block_size)],
        "depth": depth,
        "block_size": int(block_size),
        "kv_dtype": kv_dtype,
        "pv": PREFIX_VERSION,
        "k": k,
        "v": v,
    }
    if adapter:
        payload["adapter"] = str(adapter)
    if k_scale is not None:
        _put_scales(payload, k_scale, v_scale)
    return encode_step(PREFIX_KEY, payload)


def decode_prefix_chain(buf: bytes) -> dict[str, Any]:
    """Inverse of :func:`encode_prefix_chain`, with :func:`decode_handoff`'s
    failure rules; a depth that does not match the blocks or the tokens
    raises :class:`HandoffError`."""
    key, payload = decode_step(buf)
    if key != PREFIX_KEY:
        raise HandoffError(f"frame key {key!r} is not a prefix chain")
    pv = int(payload.get("pv", 1))
    if pv > PREFIX_VERSION:
        raise HandoffError(
            f"prefix codec version {pv} is newer than this engine's {PREFIX_VERSION}; "
            "refusing to guess at the KV layout"
        )
    for field in ("tokens", "depth", "block_size", "k", "v", "kv_dtype"):
        if field not in payload:
            raise HandoffError(f"prefix frame missing field {field!r}")
    _read_blocks(payload, "prefix")
    depth = int(payload["depth"])
    if payload["k"].ndim != 5 or payload["k"].shape[1] != depth:
        raise HandoffError(
            f"prefix frame depth {depth} does not match KV shape {tuple(payload['k'].shape)}"
        )
    if int(np.asarray(payload["tokens"]).size) != depth * int(payload["block_size"]):
        raise HandoffError("prefix frame tokens do not cover its blocks")
    return payload


def build_handoff_frame(model, slot: int, prompt: np.ndarray, first_token: int, *,
                        max_new_tokens: int, temperature: float = 0.0,
                        eos_id: int | None = None) -> bytes:
    """Export ``slot``'s prompt KV from ``model`` (one device-to-host
    fetch) and frame the handoff, with the speculation envelope when the
    model speculates and the v4 ``adapter`` bound to the slot, which its
    KV was made through.  The v3 envelope carries the caller's context as
    the JAX package's does: the CURRENT ``traceparent`` (the engine's
    ``handoff.export`` span, whose id is the frame's ``origin_span``, so
    the decode engine's spans stitch under it), the remaining deadline
    and the priority.  Run it in a thread with ``asyncio.to_thread``,
    which copies the caller's context."""
    from seldon_core_tpu_torch import qos
    from seldon_core_tpu_torch.obs.spans import get_traceparent, parse_traceparent

    out = model.export_slot_kv(slot, int(np.asarray(prompt).size))
    k_scale, v_scale = (out[2], out[3]) if len(out) == 4 else (None, None)
    tp = get_traceparent()
    parsed = parse_traceparent(tp)
    remaining = qos.remaining_s()
    return encode_handoff(
        prompt, first_token, out[0], out[1], block_size=model.kv_block_size,
        max_new_tokens=max_new_tokens, temperature=temperature, eos_id=eos_id,
        k_scale=k_scale, v_scale=v_scale, traceparent=tp if parsed else None,
        origin_span=parsed[1] if parsed else None,
        deadline_ms=remaining * 1e3 if remaining is not None else None,
        priority=qos.get_priority(), spec_state=model.export_spec_state(slot),
        adapter=model.slot_adapter(slot),
    )


def check_pool(model, payload: dict[str, Any], what: str = "handoff") -> None:
    """Raise :class:`HandoffError` unless ``payload`` (a decoded handoff or
    prefix frame) fits ``model``'s pool: the same block size and KV layout,
    and, when it names an adapter, that adapter resident in this pool (the
    KV was made through it: decoding it through another, or none, would be
    silently wrong, so the sender falls back to unified)."""
    if int(payload["block_size"]) != model.kv_block_size:
        raise HandoffError(
            f"{what} block size {payload['block_size']} != pool block size "
            f"{model.kv_block_size}; pools must share kv_block_size"
        )
    quant = bool(payload.get("kv_quant"))
    if quant != bool(model.kv_dtype):
        raise HandoffError(
            f"{what} kv layout {'int8' if quant else 'float'} != pool layout "
            f"{model.kv_dtype or 'float'}; pools must share kv_cache_dtype"
        )
    adapter = payload.get("adapter")
    if adapter:
        pool = getattr(model, "lora_pool", None)
        if pool is None or adapter not in pool:
            raise HandoffError(
                f"{what} names adapter {adapter!r} but it is not resident on this decode "
                "pool; register it (or route elsewhere)"
            )


async def apply_handoff(component, payload: dict[str, Any]) -> np.ndarray:
    """Admit a decoded handoff on ``component``'s scheduler (the import
    lands at its next sync point) and decode to the end.  Returns every
    generated id, the first token included: what a unified engine
    returns."""
    check_pool(component.model, payload)
    eos = payload.get("eos_id")
    return await component.scheduler.submit_imported(
        payload["prompt"],
        first_token=int(payload["first_token"]),
        k=payload["k"],
        v=payload["v"],
        max_new_tokens=int(payload["max_new_tokens"]),
        temperature=float(payload.get("temperature", 0.0)),
        eos_id=int(eos) if eos is not None else None,
        k_scale=payload.get("k_scale"),
        v_scale=payload.get("v_scale"),
        spec_state=payload.get("spec_state"),
        adapter=payload.get("adapter") or None,
    )
