"""Wire codec: SeldonMessage JSON and protobuf <-> :class:`Payload`.

The port's copy of the JAX package's ``contract/codec.py``, wire-compatible
with it: ``data.tensor``, ``data.ndarray``, ``binData`` and ``strData``.
The protobuf half (``payload_from_proto`` and its kin) runs over the
stdlib messages of ``proto/prediction.py``.

    {"meta": {...}, "data": {"names": [...], "tensor": {"shape": [...],
     "values": [...]}}}                       # or "ndarray": [[...]]
    {"binData": "<base64>"} / {"strData": "..."}

plus the JAX package's typed ``rawTensor`` (``{"shape": [...], "dtype":
"uint8", "data": "<base64>", "names": [...]}``: raw little-endian bytes,
4x smaller than bf16 for uint8 images) both ways, and the feedback
message ``{"request": ..., "response": ..., "reward": r, "truth": ...}``.
A ``bfloat16`` rawTensor (its uint16 bit patterns) decodes to float32,
which holds every bfloat16 value exactly: numpy has no bfloat16 without
``ml_dtypes``, which the port does not use.

Decoding happens once per request at the process boundary; everything
inside the graph walk is numpy.
"""

from __future__ import annotations

import base64
import binascii
import json
from typing import Any

import numpy as np

from seldon_core_tpu_torch.proto import prediction as pb
from seldon_core_tpu_torch.proto.prediction import value_from_json
from seldon_core_tpu_torch.contract.payload import (
    DataKind,
    FeedbackPayload,
    Meta,
    Metric,
    Payload,
)


class CodecError(ValueError):
    """Malformed wire message."""


# dtypes allowed on the rawTensor path (the JAX package's list)
_RAW_DTYPES = {
    "float32", "float16", "bfloat16", "float64",
    "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "bool",
}


_METRIC_TYPES = {"COUNTER", "GAUGE", "TIMER"}
_METRIC_CODES = {name: code for code, name in pb.Metric.TYPES.items()}


def failure_status_dict(code: int, reason: str) -> dict[str, Any]:
    """The wire-level FAILURE envelope of the engine's REST errors."""
    return {
        "status": {"code": code, "info": reason, "reason": reason, "status": "FAILURE"}
    }


def meta_from_dict(d: dict[str, Any] | None) -> Meta:
    d = d or {}
    metrics = []
    for m in d.get("metrics", []):
        mtype = m.get("type", "COUNTER")
        if mtype not in _METRIC_TYPES:
            raise CodecError(
                f"unknown metric type {mtype!r}; expected one of {sorted(_METRIC_TYPES)}"
            )
        metrics.append(
            Metric(key=m.get("key", ""), type=mtype, value=float(m.get("value", 0.0)))
        )
    return Meta(
        puid=d.get("puid", ""),
        tags=dict(d.get("tags", {})),
        routing={k: int(v) for k, v in d.get("routing", {}).items()},
        request_path=dict(d.get("requestPath", {})),
        metrics=metrics,
    )


def meta_to_dict(meta: Meta) -> dict[str, Any]:
    out: dict[str, Any] = {"puid": meta.puid}
    if meta.tags:
        out["tags"] = meta.tags
    if meta.routing:
        out["routing"] = meta.routing
    if meta.request_path:
        out["requestPath"] = meta.request_path
    if meta.metrics:
        out["metrics"] = [
            {"key": m.key, "type": m.type, "value": m.value} for m in meta.metrics
        ]
    return out


def payload_from_dict(msg: dict[str, Any]) -> Payload:
    """Decode a parsed SeldonMessage JSON object."""
    if not isinstance(msg, dict):
        raise CodecError("SeldonMessage must be a JSON object")
    meta = meta_from_dict(msg.get("meta"))
    if "data" in msg:
        data = msg["data"]
        if not isinstance(data, dict):
            raise CodecError("data must be a JSON object")
        names = list(data.get("names", []))
        if "tensor" in data:
            t = data["tensor"]
            try:
                shape = [int(s) for s in t.get("shape", [])]
                arr = np.asarray(t["values"], dtype=np.float64)
            except (AttributeError, KeyError, TypeError, ValueError) as e:
                raise CodecError(f"bad tensor: {e}") from e
            if shape:
                try:
                    arr = arr.reshape(shape)
                except ValueError as e:
                    raise CodecError(f"tensor shape mismatch: {e}") from e
            return Payload(arr, names, DataKind.TENSOR, meta)
        if "ndarray" in data:
            return Payload(_ndarray_to_array(data["ndarray"]), names, DataKind.NDARRAY, meta)
        raise CodecError("data must contain 'tensor' or 'ndarray'")
    if "rawTensor" in msg:
        rt = msg["rawTensor"]
        try:
            dtype = rt.get("dtype", "float32")
            if dtype not in _RAW_DTYPES:
                raise CodecError(f"unsupported rawTensor dtype {dtype!r}")
            data = rt.get("data")
            if data is None:
                raise CodecError("rawTensor missing 'data'")
            buf = base64.b64decode(data, validate=True) if isinstance(data, str) else bytes(data)
            arr = _raw_to_array(buf, dtype, [int(s) for s in rt.get("shape", [])])
            names = list(rt.get("names", []))
        except CodecError:
            raise
        except (AttributeError, TypeError, ValueError, binascii.Error) as e:
            raise CodecError(f"bad rawTensor: {e}") from e
        return Payload(arr, names, DataKind.RAW, meta)
    if "binData" in msg:
        raw = msg["binData"]
        try:
            data_b = base64.b64decode(raw, validate=True) if isinstance(raw, str) else bytes(raw)
        except (binascii.Error, TypeError, ValueError) as e:
            raise CodecError(f"bad binData: {e}") from e
        return Payload(data_b, [], DataKind.BINARY, meta)
    if "strData" in msg:
        return Payload(str(msg["strData"]), [], DataKind.STRING, meta)
    return Payload(None, [], DataKind.EMPTY, meta)


def payload_to_dict(payload: Payload, include_meta: bool = True) -> dict[str, Any]:
    """Encode a payload back to SeldonMessage JSON structure."""
    out: dict[str, Any] = {}
    if include_meta:
        out["meta"] = meta_to_dict(payload.meta)
    kind, data = payload.kind, payload.data
    if kind == DataKind.EMPTY or data is None:
        return out
    if kind == DataKind.BINARY:
        out["binData"] = base64.b64encode(data).decode("ascii")
    elif kind == DataKind.STRING:
        out["strData"] = data
    elif kind == DataKind.TENSOR:
        arr = np.asarray(data, dtype=np.float64)
        out["data"] = {
            "names": payload.names,
            "tensor": {"shape": list(arr.shape), "values": arr.ravel().tolist()},
        }
    elif kind == DataKind.NDARRAY:
        out["data"] = {"names": payload.names, "ndarray": np.asarray(data).tolist()}
    elif kind == DataKind.RAW:
        arr = np.ascontiguousarray(data)
        out["rawTensor"] = {
            "shape": list(arr.shape),
            "dtype": arr.dtype.name,
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
            "names": payload.names,
        }
    else:
        raise CodecError(f"{kind.value} payloads are not served by this engine")
    return out


def feedback_from_dict(msg: dict[str, Any]) -> FeedbackPayload:
    """Decode a feedback message; ``response.meta.routing`` is the routed
    path the feedback walk replays."""
    if not isinstance(msg, dict):
        raise CodecError("Feedback must be a JSON object")
    try:
        reward = float(msg.get("reward", 0.0))
    except (TypeError, ValueError) as e:
        raise CodecError(f"bad feedback reward: {e}") from e
    return FeedbackPayload(
        request=payload_from_dict(msg["request"]) if "request" in msg else None,
        response=payload_from_dict(msg["response"]) if "response" in msg else None,
        reward=reward,
        truth=payload_from_dict(msg["truth"]) if "truth" in msg else None,
    )


def feedback_to_dict(fb: FeedbackPayload) -> dict[str, Any]:
    out: dict[str, Any] = {"reward": fb.reward}
    if fb.request is not None:
        out["request"] = payload_to_dict(fb.request)
    if fb.response is not None:
        out["response"] = payload_to_dict(fb.response)
    if fb.truth is not None:
        out["truth"] = payload_to_dict(fb.truth)
    return out


# ---------------------------------------------------------------------------
# protobuf (proto/prediction.py) <-> Payload
# ---------------------------------------------------------------------------

def payload_from_proto(msg: pb.SeldonMessage) -> Payload:
    """Decode a SeldonMessage as the JAX package's ``payload_from_proto``
    does: an ``ndarray``'s and a tag's numbers come back as floats, and a
    non-finite one raises the ValueError of ``json_format``."""
    m = msg.meta or pb.Meta()
    metrics = []
    for x in m.metrics:
        if x.type not in pb.Metric.TYPES:
            raise ValueError(f"Enum MetricType has no name defined for value {x.type!r}")
        metrics.append(Metric(x.key, pb.Metric.TYPES[x.type], x.value))
    meta = Meta(
        puid=m.puid,
        tags={k: value_from_json(v) for k, v in m.tags.items()},
        routing=dict(m.routing),
        request_path=dict(m.requestPath),
        metrics=metrics,
    )
    which = msg.WhichOneof("data_oneof")
    if which == "data":
        names = list(msg.data.names)
        dwhich = msg.data.WhichOneof("data_oneof")
        if dwhich == "tensor":
            arr = np.asarray(msg.data.tensor.values, dtype=np.float64)
            shape = list(msg.data.tensor.shape)
            if shape:
                try:
                    arr = arr.reshape(shape)
                except ValueError as e:
                    raise CodecError(f"tensor shape mismatch: {e}") from e
            return Payload(arr, names, DataKind.TENSOR, meta)
        if dwhich == "ndarray":
            nd = value_from_json(msg.data.ndarray)
            return Payload(_ndarray_to_array(nd), names, DataKind.NDARRAY, meta)
        return Payload(None, names, DataKind.EMPTY, meta)
    if which == "rawTensor":
        rt = msg.rawTensor
        dtype = rt.dtype or "float32"
        if dtype not in _RAW_DTYPES:
            raise CodecError(f"unsupported rawTensor dtype {dtype!r}")
        try:
            arr = _raw_to_array(rt.data, dtype, list(rt.shape))
        except ValueError as e:
            raise CodecError(f"bad rawTensor: {e}") from e
        return Payload(arr, list(rt.names), DataKind.RAW, meta)
    if which == "binData":
        return Payload(bytes(msg.binData), [], DataKind.BINARY, meta)
    if which == "strData":
        return Payload(msg.strData, [], DataKind.STRING, meta)
    return Payload(None, [], DataKind.EMPTY, meta)


def payload_to_proto(payload: Payload) -> pb.SeldonMessage:
    """Encode a payload as the JAX package's ``payload_to_proto`` does (the
    meta is always present, an empty one included)."""
    meta = payload.meta
    msg = pb.SeldonMessage(meta=pb.Meta(
        puid=meta.puid, tags=dict(meta.tags),
        routing={k: int(v) for k, v in meta.routing.items()},
        requestPath=dict(meta.request_path),
        metrics=[pb.Metric(key=m.key, type=_METRIC_CODES[m.type], value=m.value)
                 for m in meta.metrics]))
    kind, data = payload.kind, payload.data
    if kind == DataKind.EMPTY or data is None:
        return msg
    if kind == DataKind.BINARY:
        msg.binData = bytes(data)
    elif kind == DataKind.STRING:
        msg.strData = data
    elif kind == DataKind.RAW:
        arr = np.ascontiguousarray(data)
        msg.rawTensor = pb.RawTensor(shape=list(arr.shape), dtype=arr.dtype.name,
                                     data=arr.tobytes(), names=list(payload.names))
    elif kind == DataKind.TENSOR:
        arr = np.asarray(data, dtype=np.float64)
        msg.data = pb.DefaultData(names=list(payload.names), tensor=pb.Tensor(
            shape=list(arr.shape), values=arr.ravel()))
    else:  # NDARRAY
        nd = np.asarray(data).tolist()
        if not isinstance(nd, list):
            raise ValueError(f"ListValue must be in [] which is {nd}")
        msg.data = pb.DefaultData(names=list(payload.names), ndarray=nd)
    return msg


def feedback_from_proto(msg: pb.Feedback) -> FeedbackPayload:
    return FeedbackPayload(
        request=payload_from_proto(msg.request) if msg.request is not None else None,
        response=payload_from_proto(msg.response) if msg.response is not None else None,
        reward=msg.reward,
        truth=payload_from_proto(msg.truth) if msg.truth is not None else None,
    )


def feedback_to_proto(fb: FeedbackPayload) -> pb.Feedback:
    return pb.Feedback(
        request=payload_to_proto(fb.request) if fb.request is not None else None,
        response=payload_to_proto(fb.response) if fb.response is not None else None,
        reward=fb.reward,
        truth=payload_to_proto(fb.truth) if fb.truth is not None else None,
    )


def payload_from_json(raw: str | bytes) -> Payload:
    try:
        msg = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CodecError(f"invalid JSON: {e}") from e
    return payload_from_dict(msg)


def _raw_to_array(buf: bytes, dtype: str, shape: list[int]) -> np.ndarray:
    """A writable copy of the wire bytes (``np.frombuffer`` is read-only);
    bfloat16 bit patterns widened to float32."""
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
    if shape:
        arr = arr.reshape(shape)
    return arr


def _ndarray_to_array(nd: Any) -> np.ndarray:
    """Decode a JSON ndarray; mixed or string rows stay python objects
    instead of being coerced to numpy unicode."""
    try:
        arr = np.asarray(nd)
    except (TypeError, ValueError):
        try:
            return np.asarray(nd, dtype=object)
        except (TypeError, ValueError) as e:
            raise CodecError(f"bad ndarray: {e}") from e
    if arr.dtype.kind in "USV":
        arr = np.asarray(nd, dtype=object)
    return arr
