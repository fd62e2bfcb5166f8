"""Step framing: length-prefixed JSON plus raw ndarray segments.

The port's copy of the framing half of the JAX package's
``executor/multihost.py`` (``encode_step``/``decode_step``, the same
magic, version and byte layout), so a frame either package writes the
other reads: a JAX engine and a port engine can share a split
prefill/decode pool.  The KV handoff (``disagg/handoff.py``) rides on it.
The multi-host step driver that broadcasts these frames across a slice is
not ported yet.

    <4s magic "SCT1"> <u16 version> <u32 header_len> <json header>
    <array 0 bytes> <array 1 bytes> ...

The header records each array's name, numpy dtype string and shape, in
order.  Frames carry no pickles: a malformed frame, a wrong magic or a
version skew is a ``ValueError``, never code run on the reader.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

FRAME_MAGIC = b"SCT1"
FRAME_VERSION = 1

_HDR_LEN = struct.Struct("<4sHI")  # magic, version, json header length


def encode_step(key: str, payload: dict) -> bytes:
    """Frame ``payload``: a flat dict of JSON scalars, lists of scalars and
    numpy arrays (anything else raises ``TypeError`` at the sender)."""
    if not isinstance(payload, dict):
        raise TypeError(f"step payload must be a dict, got {type(payload).__name__}")
    plain: dict[str, Any] = {}
    # (name, contiguous buffer, true shape): ascontiguousarray promotes
    # 0-d arrays to 1-d, so the shape is taken from the original
    arrays: list[tuple[str, np.ndarray, list[int]]] = []
    for k, v in payload.items():
        if isinstance(v, np.ndarray):
            arrays.append((k, np.ascontiguousarray(v), list(v.shape)))
        elif isinstance(v, np.generic):
            plain[k] = v.item()
        elif isinstance(v, (str, int, float, bool)) or v is None:
            plain[k] = v
        elif isinstance(v, (list, tuple)):
            if any(not isinstance(e, (str, int, float, bool)) and e is not None for e in v):
                raise TypeError(f"step payload field {k!r}: lists may hold scalars only")
            plain[k] = list(v)
        else:
            raise TypeError(
                f"step payload field {k!r} has unframeable type {type(v).__name__} "
                "(ndarray / JSON scalar / scalar list only)"
            )
    header = json.dumps(
        {
            "key": key,
            "plain": plain,
            "arrays": [{"name": k, "dtype": a.dtype.str, "shape": shape}
                       for k, a, shape in arrays],
        },
        separators=(",", ":"),
    ).encode()
    parts = [_HDR_LEN.pack(FRAME_MAGIC, FRAME_VERSION, len(header)), header]
    parts.extend(a.tobytes() for _, a, _shape in arrays)
    return b"".join(parts)


def decode_step(buf: bytes) -> tuple[str, dict]:
    """Inverse of :func:`encode_step`; raises ``ValueError`` on a torn or
    malformed frame, a wrong magic or a version mismatch."""
    if len(buf) < _HDR_LEN.size:
        raise ValueError("step frame shorter than its length prefix")
    magic, version, n = _HDR_LEN.unpack_from(buf, 0)
    if magic != FRAME_MAGIC:
        raise ValueError(
            f"step frame magic {magic!r} != {FRAME_MAGIC!r}: the peer speaks another "
            "protocol (or the stream is corrupt)"
        )
    if version != FRAME_VERSION:
        raise ValueError(
            f"step frame version {version} != {FRAME_VERSION}: the peer is built from "
            "another release; refusing to decode"
        )
    if len(buf) < _HDR_LEN.size + n:
        raise ValueError("step frame truncated before header end")
    try:
        header = json.loads(buf[_HDR_LEN.size: _HDR_LEN.size + n])
        payload: dict[str, Any] = dict(header["plain"])
        specs = [(str(d["name"]), np.dtype(d["dtype"]), tuple(int(s) for s in d["shape"]))
                 for d in header["arrays"]]
        key = str(header["key"])
    except (KeyError, TypeError, AttributeError) as e:
        raise ValueError(f"step frame header is malformed: {e!r}") from None
    off = _HDR_LEN.size + n
    for name, dt, shape in specs:
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64)) if shape else dt.itemsize
        if len(buf) < off + nbytes:
            raise ValueError(f"step frame truncated inside array {name!r}")
        arr = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize, offset=off)
        # copy: frombuffer views are read-only and pin the whole frame
        payload[name] = arr.reshape(shape).copy()
        off += nbytes
    return key, payload
