"""The prediction wire contract in proto3, encoded and decoded on the
stdlib alone: the port's stand-in for the JAX package's generated
``proto/prediction_pb2.py`` (the card has no ``protobuf``).

Every message of the JAX package's ``proto/prediction.proto`` is a class
here with the same name, field names and field numbers, and the
protobuf-python spelling of the few calls the data plane makes:
``SerializeToString``, ``FromString``, ``ParseFromString``, ``ByteSize``,
``WhichOneof`` and ``HasField``.  A message is plain attributes:

* a scalar field holds its value, the proto3 default when unset (an
  unset scalar is not written, except a oneof member, which is written
  whenever it is set, even to its default);
* a singular message field holds a message or ``None`` (absent);
* a repeated field holds a list, a map field a dict;
* a oneof holds at most one member that is not ``None``: assigning a
  member clears the others, as in protobuf.

The well-known types ``Value``, ``Struct`` and ``ListValue`` of
``struct.proto`` (``Meta.tags`` and ``DefaultData.ndarray``) are written
out by hand as their JSON values:
``None``, ``bool``, ``int``/``float`` (a ``number_value``), ``str``,
``dict`` (a ``Struct``) and ``list``/``tuple`` (a ``ListValue``); reading
one back gives what ``json_format.MessageToDict`` gives (every number a
``float``, an unset ``Value`` ``None``).

Without map fields the bytes equal protobuf's (fields in number order,
packed ``Tensor``/``RawTensor`` arrays, negative ``int32`` as ten-byte
varints, ``-0.0`` floats written); map entries come in insertion order,
where protobuf's order is its hash table's, so such messages are equal
once parsed.  Reading accepts packed and unpacked repeated numbers,
merges a repeated singular message field as protobuf does, and skips
unknown fields (groups included); malformed input raises
:class:`DecodeError`.
"""

from __future__ import annotations

import math
import struct
from typing import Any

import numpy as np

_MAX_DEPTH = 100  # protobuf's default recursion limit

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


# -- the wire primitives -------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # int32/enum: sign-extended to ten bytes
    if n < 0x80:
        return bytes((n,))
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    for _ in range(10):
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & ((1 << 64) - 1), pos
        shift += 7
    raise DecodeError("varint longer than ten bytes")


def _int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v & 0x80000000 else v


def _read_len(buf: bytes, pos: int) -> tuple[int, int]:
    n, pos = _read_varint(buf, pos)
    end = pos + n
    if end > len(buf):
        raise DecodeError("truncated length-delimited field")
    return pos, end


def _skip(buf: bytes, pos: int, wire: int, num: int, depth: int = 0) -> int:
    """Skip one unknown field's payload; groups are skipped whole."""
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _I64:
        pos += 8
    elif wire == _I32:
        pos += 4
    elif wire == _LEN:
        return _read_len(buf, pos)[1]
    elif wire == _SGROUP:
        if depth >= _MAX_DEPTH:
            raise DecodeError("group nesting too deep")
        while True:
            key, pos = _read_varint(buf, pos)
            if key & 7 == _EGROUP:
                if key >> 3 != num:
                    raise DecodeError("mismatched end group")
                return pos
            pos = _skip(buf, pos, key & 7, key >> 3, depth + 1)
    else:
        raise DecodeError(f"invalid wire type {wire}")
    if pos > len(buf):
        raise DecodeError("truncated fixed-width field")
    return pos


def _f32(v: float) -> bytes:
    try:
        return struct.pack("<f", v)
    except OverflowError:  # a double beyond float32's range, as a C cast
        return struct.pack("<f", math.copysign(math.inf, v))


def _utf8(raw: bytes) -> str:
    try:
        return raw.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not valid UTF-8: {e}") from None


# -- the well-known Value / Struct / ListValue, as JSON values -----------------

def _encode_value(v: Any, depth: int = 0) -> bytes:
    """A well-known ``Value``'s bytes for a JSON value (the types
    ``json_format.ParseDict`` takes)."""
    if depth > _MAX_DEPTH:
        raise ValueError("Value nesting too deep")
    if isinstance(v, dict):
        return b"*" + _len_prefixed(_encode_struct(v, depth + 1))
    if isinstance(v, (list, tuple)):
        return b"2" + _len_prefixed(_encode_list(v, depth + 1))
    if v is None:
        return b"\x08\x00"
    if isinstance(v, bool):
        return b" \x01" if v else b" \x00"
    if isinstance(v, str):
        return b"\x1a" + _len_prefixed(v.encode("utf-8"))
    if isinstance(v, (int, float)):
        return b"\x11" + struct.pack("<d", float(v))
    raise ValueError(f"Value {v!r} has unexpected type {type(v)}")


def _encode_list(items, depth: int = 0) -> bytes:
    return b"".join(b"\n" + _len_prefixed(_encode_value(x, depth)) for x in items)


def _encode_struct(fields: dict, depth: int = 0) -> bytes:
    return b"".join(
        b"\n" + _len_prefixed(b"\n" + _len_prefixed(str(k).encode("utf-8"))
                              + b"\x12" + _len_prefixed(_encode_value(v, depth)))
        for k, v in fields.items())


def _decode_value(buf: bytes, pos: int, end: int, depth: int) -> Any:
    if depth > _MAX_DEPTH:
        raise DecodeError("Value nesting too deep")
    out: Any = None
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if num == 1 and wire == _VARINT:  # null_value
            _, pos = _read_varint(buf, pos)
            out = None
        elif num == 2 and wire == _I64:  # number_value
            if pos + 8 > end:
                raise DecodeError("truncated double")
            out = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif num == 3 and wire == _LEN:  # string_value
            s, pos = _read_len(buf, pos)
            out = _utf8(buf[s:pos])
        elif num == 4 and wire == _VARINT:  # bool_value
            b, pos = _read_varint(buf, pos)
            out = bool(b)
        elif num == 5 and wire == _LEN:  # struct_value (a repeat merges)
            s, pos = _read_len(buf, pos)
            fields = _decode_struct(buf, s, pos, depth + 1)
            out = {**out, **fields} if isinstance(out, dict) else fields
        elif num == 6 and wire == _LEN:  # list_value (a repeat appends)
            s, pos = _read_len(buf, pos)
            items = _decode_list(buf, s, pos, depth + 1)
            out = out + items if isinstance(out, list) else items
        elif num == 0:
            raise DecodeError("field number 0")
        else:
            pos = _skip(buf, pos, wire, num)
    if pos != end:
        raise DecodeError("field overruns its message")
    return out


def _decode_list(buf: bytes, pos: int, end: int, depth: int) -> list:
    items: list = []
    while pos < end:
        key, pos = _read_varint(buf, pos)
        if key == 0x0A:
            s, pos = _read_len(buf, pos)
            items.append(_decode_value(buf, s, pos, depth))
        elif key >> 3 == 0:
            raise DecodeError("field number 0")
        else:
            pos = _skip(buf, pos, key & 7, key >> 3)
    if pos != end:
        raise DecodeError("field overruns its message")
    return items


def _decode_struct(buf: bytes, pos: int, end: int, depth: int) -> dict:
    fields: dict = {}
    while pos < end:
        key, pos = _read_varint(buf, pos)
        if key == 0x0A:
            s, pos = _read_len(buf, pos)
            k, v = _decode_entry(buf, s, pos, "string", "value", depth)
            fields[k] = v
        elif key >> 3 == 0:
            raise DecodeError("field number 0")
        else:
            pos = _skip(buf, pos, key & 7, key >> 3)
    if pos != end:
        raise DecodeError("field overruns its message")
    return fields


def value_from_json(v: Any) -> Any:
    """What ``json_format.MessageToDict`` makes of a decoded Value: the same
    JSON value, except that a non-finite number raises its ValueError."""
    if isinstance(v, float) and not math.isfinite(v):
        what = "Infinity" if math.isinf(v) else "NaN"
        raise ValueError(f"Fail to serialize {what} for Value.number_value, which would "
                         "parse as string_value")
    if isinstance(v, list):
        return [value_from_json(x) for x in v]
    if isinstance(v, dict):
        return {k: value_from_json(x) for k, x in v.items()}
    return v


# -- the message machinery -----------------------------------------------------

class _Field:
    __slots__ = ("num", "name", "kind", "repeated", "cls", "oneof", "key", "tag")

    def __init__(self, num: int, name: str, kind: str, *, repeated: bool = False,
                 cls: Any = None, oneof: str | None = None, key: str | None = None):
        self.num, self.name, self.kind = num, name, kind
        self.repeated, self.cls, self.oneof, self.key = repeated, cls, oneof, key
        self.tag = _varint(num << 3 | _WIRE[kind if not repeated or kind in _LENGTHY
                                            else "packed"])


_WIRE = {"int32": _VARINT, "enum": _VARINT, "bool": _VARINT, "double": _I64,
         "float": _I32, "string": _LEN, "bytes": _LEN, "message": _LEN, "map": _LEN,
         "value": _LEN, "list": _LEN, "packed": _LEN}
_LENGTHY = ("string", "bytes", "message", "map")


def _len_prefixed(data: bytes) -> bytes:
    return _varint(len(data)) + data


def _default(f: _Field) -> Any:
    if f.kind == "map":
        return {}
    if f.repeated:
        return []
    if f.oneof is not None or f.kind in ("message", "list"):
        return None
    return {"int32": 0, "enum": 0, "bool": False, "float": 0.0, "double": 0.0,
            "string": "", "bytes": b""}[f.kind]


def _int32_varint(v: Any) -> bytes:
    v = int(v)
    if not -(1 << 31) <= v < (1 << 31):
        raise ValueError(f"Value out of range: {v}")
    return _varint(v)


def _scalar_bytes(kind: str, v: Any, depth: int = 0) -> bytes:
    """A value's payload (after its tag) for one field of ``kind``."""
    if kind in ("int32", "enum"):
        return _int32_varint(v)
    if kind == "bool":
        return b"\x01" if v else b"\x00"
    if kind == "double":
        return struct.pack("<d", v)
    if kind == "float":
        return _f32(v)
    if kind == "string":
        return _len_prefixed(v.encode("utf-8"))
    if kind == "bytes":
        return _len_prefixed(bytes(v))
    if kind == "message":
        return _len_prefixed(v.SerializeToString())
    if kind == "value":
        return _len_prefixed(_encode_value(v, depth))
    if kind == "list":
        return _len_prefixed(_encode_list(v, depth))
    raise TypeError(kind)


def _is_default(kind: str, v: Any) -> bool:
    """Proto3 implicit presence: bit-zero numbers and empty strings are not
    written (a ``-0.0`` is)."""
    if kind == "float":  # as stored: a double that rounds to +0.0 is unset
        return _f32(v) == b"\x00" * 4
    if kind == "double":
        return struct.pack("<d", v) == b"\x00" * 8
    if kind in ("string", "bytes"):
        return len(v) == 0
    return not v


def _read_scalar(kind: str, buf: bytes, pos: int, wire: int, depth: int) -> tuple[Any, int]:
    if kind in ("int32", "enum", "bool"):
        if wire != _VARINT:
            return _SKIP, pos
        v, pos = _read_varint(buf, pos)
        return (bool(v) if kind == "bool" else _int32(v)), pos
    if kind == "double":
        if wire != _I64:
            return _SKIP, pos
        if pos + 8 > len(buf):
            raise DecodeError("truncated double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if kind == "float":
        if wire != _I32:
            return _SKIP, pos
        if pos + 4 > len(buf):
            raise DecodeError("truncated float")
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire != _LEN:
        return _SKIP, pos
    s, pos = _read_len(buf, pos)
    if kind == "string":
        return _utf8(buf[s:pos]), pos
    if kind == "bytes":
        return bytes(buf[s:pos]), pos
    if kind == "value":
        return _decode_value(buf, s, pos, depth + 1), pos
    raise TypeError(kind)


_SKIP = object()


class Message:
    """The base of every message: the fields come from ``_FIELDS``."""

    _FIELDS: tuple[_Field, ...] = ()
    _BY_NUM: dict[int, _Field] = {}
    _BY_NAME: dict[str, _Field] = {}
    _ONEOFS: dict[str, tuple[str, ...]] = {}

    def __init_subclass__(cls) -> None:
        super().__init_subclass__()
        cls._BY_NUM = {f.num: f for f in cls._FIELDS}
        cls._BY_NAME = {f.name: f for f in cls._FIELDS}
        oneofs: dict[str, list[str]] = {}
        for f in cls._FIELDS:
            if f.oneof is not None:
                oneofs.setdefault(f.oneof, []).append(f.name)
        cls._ONEOFS = {k: tuple(v) for k, v in oneofs.items()}

    def __init__(self, **fields: Any) -> None:
        for f in self._FIELDS:
            object.__setattr__(self, f.name, _default(f))
        for name, value in fields.items():
            if name not in self._BY_NAME:
                raise AttributeError(f"{type(self).__name__} has no field {name!r}")
            setattr(self, name, value)

    def __setattr__(self, name: str, value: Any) -> None:
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        if f.oneof is not None and value is not None:
            for other in self._ONEOFS[f.oneof]:
                if other != name:
                    object.__setattr__(self, other, None)
        object.__setattr__(self, name, value)

    # -- the protobuf-python calls -------------------------------------------

    def WhichOneof(self, group: str) -> str | None:
        for name in self._ONEOFS[group]:
            if getattr(self, name) is not None:
                return name
        return None

    def HasField(self, name: str) -> bool:
        f = self._BY_NAME[name]
        if f.repeated or f.kind == "map" or (f.oneof is None and f.kind != "message"):
            raise ValueError(f"field {name!r} has no presence in proto3")
        return getattr(self, name) is not None

    def SerializeToString(self) -> bytes:
        return b"".join(self._encode())

    def ByteSize(self) -> int:
        return len(self.SerializeToString())

    @classmethod
    def FromString(cls, data: bytes):
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def ParseFromString(self, data: bytes) -> int:
        self.__init__()
        buf = bytes(data)
        self._merge(buf, 0, len(buf), 0)
        return len(buf)

    def __eq__(self, other: object) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(_same(getattr(self, f.name), getattr(other, f.name)) for f in self._FIELDS)

    def __repr__(self) -> str:
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in self._FIELDS
                 if not _same(getattr(self, f.name), _default(f))]
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- the encoder -----------------------------------------------------------

    def _encode(self):
        for f in self._FIELDS:
            v = getattr(self, f.name)
            if f.kind == "map":
                for k, item in v.items():
                    entry = (b"\n" + _scalar_bytes(f.key, k)
                             + _map_value_tag(f) + _scalar_bytes(f.cls, item))
                    yield f.tag + _len_prefixed(entry)
            elif f.repeated:
                if f.kind in _LENGTHY:
                    for item in v:
                        yield f.tag + _scalar_bytes(f.kind, item)
                elif len(v):
                    yield f.tag + _len_prefixed(_packed(f.kind, v))
            elif v is None:
                continue
            elif f.oneof is not None or f.kind == "message" or not _is_default(f.kind, v):
                yield f.tag + _scalar_bytes(f.kind, v)

    # -- the decoder -----------------------------------------------------------

    def _merge(self, buf: bytes, pos: int, end: int, depth: int) -> None:
        if depth > _MAX_DEPTH:
            raise DecodeError("message nesting too deep")
        while pos < end:
            key, pos = _read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            if num == 0:
                raise DecodeError("field number 0")
            f = self._BY_NUM.get(num)
            if f is None:
                pos = _skip(buf, pos, wire, num)
                continue
            if f.kind == "map":
                if wire != _LEN:
                    pos = _skip(buf, pos, wire, num)
                    continue
                s, pos = _read_len(buf, pos)
                k, v = _decode_entry(buf, s, pos, f.key, f.cls, depth)
                getattr(self, f.name)[k] = v
            elif f.kind == "message":
                if wire != _LEN:
                    pos = _skip(buf, pos, wire, num)
                    continue
                s, pos = _read_len(buf, pos)
                if f.repeated:
                    sub = f.cls()
                    sub._merge(buf, s, pos, depth + 1)
                    getattr(self, f.name).append(sub)
                else:  # a repeated singular message merges into the first
                    sub = getattr(self, f.name)
                    if sub is None:
                        sub = f.cls()
                    sub._merge(buf, s, pos, depth + 1)
                    setattr(self, f.name, sub)
            elif f.kind == "list":
                if wire != _LEN:
                    pos = _skip(buf, pos, wire, num)
                    continue
                s, pos = _read_len(buf, pos)
                items = _decode_list(buf, s, pos, depth + 1)
                prev = getattr(self, f.name)
                setattr(self, f.name, prev + items if prev is not None else items)
            elif f.repeated and f.kind not in _LENGTHY and wire == _LEN:
                s, pos = _read_len(buf, pos)
                getattr(self, f.name).extend(_unpacked(f.kind, buf, s, pos))
            else:
                v, new = _read_scalar(f.kind, buf, pos, wire, depth)
                if v is _SKIP:
                    pos = _skip(buf, pos, wire, num)
                    continue
                pos = new
                if f.repeated:
                    getattr(self, f.name).append(v)
                else:
                    setattr(self, f.name, v)
        if pos != end:
            raise DecodeError("field overruns its message")


def _same(a: Any, b: Any) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _map_value_tag(f: _Field) -> bytes:
    """The tag of a map entry's value (field 2)."""
    return bytes((2 << 3 | (_LEN if isinstance(f.cls, type) else _WIRE[f.cls]),))


def _packed(kind: str, values) -> bytes:
    if kind == "double":
        return np.asarray(values, dtype="<f8").tobytes()
    if kind == "float":
        return b"".join(_f32(v) for v in values)
    return b"".join(_int32_varint(v) for v in values)


def _unpacked(kind: str, buf: bytes, pos: int, end: int) -> list:
    if kind == "double":
        if (end - pos) % 8:
            raise DecodeError("packed doubles of a length not a multiple of 8")
        return np.frombuffer(buf, dtype="<f8", count=(end - pos) // 8, offset=pos).tolist()
    if kind == "float":
        if (end - pos) % 4:
            raise DecodeError("packed floats of a length not a multiple of 4")
        return np.frombuffer(buf, dtype="<f4", count=(end - pos) // 4, offset=pos).tolist()
    out = []
    while pos < end:
        v, pos = _read_varint(buf, pos)
        out.append(bool(v) if kind == "bool" else _int32(v))
    if pos != end:
        raise DecodeError("packed varints overrun their field")
    return out


def _decode_entry(buf: bytes, pos: int, end: int, key_kind: str, value_kind: Any,
                  depth: int) -> tuple[Any, Any]:
    """A map entry (key = 1, value = 2); an absent half takes its default."""
    k: Any = _default(_Field(1, "key", key_kind))
    v: Any = None
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if num == 1:
            got, new = _read_scalar(key_kind, buf, pos, wire, depth)
        elif num == 2 and isinstance(value_kind, type):
            if wire == _LEN:
                s, new = _read_len(buf, pos)
                got = v if v is not None else value_kind()
                got._merge(buf, s, new, depth + 1)
            else:
                got = _SKIP
        elif num == 2:
            got, new = _read_scalar(value_kind, buf, pos, wire, depth)
        elif num == 0:
            raise DecodeError("field number 0")
        else:
            got = _SKIP
        if got is _SKIP:
            pos = _skip(buf, pos, wire, num)
            continue
        pos = new
        if num == 1:
            k = got
        else:
            v = got
    if pos != end:
        raise DecodeError("field overruns its message")
    if v is None and value_kind != "value":
        v = value_kind() if isinstance(value_kind, type) else \
            _default(_Field(2, "value", value_kind))
    return k, v


# -- the messages of prediction.proto -----------------------------------------

class Status(Message):
    SUCCESS = 0
    FAILURE = 1
    _FIELDS = (
        _Field(1, "code", "int32"),
        _Field(2, "info", "string"),
        _Field(3, "reason", "string"),
        _Field(4, "status", "enum"),
    )


class Metric(Message):
    COUNTER = 0
    GAUGE = 1
    TIMER = 2
    TYPES = {0: "COUNTER", 1: "GAUGE", 2: "TIMER"}
    _FIELDS = (
        _Field(1, "key", "string"),
        _Field(2, "type", "enum"),
        _Field(3, "value", "float"),
    )


class Meta(Message):
    _FIELDS = (
        _Field(1, "puid", "string"),
        _Field(2, "tags", "map", key="string", cls="value"),
        _Field(3, "routing", "map", key="string", cls="int32"),
        _Field(4, "requestPath", "map", key="string", cls="string"),
        _Field(5, "metrics", "message", repeated=True, cls=Metric),
    )


class Tensor(Message):
    _FIELDS = (
        _Field(1, "shape", "int32", repeated=True),
        _Field(2, "values", "double", repeated=True),
    )


class RawTensor(Message):
    _FIELDS = (
        _Field(1, "shape", "int32", repeated=True),
        _Field(2, "dtype", "string"),
        _Field(3, "data", "bytes"),
        _Field(4, "names", "string", repeated=True),
    )


class DefaultData(Message):
    """``ndarray`` is the well-known ``ListValue`` as a Python list."""

    _FIELDS = (
        _Field(1, "names", "string", repeated=True),
        _Field(2, "tensor", "message", cls=Tensor, oneof="data_oneof"),
        _Field(3, "ndarray", "list", oneof="data_oneof"),
    )


class SeldonMessage(Message):
    _FIELDS = (
        _Field(1, "status", "message", cls=Status),
        _Field(2, "meta", "message", cls=Meta),
        _Field(3, "data", "message", cls=DefaultData, oneof="data_oneof"),
        _Field(4, "binData", "bytes", oneof="data_oneof"),
        _Field(5, "strData", "string", oneof="data_oneof"),
        _Field(6, "rawTensor", "message", cls=RawTensor, oneof="data_oneof"),
    )


class Feedback(Message):
    _FIELDS = (
        _Field(1, "request", "message", cls=SeldonMessage),
        _Field(2, "response", "message", cls=SeldonMessage),
        _Field(3, "reward", "float"),
        _Field(4, "truth", "message", cls=SeldonMessage),
    )


class RequestResponse(Message):
    _FIELDS = (
        _Field(1, "request", "message", cls=SeldonMessage),
        _Field(2, "response", "message", cls=SeldonMessage),
    )


class SeldonMessageList(Message):
    _FIELDS = (
        _Field(1, "seldonMessages", "message", repeated=True, cls=SeldonMessage),
    )
