"""The port's stdlib proto3 codec (``seldon_core_tpu_torch/proto``)
against the JAX package's generated ``prediction_pb2`` (protobuf on the
test side only), and its payload conversions against the JAX
``contract/codec.py``.

- Seeded cases over every message of ``prediction.proto`` and every
  member of every oneof: without map fields the bytes are equal both
  ways; with maps (``Meta.tags``/``routing``/``requestPath`` and the
  Structs inside Values) each side parses the other's bytes to an equal
  message.
- The edges: negative and extreme ``int32`` (ten-byte varints), an
  out-of-range ``int32`` refused by both, packed and unpacked repeated
  numbers on read, NaN/inf/-0.0 doubles and floats, float32 rounding,
  nested Values, unknown fields and groups skipped, a repeated singular
  message merged, a oneof's last member winning, truncated bytes refused.
- ``payload_to_proto``/``payload_from_proto`` and the feedback pair give
  the JAX functions' bytes and payloads, a NaN in an ndarray the same
  ValueError.

Tolerance: bytes exact; floats compared bit for bit."""

import math
import struct

import numpy as np
import pytest
from google.protobuf import json_format
from google.protobuf.message import DecodeError as PbDecodeError

from seldon_core_tpu.contract import codec as jcodec
from seldon_core_tpu.contract.payload import (
    DataKind as JKind,
    FeedbackPayload as JFeedback,
    Meta as JMeta,
    Metric as JMetric,
    Payload as JPayload,
)
from seldon_core_tpu.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.contract import codec as tcodec
from seldon_core_tpu_torch.contract.payload import (
    DataKind as TKind,
    FeedbackPayload as TFeedback,
    Meta as TMeta,
    Metric as TMetric,
    Payload as TPayload,
)
from seldon_core_tpu_torch.proto import prediction as tp

SPECIALS = [0.0, -0.0, 1.0, -2.5, 0.1, 1e300, -1e-300, math.inf, -math.inf, math.nan]
INT32S = [0, 1, -1, 127, 128, 300, 2**31 - 1, -(2**31), -5]


# -- seeded random messages, built in both packages from one description -------

def _text(rng) -> str:
    alphabet = "abcXYZ019 _-é✓€"
    return "".join(rng.choice(list(alphabet)) for _ in range(int(rng.integers(0, 6))))


def _double(rng, finite: bool = False) -> float:
    if rng.random() < 0.4:
        pool = [x for x in SPECIALS if math.isfinite(x)] if finite else SPECIALS
        return float(pool[int(rng.integers(len(pool)))])
    return float(rng.normal() * 10 ** int(rng.integers(-5, 6)))


def _json(rng, depth: int, finite: bool, structs: bool = True):
    """A JSON value; ``structs`` False leaves out objects (a Struct is a map)."""
    r = rng.random()
    if depth > 2 or r < 0.5:
        return [None, True, False, _double(rng, finite), float(int(rng.integers(-9, 9))),
                _text(rng)][int(rng.integers(6))]
    if r < 0.75 or not structs:
        return [_json(rng, depth + 1, finite, structs) for _ in range(int(rng.integers(0, 4)))]
    return {_text(rng) or "k": _json(rng, depth + 1, finite)
            for _ in range(int(rng.integers(0, 3)))}


def _status(rng) -> dict:
    return {"code": INT32S[int(rng.integers(len(INT32S)))], "info": _text(rng),
            "reason": _text(rng), "status": int(rng.integers(0, 3))}


def _meta(rng, maps: bool, finite: bool = False) -> dict:
    d = {"puid": _text(rng),
         "metrics": [{"key": _text(rng), "type": int(rng.integers(0, 3)),
                      "value": _double(rng, finite)} for _ in range(int(rng.integers(0, 3)))]}
    if maps:
        d["tags"] = {_text(rng): _json(rng, 1, True) for _ in range(int(rng.integers(0, 3)))}
        d["routing"] = {_text(rng): INT32S[int(rng.integers(len(INT32S)))]
                        for _ in range(int(rng.integers(0, 3)))}
        d["requestPath"] = {_text(rng): _text(rng) for _ in range(int(rng.integers(0, 3)))}
    return d


def _seldon(rng, maps: bool, finite: bool = False) -> dict:
    d: dict = {}
    if rng.random() < 0.5:
        d["status"] = _status(rng)
    if rng.random() < 0.7:
        d["meta"] = _meta(rng, maps, finite)
    which = int(rng.integers(0, 5))
    if which == 0:
        data: dict = {"names": [_text(rng) for _ in range(int(rng.integers(0, 3)))]}
        sub = int(rng.integers(0, 3))
        if sub == 0:
            n = int(rng.integers(0, 5))
            data["tensor"] = {"shape": [int(rng.integers(0, 9)) for _ in range(int(rng.integers(0, 3)))],
                              "values": [_double(rng, finite) for _ in range(n)]}
        elif sub == 1:
            data["ndarray"] = [_json(rng, 1, finite, structs=maps)
                               for _ in range(int(rng.integers(0, 4)))]
        d["data"] = data
    elif which == 1:
        d["binData"] = bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8))
    elif which == 2:
        d["strData"] = _text(rng)
    elif which == 3:
        d["rawTensor"] = {"shape": [int(rng.integers(0, 5)) for _ in range(int(rng.integers(0, 3)))],
                          "dtype": ["", "float32", "uint8"][int(rng.integers(3))],
                          "data": bytes(rng.integers(0, 256, int(rng.integers(0, 9)),
                                                     dtype=np.uint8)),
                          "names": [_text(rng) for _ in range(int(rng.integers(0, 3)))]}
    return d


def _pb_seldon(d: dict, m=None):
    m = m if m is not None else pb.SeldonMessage()
    m.SetInParent()  # present even when the description is empty
    if "status" in d:
        s = d["status"]
        m.status.code, m.status.info, m.status.reason, m.status.status = \
            s["code"], s["info"], s["reason"], s["status"]
    if "meta" in d:
        md = d["meta"]
        m.meta.puid = md["puid"]
        for x in md["metrics"]:
            m.meta.metrics.add(key=x["key"], type=x["type"], value=x["value"])
        for k, v in md.get("tags", {}).items():
            json_format.ParseDict(v, m.meta.tags[k])
        for k, v in md.get("routing", {}).items():
            m.meta.routing[k] = v
        for k, v in md.get("requestPath", {}).items():
            m.meta.requestPath[k] = v
    if "data" in d:
        data = d["data"]
        m.data.names.extend(data["names"])
        if "tensor" in data:
            m.data.tensor.shape.extend(data["tensor"]["shape"])
            m.data.tensor.values.extend(data["tensor"]["values"])
        if "ndarray" in data:
            json_format.ParseDict(data["ndarray"], m.data.ndarray)
    for k in ("binData", "strData"):
        if k in d:
            setattr(m, k, d[k])
    if "rawTensor" in d:
        rt = d["rawTensor"]
        m.rawTensor.shape.extend(rt["shape"])
        m.rawTensor.dtype, m.rawTensor.data = rt["dtype"], rt["data"]
        m.rawTensor.names.extend(rt["names"])
    return m


def _tp_seldon(d: dict) -> tp.SeldonMessage:
    m = tp.SeldonMessage()
    if "status" in d:
        m.status = tp.Status(**d["status"])
    if "meta" in d:
        md = dict(d["meta"])
        md["metrics"] = [tp.Metric(**x) for x in md["metrics"]]
        m.meta = tp.Meta(**md)
    if "data" in d:
        data = d["data"]
        m.data = tp.DefaultData(names=list(data["names"]),
                                tensor=tp.Tensor(**data["tensor"]) if "tensor" in data else None,
                                ndarray=data.get("ndarray"))
    for k in ("binData", "strData"):
        if k in d:
            setattr(m, k, d[k])
    if "rawTensor" in d:
        m.rawTensor = tp.RawTensor(**d["rawTensor"])
    return m


def _pair(kind: str, rng, maps: bool, finite: bool = False):
    """(pb message, port message) of one random description."""
    if kind == "SeldonMessage":
        d = _seldon(rng, maps, finite)
        return _pb_seldon(d), _tp_seldon(d)
    if kind == "Feedback":
        parts = {k: _seldon(rng, maps, finite) for k in ("request", "response", "truth")
                 if rng.random() < 0.6}
        reward = _double(rng, finite)
        pm = pb.Feedback(reward=reward)
        for k, d in parts.items():
            _pb_seldon(d, getattr(pm, k))
        return pm, tp.Feedback(reward=reward, **{k: _tp_seldon(d) for k, d in parts.items()})
    if kind == "RequestResponse":
        parts = {k: _seldon(rng, maps, finite) for k in ("request", "response") if rng.random() < 0.7}
        pm = pb.RequestResponse()
        for k, d in parts.items():
            _pb_seldon(d, getattr(pm, k))
        return pm, tp.RequestResponse(**{k: _tp_seldon(d) for k, d in parts.items()})
    ds = [_seldon(rng, maps, finite) for _ in range(int(rng.integers(0, 4)))]
    pm = pb.SeldonMessageList()
    for d in ds:
        _pb_seldon(d, pm.seldonMessages.add())
    return pm, tp.SeldonMessageList(seldonMessages=[_tp_seldon(d) for d in ds])


KINDS = ["SeldonMessage", "Feedback", "RequestResponse", "SeldonMessageList"]


@pytest.mark.parametrize("kind", KINDS)
def test_without_maps_the_bytes_equal_protobufs_both_ways(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    seen_oneofs = set()
    for _ in range(150):
        pm, tm = _pair(kind, rng, maps=False)
        want = pm.SerializeToString()
        assert tm.SerializeToString() == want
        assert tm.ByteSize() == pm.ByteSize()
        back = getattr(tp, kind).FromString(want)
        assert back.SerializeToString() == want  # read and rewritten unchanged
        assert getattr(pb, kind).FromString(tm.SerializeToString()).SerializeToString() == want
        if kind == "SeldonMessage":
            seen_oneofs.add((pm.WhichOneof("data_oneof"), back.WhichOneof("data_oneof"),
                             pm.data.WhichOneof("data_oneof") if pm.HasField("data") else None))
    if kind == "SeldonMessage":  # every member of both oneofs came up
        assert {w for w, _, _ in seen_oneofs} == {"data", "binData", "strData", "rawTensor",
                                                   None}
        assert {s for w, _, s in seen_oneofs if w == "data"} == {"tensor", "ndarray", None}
        assert all(a == b for a, b, _ in seen_oneofs)


@pytest.mark.parametrize("kind", KINDS)
def test_with_maps_each_side_parses_the_others_bytes_to_an_equal_message(kind):
    rng = np.random.default_rng(10 + KINDS.index(kind))
    cls = getattr(tp, kind)
    for _ in range(100):
        # finite numbers only: a NaN never equals itself
        pm, tm = _pair(kind, rng, maps=True, finite=True)
        assert getattr(pb, kind).FromString(tm.SerializeToString()) == pm
        assert cls.FromString(pm.SerializeToString()) == cls.FromString(tm.SerializeToString())


def test_the_parsed_json_values_are_what_message_to_dict_gives():
    rng = np.random.default_rng(7)
    for _ in range(100):
        d = _seldon(rng, maps=True)
        pm = _pb_seldon(d)
        back = tp.SeldonMessage.FromString(pm.SerializeToString())
        for k, v in pm.meta.tags.items():
            assert tp.value_from_json(back.meta.tags[k]) == json_format.MessageToDict(v)
        if pm.HasField("data") and pm.data.WhichOneof("data_oneof") == "ndarray":
            try:
                want = json_format.MessageToDict(pm.data.ndarray)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tp.value_from_json(back.data.ndarray)
            else:
                assert repr(tp.value_from_json(back.data.ndarray)) == repr(want)


# -- the edges -------------------------------------------------------------------

@pytest.mark.parametrize("code", INT32S)
def test_int32_and_enum_varints_equal_protobufs(code):
    want = pb.Status(code=code, status=code).SerializeToString()
    assert tp.Status(code=code, status=code).SerializeToString() == want
    assert tp.Status.FromString(want).code == code
    if code < 0:
        assert len(want) == 1 + 10 + 1 + 10  # sign-extended to ten bytes each


@pytest.mark.parametrize("code", [2**31, -(2**31) - 1])
def test_an_int32_out_of_range_is_refused_by_both(code):
    with pytest.raises(ValueError):
        pb.Status(code=code)
    with pytest.raises(ValueError):
        tp.Status(code=code).SerializeToString()


def test_unpacked_repeated_numbers_read_as_packed_ones():
    shape = b"".join(b"\x08" + bytes([n]) for n in (3, 5))
    values = b"".join(b"\x11" + struct.pack("<d", v) for v in (1.5, -2.0))
    raw = shape + values
    want = pb.Tensor.FromString(raw)
    got = tp.Tensor.FromString(raw)
    assert got.shape == list(want.shape) == [3, 5] and got.values == list(want.values)
    # mixed: one packed run then one unpacked element, as protobuf accepts
    mixed = b"\x0a\x02\x01\x02" + b"\x08\x07"
    assert tp.RawTensor.FromString(mixed).shape == list(pb.RawTensor.FromString(mixed).shape)
    assert tp.Tensor(shape=[3, 5], values=[1.5, -2.0]).SerializeToString() == \
        pb.Tensor(shape=[3, 5], values=[1.5, -2.0]).SerializeToString()


@pytest.mark.parametrize("value", SPECIALS + [1e40, -1e40, 3.4028235e38, 1e-46])
def test_floats_round_to_float32_as_protobufs(value):
    pm = pb.Metric(key="k", value=value)
    tm = tp.Metric(key="k", value=value)
    assert tm.SerializeToString() == pm.SerializeToString()
    back = tp.Metric.FromString(pm.SerializeToString()).value
    assert struct.pack("<d", back) == struct.pack("<d", pm.value) or \
        (math.isnan(back) and math.isnan(pm.value))
    fb = pb.Feedback(reward=value).SerializeToString()
    assert tp.Feedback(reward=value).SerializeToString() == fb


def test_nested_values_and_their_bytes():
    nd = [[1, [2.5, [None, {"a": [True, "x"]}]]], {}, [], "é", -0.0]
    pm = pb.SeldonMessage()
    json_format.ParseDict(nd, pm.data.ndarray)
    tm = tp.SeldonMessage(data=tp.DefaultData(ndarray=nd))
    assert tm.SerializeToString() == pm.SerializeToString()
    back = tp.SeldonMessage.FromString(pm.SerializeToString()).data.ndarray
    assert repr(back) == repr(json_format.MessageToDict(pm.data.ndarray))


def test_unknown_fields_and_groups_are_skipped():
    pm = _pb_seldon({"meta": {"puid": "p", "metrics": []}, "strData": "s"})
    raw = pm.SerializeToString()
    unknown = (b"\x78\x05"  # field 15 varint
               + b"\x81\x01" + b"\x00" * 8  # field 16 fixed64
               + b"\x8a\x01\x03abc"  # field 17 bytes
               + b"\x95\x01" + b"\x00" * 4  # field 18 fixed32
               + b"\x9b\x01" + b"\x08\x01" + b"\x9c\x01")  # field 19 group {1: 1}
    assert pb.SeldonMessage.FromString(raw + unknown).strData == "s"
    assert tp.SeldonMessage.FromString(raw + unknown) == tp.SeldonMessage.FromString(raw)
    # an unknown field inside a nested message and a Value
    meta = b"\x12\x05" + b"\x0a\x01q" + b"\x78\x00"
    assert tp.SeldonMessage.FromString(meta).meta.puid == \
        pb.SeldonMessage.FromString(meta).meta.puid == "q"


def test_a_repeated_singular_message_merges_and_the_last_oneof_member_wins():
    first = _pb_seldon({"meta": {"puid": "p", "metrics": []}, "binData": b"b"}).SerializeToString()
    second = _pb_seldon({"meta": {"puid": "", "metrics": [{"key": "k", "type": 1, "value": 2.0}]},
                         "strData": "s"}).SerializeToString()
    want = pb.SeldonMessage.FromString(first + second)
    got = tp.SeldonMessage.FromString(first + second)
    assert got.SerializeToString() == want.SerializeToString()
    assert got.meta.puid == "p" and len(got.meta.metrics) == 1
    assert got.WhichOneof("data_oneof") == want.WhichOneof("data_oneof") == "strData"
    assert got.binData is None


@pytest.mark.parametrize("raw", [b"\x12", b"\x12\x05\x0a", b"\x08", b"\x1d\x00\x00",
                                 b"\x08" + b"\xff" * 11, b"\x2a\x02\xff\xfe", b"\x07\x00"])
def test_malformed_bytes_are_refused_by_both(raw):
    with pytest.raises(PbDecodeError):
        pb.SeldonMessage.FromString(raw)
    with pytest.raises(tp.DecodeError):
        tp.SeldonMessage.FromString(raw)


def test_has_field_and_which_oneof_answer_as_protobufs():
    pm = pb.SeldonMessage(strData="")
    tm = tp.SeldonMessage(strData="")
    assert tm.SerializeToString() == pm.SerializeToString() == b"\x2a\x00"
    assert tm.HasField("strData") and pm.HasField("strData")
    assert not tm.HasField("meta") and not pm.HasField("meta")
    tm.binData = b"x"
    assert tm.WhichOneof("data_oneof") == "binData" and tm.strData is None
    with pytest.raises(ValueError):
        pb.Status().HasField("code")
    with pytest.raises(ValueError):
        tp.Status().HasField("code")


# -- the payload conversions against the JAX codec --------------------------------

def _payloads():
    arr = np.arange(6.0).reshape(2, 3)
    meta = dict(puid="u", tags={"x": 1.5, "y": [1, "a"], "z": None}, routing={"r": -1},
                request_path={"n": "img:1"})
    yield "tensor", arr, ["a", "b", "c"], meta
    yield "tensor0d", np.float64(3.0), [], meta
    yield "ndarray", np.array([[1, 2], [3, 4]]), ["p", "q"], meta
    yield "ndarray_mixed", np.array([[1, "x"]], dtype=object), [], {}
    yield "raw_uint8", np.arange(12, dtype=np.uint8).reshape(2, 2, 3), ["img"], meta
    yield "raw_f32", np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4), [], {}
    yield "binary", b"\x00\xffdata", [], meta
    yield "string", '{"tokens": [5, 9, 2]}', [], {}
    yield "empty", None, [], meta


_KIND = {"tensor": "TENSOR", "tensor0d": "TENSOR", "ndarray": "NDARRAY",
         "ndarray_mixed": "NDARRAY", "raw_uint8": "RAW", "raw_f32": "RAW", "binary": "BINARY",
         "string": "STRING", "empty": "EMPTY"}


@pytest.mark.parametrize("case", [c[0] for c in _payloads()])
def test_payload_conversions_give_the_jax_codecs_bytes_and_payloads(case):
    name, data, names, meta = next(c for c in _payloads() if c[0] == case)
    metrics = [("k", "GAUGE", 0.25), ("t", "TIMER", 1.5)] if meta else []
    jp = JPayload(data, list(names), getattr(JKind, _KIND[name]),
                  JMeta(**meta, metrics=[JMetric(*m) for m in metrics]))
    tpay = TPayload(data, list(names), getattr(TKind, _KIND[name]),
                    TMeta(**meta, metrics=[TMetric(*m) for m in metrics]))
    want = jcodec.payload_to_proto(jp)
    got = tcodec.payload_to_proto(tpay)
    if meta.get("tags") or meta.get("routing"):
        assert pb.SeldonMessage.FromString(got.SerializeToString()) == want
    else:
        assert got.SerializeToString() == want.SerializeToString()
    raw = want.SerializeToString()
    j = jcodec.payload_from_proto(pb.SeldonMessage.FromString(raw))
    t = tcodec.payload_from_proto(tp.SeldonMessage.FromString(raw))
    assert t.kind.value == j.kind.value and t.names == j.names
    assert (t.meta.puid, t.meta.tags, t.meta.routing, t.meta.request_path) == \
        (j.meta.puid, j.meta.tags, j.meta.routing, j.meta.request_path)
    assert [(m.key, m.type, m.value) for m in t.meta.metrics] == \
        [(m.key, m.type, m.value) for m in j.meta.metrics]
    if isinstance(j.data, np.ndarray):
        assert t.data.dtype == j.data.dtype and t.data.shape == j.data.shape
        assert t.data.tolist() == j.data.tolist()
    else:
        assert t.data == j.data


def test_bfloat16_raw_tensors_widen_to_float32_in_the_port():
    bits = np.array([0x3F80, 0xC040, 0x0000, 0x7F80], dtype="<u2")  # 1, -3, 0, inf
    raw = pb.SeldonMessage(rawTensor=pb.RawTensor(shape=[2, 2], dtype="bfloat16",
                                                  data=bits.tobytes())).SerializeToString()
    j = jcodec.payload_from_proto(pb.SeldonMessage.FromString(raw))
    t = tcodec.payload_from_proto(tp.SeldonMessage.FromString(raw))
    assert t.data.dtype == np.float32
    np.testing.assert_array_equal(t.data, j.data.astype(np.float32))


def test_feedback_conversions_give_the_jax_codecs_bytes():
    for reward in (0.0, 0.7, -1.0):
        jfb = JFeedback(request=JPayload(np.array([[1.0, 2.0]]), [], JKind.NDARRAY, JMeta()),
                        response=JPayload(None, [], JKind.EMPTY, JMeta(puid="r")),
                        reward=reward)
        tfb = TFeedback(request=TPayload(np.array([[1.0, 2.0]]), [], TKind.NDARRAY, TMeta()),
                        response=TPayload(None, [], TKind.EMPTY, TMeta(puid="r")),
                        reward=reward)
        raw = jcodec.feedback_to_proto(jfb).SerializeToString()
        assert tcodec.feedback_to_proto(tfb).SerializeToString() == raw
        back = tcodec.feedback_from_proto(tp.Feedback.FromString(raw))
        jback = jcodec.feedback_from_proto(pb.Feedback.FromString(raw))
        assert back.reward == jback.reward and back.truth is None is jback.truth
        assert back.response.meta.puid == jback.response.meta.puid == "r"
        assert back.request.data.tolist() == jback.request.data.tolist()


@pytest.mark.parametrize("bad", [math.nan, math.inf])
def test_a_non_finite_ndarray_number_raises_the_jax_value_error(bad):
    pm = pb.SeldonMessage()
    json_format.ParseDict([[1.0, bad]], pm.data.ndarray)
    raw = pm.SerializeToString()
    with pytest.raises(ValueError) as want:
        jcodec.payload_from_proto(pb.SeldonMessage.FromString(raw))
    with pytest.raises(ValueError) as got:
        tcodec.payload_from_proto(tp.SeldonMessage.FromString(raw))
    assert str(got.value) == str(want.value)
