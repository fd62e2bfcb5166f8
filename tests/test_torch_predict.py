"""The port's predict path on the CPU: ``executor/compiled.py``
(``CompiledModel``, ``BucketSpec``), ``executor/batcher.py``
(``BatchQueue``, the JAX package's ``TestBatchQueue`` cases plus the
intake bound and deadlines), ``executor/component.py`` and the
``JAX_MODEL`` unit: the slice as a whole against the JAX package's
``build_component`` on the same flax variables, and the engine serving
``JAX_MODEL`` graphs over HTTP (ndarray, tensor and uint8 rawTensor
bodies, a bandit with ``/feedback``, an outlier transformer before a
combiner, 429, 504, 400 and the parameters refused by name).

Replies are compared on log-probabilities within 1e-5 (float32; the two
sides sum in other orders, and a row's bits may depend on the bucket it
was padded into).
"""

import asyncio
import base64
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from torch import nn

from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu_torch import qos
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.batcher import BatchQueue
from seldon_core_tpu_torch.executor.compiled import BucketSpec, CompiledModel
from seldon_core_tpu_torch.executor.generation import QueueFull as GenerationQueueFull
from seldon_core_tpu_torch.graph.spec import Implementation, PredictorSpec
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import registry

LOG_TOL = 1e-5
run = asyncio.run


class Linear(nn.Module):
    """``x @ w + b`` that records the batch sizes it ran."""

    def __init__(self, din=4, dout=3):
        super().__init__()
        rng = np.random.default_rng(0)
        self.w = nn.Parameter(torch.from_numpy(rng.normal(size=(din, dout)).astype(np.float32)))
        self.b = nn.Parameter(torch.zeros(dout))
        self.seen: list[int] = []

    def forward(self, x):
        self.seen.append(x.shape[0])
        return x.to(self.w.dtype) @ self.w + self.b


def _want(model, x):
    w = model.module.w.detach().float().numpy()
    return x @ w


# ------------------------------------------------------------- CompiledModel


def test_compiled_model_pads_to_the_bucket_and_slices():
    m = CompiledModel(Linear(), buckets=BucketSpec((2, 4, 8)), device="cpu")
    x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    out = m(x)
    assert out.shape == (3, 3) and m.module.seen == [4]
    np.testing.assert_allclose(out, _want(m, x), rtol=1e-5)


def test_compiled_model_squeezes_a_single_row():
    m = CompiledModel(Linear(), device="cpu")
    assert m(np.ones(4, np.float32)).shape == (3,)


def test_compiled_model_chunks_an_oversized_batch():
    m = CompiledModel(Linear(), buckets=BucketSpec((2, 4)), device="cpu")
    x = np.random.default_rng(2).normal(size=(11, 4)).astype(np.float32)
    np.testing.assert_allclose(m(x), _want(m, x), rtol=1e-5)
    assert m.module.seen == [4, 4, 4]
    with pytest.raises(ValueError, match="exceeds max bucket"):
        m.dispatch(x)


def test_compiled_model_casts_floats_only():
    mod = Linear()
    mod.register_buffer("ids", torch.arange(3))
    mod.register_buffer("stats", torch.ones(3))
    mod.register_buffer("const", torch.ones(3), persistent=False)
    m = CompiledModel(mod, dtype=torch.bfloat16, device="cpu")
    assert m.module.w.dtype == m.module.stats.dtype == torch.bfloat16
    assert m.module.ids.dtype == torch.int64 and m.module.const.dtype == torch.float32
    assert m(np.ones((1, 4), np.float32)).dtype == np.float32  # widened exactly


def test_compiled_model_warmup_counts_the_buckets_and_canonicalizes_64_bits():
    m = CompiledModel(Linear(), buckets=BucketSpec((1, 2)), device="cpu")
    assert m.warmup((4,)) == 2 and m.module.seen == [1, 2]
    x = np.ones((1, 4), np.float64)  # a JSON batch: float64, run as float32
    np.testing.assert_allclose(m(x), _want(m, x.astype(np.float32)), rtol=1e-6)


def test_compiled_model_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the entry points run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledModel(Linear())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.build_component("mlp", preset="tiny")


# ----------------------------------------------------------------- BatchQueue


def test_concurrent_submits_coalesce():
    m = CompiledModel(Linear(), buckets=BucketSpec((1, 2, 4, 8, 16, 32)), device="cpu")

    async def go():
        q = BatchQueue(m, max_batch=32, max_delay_ms=20.0)
        xs = [np.random.default_rng(i).normal(size=(1, 4)).astype(np.float32) for i in range(16)]
        outs = await asyncio.gather(*(q.submit(x) for x in xs))
        await q.close()
        return xs, outs, q.steps

    xs, outs, steps = run(go())
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, _want(m, x), rtol=1e-5)
    assert steps < 16  # batched, not one step a request


def test_mixed_shapes_dont_mix():
    async def go():
        q = BatchQueue(lambda b: b * 2.0, max_batch=8, max_delay_ms=5.0)
        ra, rb = await asyncio.gather(q.submit(np.ones((1, 3), np.float32)),
                                      q.submit(np.ones((1, 5), np.float32)))
        await q.close()
        return ra, rb

    ra, rb = run(go())
    assert ra.shape == (1, 3) and rb.shape == (1, 5)


def test_close_fails_pending_requests():
    async def go():
        q = BatchQueue(lambda b: b, max_batch=4, max_delay_ms=50.0)
        t1 = asyncio.ensure_future(q.submit(np.ones((1, 2), np.float32)))
        await asyncio.sleep(0.005)
        await q.close()
        with pytest.raises(RuntimeError, match="closed"):
            await t1

    run(go())


def test_minority_shape_not_starved():
    seen = []

    def runner(b):
        seen.append(b.shape)
        return b

    async def go():
        q = BatchQueue(runner, max_batch=64, max_delay_ms=10.0)
        maj = [q.submit(np.ones((1, 3), np.float32)) for _ in range(6)]
        mino = q.submit(np.ones((1, 5), np.float32))
        await asyncio.wait_for(asyncio.gather(*maj, mino), timeout=5.0)
        await q.close()

    run(go())
    assert (1, 5) in seen and (6, 3) in seen


def test_runner_error_propagates():
    def bad(_):
        raise ValueError("boom")

    async def go():
        q = BatchQueue(bad, max_delay_ms=1.0)
        with pytest.raises(ValueError, match="boom"):
            await q.submit(np.ones((1, 2)))
        await q.close()

    run(go())


def test_queue_full_at_maxsize_is_the_engines_queue_full():
    release = threading.Event()
    calls = []

    def blocked(b):
        calls.append(b.shape[0])
        release.wait(5.0)
        return b

    async def go():
        q = BatchQueue(blocked, max_batch=1, max_delay_ms=0.0, maxsize=2)
        first = [asyncio.ensure_future(q.submit(np.ones((1, 2)))) for _ in range(2)]
        await asyncio.sleep(0.05)  # one step runs (blocked), one waits for the pipeline
        queued = [asyncio.ensure_future(q.submit(np.ones((1, 2)))) for _ in range(2)]
        await asyncio.sleep(0.05)
        with pytest.raises(qos.QueueFull, match="full"):
            await q.submit(np.ones((1, 2)))
        release.set()
        outs = await asyncio.wait_for(asyncio.gather(*first, *queued), timeout=5.0)
        await q.close()
        return outs

    outs = run(go())
    assert len(outs) == 4 and len(calls) == 4
    assert qos.QueueFull is GenerationQueueFull  # one class, which the engine maps to 429


def test_expired_deadline_fails_without_a_step():
    calls = []

    async def go():
        q = BatchQueue(lambda b: calls.append(b) or b, max_delay_ms=1.0)
        qos.set_deadline(time.monotonic() - 0.001)
        with pytest.raises(qos.DeadlineExceeded, match="deadline"):
            await q.submit(np.ones((1, 2)))
        qos.set_deadline(None)
        await q.submit(np.ones((1, 2)))
        await q.close()
        return q

    q = run(go())
    assert len(calls) == 1 and q.steps == 1 and q.deadline_drops == 1


def test_cancelled_request_is_skipped():
    seen = []

    async def go():
        q = BatchQueue(lambda b: seen.append(b.shape[0]) or b, max_batch=64, max_delay_ms=20.0)
        gone = asyncio.ensure_future(q.submit(np.ones((3, 2))))
        await asyncio.sleep(0)  # queued
        gone.cancel()
        out = await q.submit(np.ones((2, 2)))
        await q.close()
        return out

    assert run(go()).shape == (2, 2) and seen == [2]


# ------------------------------------------------------- the slice vs JAX


@pytest.fixture(scope="module")
def flax_vars():
    cache: dict = {}

    def get(family):
        if family not in cache:
            fam, cfg = jax_registry.get_family(family), jax_registry.resolve_config(family, "tiny")
            cache[family] = jax.device_get(
                jax.jit(lambda k: fam.init_params(k, cfg))(jax.random.PRNGKey(0)))
        return cache[family]

    return get


def _requests(family, rng):
    cfg = registry.resolve_family_config(family, "tiny")
    out = []
    for rows in (1, 3, 5):
        if family == "bert":
            x = rng.integers(1, cfg.vocab_size, size=(rows, 16)).astype(np.int32)
            x[:, 10:] = cfg.pad_id
        else:
            x = registry.example_input(family, cfg, rows)
            x = rng.normal(size=x.shape).astype(np.float32)
        out.append(x)
    return out


@pytest.mark.parametrize("family", ["mlp", "cnn", "resnet", "bert"])
def test_component_equals_the_jax_build_component(flax_vars, family):
    variables = flax_vars(family)
    xs = _requests(family, np.random.default_rng(5))

    async def serve(comp):
        try:
            return await asyncio.gather(*(comp.predict(x, []) for x in xs))
        finally:
            await comp.close()

    want = run(serve(jax_registry.build_component(family, preset="tiny", params=variables,
                                                  max_delay_ms=20.0)))
    port = registry.build_component(family, preset="tiny", params=variables, device="cpu",
                                    max_delay_ms=20.0)
    got = run(serve(port))
    assert port.queue.steps < len(xs)  # the three requests shared a step
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        np.testing.assert_allclose(np.log(g), np.log(np.asarray(w, np.float32)), atol=LOG_TOL)


# ------------------------------------------------------------- the engine


def _param(name, value, kind="STRING"):
    return {"name": name, "value": str(value), "type": kind}


def _unit(name, family, rng=0, **extra):
    params = [_param("family", family), _param("preset", "tiny"), _param("rng", rng, "INT"),
              _param("max_delay_ms", "2.0", "FLOAT")]
    params += [_param(k, v, t) for k, (v, t) in extra.items()]
    return {"name": name, "type": "MODEL", "implementation": "JAX_MODEL", "parameters": params}


async def _engine(graph):
    app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                      device="cpu"))
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


def _http(port, path, body, headers=None):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _raw(arr: np.ndarray) -> dict:
    return {"rawTensor": {"shape": list(arr.shape), "dtype": arr.dtype.name,
                          "data": base64.b64encode(arr.tobytes()).decode()}}


def _unraw(reply: dict) -> np.ndarray:
    rt = reply["rawTensor"]
    return np.frombuffer(base64.b64decode(rt["data"]), rt["dtype"]).reshape(rt["shape"])


def test_engine_serves_ndarray_tensor_and_uint8_rawtensor_bodies():
    graph = {"name": "top", "type": "ROUTER", "implementation": "SIMPLE_ROUTER", "children": [
        _unit("res", "resnet", input_dtype=("uint8", "STRING"), buckets=("2,4", "STRING"),
              class_names=("a,b,c,d,e,f,g,h,i,j", "STRING"))]}
    px = np.random.default_rng(6).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)

    async def go():
        app = await _engine(graph)
        try:
            comp = dict(app.service.walker.iter_components())["res"]
            assert app.warmup_report == {"res": 2}  # both buckets, in uint8
            replies = await asyncio.gather(*(asyncio.to_thread(_http, app.port, p, b) for p, b in (
                ("/api/v0.1/predictions", _raw(px)),
                ("/api/v0.1/predictions", {"data": {"ndarray": px.tolist()}}),
                ("/api/v0.1/predictions", {"data": {"tensor": {"shape": list(px.shape),
                                                               "values": px.ravel().tolist()}}}),
            )))
            return replies, comp.model(px), comp.model(px.astype(np.float32))
        finally:
            await app.close()

    (raw, nd, tensor), want_u8, want_f32 = run(go())
    assert raw[0] == nd[0] == tensor[0] == 200
    assert raw[1]["rawTensor"]["dtype"] == "float32"  # a rawTensor request, a rawTensor reply
    np.testing.assert_allclose(_unraw(raw[1]), want_u8, rtol=1e-5, atol=1e-7)
    assert raw[1]["rawTensor"]["names"] == list("abcdefghij")
    # JSON numbers arrive as int64/float64: run as int32/float32, not uint8
    np.testing.assert_allclose(np.asarray(nd[1]["data"]["ndarray"]), want_f32, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(tensor[1]["data"]["tensor"]["values"]).reshape(3, -1),
                               want_f32, rtol=1e-5)


def test_engine_epsilon_greedy_over_two_mlps_with_feedback():
    graph = {"name": "ab", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
             "parameters": [_param("n_branches", 2, "INT"), _param("epsilon", 0.5, "FLOAT"),
                            _param("seed", 3, "INT")],
             "children": [_unit("m0", "mlp", 0), _unit("m1", "mlp", 1)]}
    rows = np.random.default_rng(7).normal(size=(2, 16)).round(3)

    async def go():
        app = await _engine(graph)
        try:
            comps = dict(app.service.walker.iter_components())
            out = []
            for _ in range(6):
                body = {"data": {"ndarray": rows.tolist()}}
                code, reply = await asyncio.to_thread(_http, app.port, "/api/v0.1/predictions",
                                                      body)
                branch = reply["meta"]["routing"]["ab"]
                fb = await asyncio.to_thread(_http, app.port, "/api/v0.1/feedback", {
                    "request": body, "response": reply, "reward": float(branch)})
                out.append((code, fb[0], branch, np.asarray(reply["data"]["ndarray"])))
            direct = [comps[f"m{b}"].model(rows) for b in (0, 1)]
            return out, direct, comps["ab"]
        finally:
            await app.close()

    out, direct, router = run(go())
    assert all(code == 200 and fb == 200 for code, fb, _, _ in out)
    for _, _, branch, reply in out:
        np.testing.assert_allclose(reply, direct[branch], rtol=1e-5)
    branches = [b for _, _, b, _ in out]
    assert router.pulls.tolist() == [branches.count(0), branches.count(1)]
    assert router.value.tolist() == [0.0, 1.0 if 1 in branches else 0.0]


def test_engine_outlier_transformer_before_a_combiner_over_two_berts():
    graph = {"name": "outlier", "type": "TRANSFORMER", "implementation": "MAHALANOBIS_OUTLIER",
             "children": [{"name": "ens", "type": "COMBINER",
                           "implementation": "AVERAGE_COMBINER",
                           "children": [_unit("b0", "bert", 0), _unit("b1", "bert", 1)]}]}
    ids = np.random.default_rng(8).integers(1, 128, size=(3, 16))
    ids[2, 5:] = 0

    async def go():
        app = await _engine(graph)
        try:
            comps = dict(app.service.walker.iter_components())
            replies = [await asyncio.to_thread(_http, app.port, "/api/v0.1/predictions",
                                               {"data": {"ndarray": ids.tolist()}})
                       for _ in range(3)]
            direct = [comps[n].model(ids) for n in ("b0", "b1")]
            return replies, direct
        finally:
            await app.close()

    replies, direct = run(go())
    for code, reply in replies:
        assert code == 200
        np.testing.assert_allclose(np.asarray(reply["data"]["ndarray"]),
                                   (direct[0] + direct[1]) / 2, rtol=1e-5)
        assert len(reply["meta"]["tags"]["outlier_score"]) == 3
        assert set(reply["meta"]["requestPath"]) == {"outlier", "ens", "b0", "b1"}
    assert replies[-1][1]["meta"]["tags"]["outlier_score"][0] > 0  # scored after 3 rows


def test_engine_answers_429_504_and_400(monkeypatch):
    monkeypatch.setenv("SCT_BATCH_PIPELINE", "1")  # one step in flight
    # the expired request must reach the queue: admission's predictive shed
    # would answer it 429 once the flight recorder's stages hold samples
    monkeypatch.setenv("SCT_QOS_PREDICTIVE", "0")
    graph = _unit("m", "mlp", max_queue=("1", "INT"), max_batch=("1", "INT"))
    row = {"data": {"ndarray": [[0.5] * 16]}}
    bad_bodies = [
        {"rawTensor": {"shape": [1, 16], "dtype": "float32", "data": "not base64!"}},
        {"rawTensor": {"shape": [1, 16], "dtype": "complex64", "data": ""}},
        {"rawTensor": {"shape": [2, 16], "dtype": "float32",
                       "data": base64.b64encode(b"\0" * 64).decode()}},
    ]

    async def go(app):
        async def post(body, headers=None):
            return await asyncio.to_thread(_http, app.port, "/api/v0.1/predictions", body,
                                           headers)

        q = dict(app.service.walker.iter_components())["m"].queue
        release, dispatch = threading.Event(), q._dispatch

        def blocked(b):
            release.wait(10.0)
            return dispatch(b)

        q._dispatch = blocked
        # one step blocked in flight, one request waiting for the pipeline,
        # one in the queue (its bound): the next is refused
        first = []
        for _ in range(3):
            first.append(asyncio.ensure_future(post(row)))
            await asyncio.sleep(0.1)
        full = await post(row)
        release.set()
        served = await asyncio.gather(*first)
        late = await post(row, {qos.DEADLINE_HEADER: "0.001"})
        bad = [await post(body) for body in bad_bodies]
        return full, served, late, bad, q

    async def main():
        app = await _engine(graph)
        try:
            return await go(app)
        finally:
            await app.close()

    full, served, late, bad, q = run(main())
    assert q._closed  # the engine's shutdown closed the unit's queue
    assert full[0] == 429 and "full" in full[1]["status"]["info"]
    assert [code for code, _ in served] == [200, 200, 200]
    assert late[0] == 504 and q.deadline_drops == 1
    assert [code for code, _ in bad] == [400, 400, 400]


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "float16", "bfloat16", "bool"])
def test_codec_decodes_rawtensor_as_the_jax_codec(dtype):
    """The same wire bytes through both codecs: equal values, shape and
    names, a writable array; bfloat16 bit patterns widen to float32 in the
    port (numpy has no bfloat16 without ml_dtypes), exactly."""
    from seldon_core_tpu.contract.codec import payload_from_dict as jax_from_dict
    from seldon_core_tpu_torch.contract.codec import payload_from_dict, payload_to_dict

    bits = np.random.default_rng(9).integers(0, 2 ** 16, 12).astype(np.uint16)
    raw = {"uint8": bits.astype(np.uint8), "int32": bits.astype(np.int32) - 999,
           "float32": bits.astype(np.float32) / 7, "float16": bits.astype(np.float16) / 3,
           "bfloat16": bits & 0x7F7F, "bool": bits % 2 == 0}[dtype]
    msg = {"rawTensor": {"shape": [3, 4], "dtype": dtype, "names": ["a", "b", "c", "d"],
                         "data": base64.b64encode(raw.tobytes()).decode()}}
    got, want = payload_from_dict(msg), jax_from_dict(msg)
    assert got.kind.value == want.kind.value == "rawTensor" and got.names == want.names
    assert got.data.flags.writeable and got.data.shape == (3, 4)
    np.testing.assert_array_equal(got.data, np.asarray(want.data).astype(got.data.dtype))
    if dtype == "bfloat16":
        assert got.data.dtype == np.float32
    else:
        assert got.data.dtype == want.data.dtype
        enc = payload_to_dict(got)["rawTensor"]  # and back to the same bytes
        assert (enc["dtype"], enc["shape"], enc["data"]) == (dtype, [3, 4],
                                                             msg["rawTensor"]["data"])


def test_codec_decodes_bindata_and_refuses_malformed_bodies():
    from seldon_core_tpu.contract.codec import payload_from_dict as jax_from_dict
    from seldon_core_tpu_torch.contract.codec import (
        CodecError,
        payload_from_dict,
        payload_to_dict,
    )

    msg = {"binData": base64.b64encode(b"\x00\x01raw").decode()}
    got = payload_from_dict(msg)
    assert got.data == jax_from_dict(msg).data == b"\x00\x01raw"
    assert payload_to_dict(got, include_meta=False) == msg
    for bad in ({"binData": "not base64!"},
                {"rawTensor": {"dtype": "complex64", "data": ""}},
                {"rawTensor": {"dtype": "float32", "shape": [3], "data": "AAAA"}},
                {"rawTensor": {"dtype": "float32"}},
                {"rawTensor": "nope"}):
        with pytest.raises(CodecError):
            payload_from_dict(bad)


@pytest.mark.parametrize("name,value", [("mesh", "auto"), ("checkpoint", "/weights.npz"),
                                        ("sharding", "fsdp")])
def test_later_slice_model_parameters_raise_by_name(name, value):
    with pytest.raises(GraphUnitError, match=name):
        create_builtin(Implementation.JAX_MODEL, {"family": "mlp", "preset": "tiny",
                                                  name: value}, device="cpu")


@pytest.mark.parametrize("params,match", [
    ({}, "family"), ({"family": "vgg"}, "vgg"), ({"family": "mlp", "hiden": 3}, "hiden"),
    ({"family": "mlp", "buckets": "4,x"}, "buckets"), ({"family": "mlp", "dtype": "int8"}, "dtype"),
    ({"family": "bert", "input_shape": "0"}, "input_shape"),
])
def test_model_unit_refuses_bad_parameters(params, match):
    with pytest.raises(GraphUnitError, match=match):
        create_builtin(Implementation.JAX_MODEL, params, device="cpu")


def test_model_unit_serves_every_jax_parameter():
    comp = create_builtin(Implementation.JAX_MODEL, {
        "family": "mlp", "preset": "tiny", "dtype": "bfloat16", "max_batch": 8,
        "max_delay_ms": 1.5, "max_queue": 9, "buckets": "8,2", "input_dtype": "float16",
        "class_names": "x,y,z", "rng": 4, "n_classes": 3, "sharding": "default"}, device="cpu")
    assert comp.model.buckets.sizes == (2, 8) and comp.model.name == "mlp:tiny"
    assert comp.model.module.head.weight.dtype == torch.bfloat16
    assert (comp.queue.max_batch, comp.queue.max_delay, comp.queue.maxsize) == (8, 0.0015, 9)
    assert comp.warmup_example.dtype == np.float16 and comp.class_names == ["x", "y", "z"]
    bert = create_builtin(Implementation.JAX_MODEL, {"family": "bert", "preset": "tiny",
                                                     "input_shape": "24", "buckets": "2"},
                          device="cpu")
    assert bert.warmup_example.shape == (1, 24) and bert.warmup_example.dtype == np.int32
    assert bert.warmup() == 1  # one bucket, warmed at 24 tokens a row
    direct = create_builtin(Implementation.JAX_MODEL, {"family": "mlp", "preset": "tiny",
                                                       "batching": False}, device="cpu")
    assert direct.queue is None and run(direct.predict(np.ones((2, 16)), [])).shape == (2, 3)
