"""The PyTorch port's serving path on the CPU: scheduler, graph unit,
engine over HTTP, and the port's rules.

Greedy streams of the port's scheduler equal those of the JAX scheduler on
the same weights (the JAX model runs its Pallas kernels in interpret
mode).  Sampled streams cannot match across frameworks (their generators
differ), so sampling is checked inside the port only.
"""

import asyncio
import base64
import json
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.contract.codec import payload_from_dict as jax_payload_from_dict
from seldon_core_tpu.contract.codec import payload_to_dict as jax_payload_to_dict
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import resolve_device
from seldon_core_tpu_torch.contract.codec import CodecError, payload_from_dict, payload_to_dict
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService, load_predictor_spec
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import Implementation, PredictorSpec
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.weights import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [
    np.array([5, 9, 2, 17, 3], np.int32),
    np.array([30, 7], np.int32),
    np.array([1, 2, 3, 4], np.int32),  # waits for a free slot
]


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


async def _serve_all(sched, prompts, **kw):
    try:
        return await asyncio.gather(*(sched.submit(p, **kw) for p in prompts))
    finally:
        await sched.close()


def test_scheduler_greedy_streams_equal_the_jax_scheduler(tiny):
    cfg, jparams, tcfg, tparams = tiny
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, seq_impl="flash", decode_block=4,
                            decode_kernel=True)
    want = asyncio.run(_serve_all(JaxScheduler(jm), PROMPTS, max_new_tokens=6))
    tm = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, device="cpu")
    got = asyncio.run(_serve_all(GenerationScheduler(tm), PROMPTS, max_new_tokens=6))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert tm.host_syncs == tm.decode_blocks > 0
    assert tm.free_block_count == tm.kv_blocks - 1  # every reservation returned


def test_sampling_top1_is_greedy_and_seeds_reproduce(tiny):
    _, _, tcfg, tparams = tiny
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32))
    temps = torch.full((4,), 0.7)
    top1 = tl.sample_tokens(logits, temps, torch.Generator().manual_seed(1), top_k=1)
    assert top1.tolist() == torch.argmax(logits, -1).tolist()
    greedy = tl.sample_tokens(logits, torch.zeros(4), torch.Generator().manual_seed(1))
    assert greedy.tolist() == top1.tolist()

    def sampled(seed):
        m = GenerativeModel(tcfg, tparams, n_slots=1, decode_block=8, top_k=20, device="cpu")
        first = m.admit(0, PROMPTS[0], 0.9, seed, reserve_tokens=9)
        toks, _ = m.step_k(np.array([first], np.int32), np.ones(1, bool),
                           np.full(1, 0.9, np.float32), seed, np.full(1, -1, np.int32),
                           np.full(1, 8, np.int32), 8)
        return [first] + toks[:, 0].tolist()

    assert sampled(11) == sampled(11)


def _spec(**params) -> dict:
    return {
        "name": "p",
        "graph": {
            "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
            "parameters": [
                {"name": k, "value": str(v), "type": t} for k, (v, t) in params.items()
            ],
        },
    }


TINY_GRAPH = _spec(family=("llama", "STRING"), preset=("tiny", "STRING"),
                   n_slots=(2, "INT"), max_new_tokens=(8, "INT"), decode_block=(4, "INT"))


def _http(port, path, body=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode()),
        method=method or ("GET" if body is None else "POST"),
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_engine_answers_strdata_over_http():
    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(TINY_GRAPH), device="cpu"))
        await app.start("127.0.0.1", 0)
        port = app.port
        try:
            assert (await asyncio.to_thread(_http, port, "/ready"))[0] == 503
            await app.boot()
            calls = [
                ("/ping", None), ("/ready", None),
                ("/api/v0.1/predictions",
                 {"strData": json.dumps({"tokens": [5, 9, 2, 17, 3], "max_new_tokens": 8})}),
                ("/api/v0.1/predictions",
                 {"strData": json.dumps({"tokens": [5, 9, 2, 17, 3], "max_new_tokens": 8})}),
                ("/api/v0.1/predictions", {"data": {"ndarray": [[5, 9, 2, -1], [7, 7, 7, 7]]}}),
                ("/api/v0.1/predictions", b"{not json"),
                ("/nowhere", None),
            ]
            return [await asyncio.to_thread(_http, port, p, b) for p, b in calls]
        finally:
            await app.close()

    (ping, ready, gen, again, nd, bad, missing) = asyncio.run(go())
    assert ping == (200, b"pong") and ready == (200, b"ready")
    assert gen[0] == 200
    body = json.loads(gen[1])
    toks = json.loads(body["strData"])["tokens"]
    assert len(toks) == 8 and all(0 <= t < 256 for t in toks)
    assert body["status"] == {"code": 200, "status": "SUCCESS"}
    assert body["meta"]["requestPath"] == {"gen": "GenerativeComponent"}
    assert json.loads(json.loads(again[1])["strData"])["tokens"] == toks  # greedy repeats
    assert nd[0] == 200 and np.asarray(json.loads(nd[1])["data"]["ndarray"]).shape == (2, 8)
    assert bad[0] == 400 and missing[0] == 404


CACHED_GRAPH = _spec(family=("llama", "STRING"), preset=("tiny", "STRING"),
                     n_slots=(2, "INT"), max_new_tokens=(6, "INT"), decode_block=(4, "INT"),
                     kv_cache_dtype=("int8", "STRING"), kv_prefix_reuse=("true", "BOOL"),
                     prefill_chunk=(16, "INT"))


def test_engine_serves_int8_prefix_reuse_and_chunking_over_http():
    """The same graph spec with the three cache parameters: a prompt, one
    sharing its 2-block prefix, and the first again (now all but its last
    block reused) answer 200, and greedy replies repeat."""
    prompt = list(range(3, 43))  # 40 tokens: 3 chunks of 16

    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(CACHED_GRAPH), device="cpu"))
        await app.start("127.0.0.1", 0)
        try:
            await app.boot()
            bodies = [prompt, prompt[:32] + [90, 91, 92], prompt]
            return [await asyncio.to_thread(
                _http, app.port, "/api/v0.1/predictions",
                {"strData": json.dumps({"tokens": b})}) for b in bodies
            ], app.service.walker.component.model
        finally:
            await app.close()

    replies, model = asyncio.run(go())
    assert [code for code, _ in replies] == [200, 200, 200]
    toks = [json.loads(json.loads(body)["strData"])["tokens"] for _, body in replies]
    assert all(len(t) == 6 for t in toks) and toks[2] == toks[0]
    assert model.kv_dtype == "int8" and model.prefill_chunk == 16
    assert model.prefills_reused == 2 and model.prefix_snapshot()["tokens_reused"] == 64


def test_spec_parses_like_the_jax_package(monkeypatch):
    j = JaxPredictorSpec.model_validate(TINY_GRAPH)
    t = PredictorSpec.from_dict(TINY_GRAPH)
    assert (t.name, t.graph.name, t.graph.type.value, t.graph.implementation.value) == (
        j.name, j.graph.name, j.graph.type.value, j.graph.implementation.value
    )
    assert t.graph.parameters_dict() == j.graph.parameters_dict()
    assert [m.value for m in t.graph.resolved_methods()] == [
        m.value for m in j.graph.resolved_methods()
    ]
    with pytest.raises(ValueError):
        PredictorSpec.from_dict({"name": "p", "graph": {"name": "g", "type": "NOPE"}})
    monkeypatch.setenv("ENGINE_PREDICTOR", base64.b64encode(json.dumps(TINY_GRAPH).encode()).decode())
    assert load_predictor_spec().graph.parameters_dict()["preset"] == "tiny"


@pytest.mark.parametrize("msg", [
    {"data": {"names": ["a", "b"], "ndarray": [[1.0, 2.0]]}},
    {"data": {"tensor": {"shape": [2, 1], "values": [3.0, 4.0]}}},
    {"strData": "{\"tokens\": [1]}", "meta": {"puid": "x", "tags": {"t": 1}}},
])
def test_codec_matches_the_jax_codec(msg):
    t, j = payload_from_dict(msg), jax_payload_from_dict(msg)
    assert t.kind.value == j.kind.value and t.names == j.names
    assert payload_to_dict(t) == jax_payload_to_dict(j)
    with pytest.raises(CodecError):
        payload_from_dict({"binData": "not base64!"})


@pytest.mark.parametrize("name,value", [
    ("spec_heads_path", "/heads.npz"), ("mesh", "auto"), ("checkpoint", "/weights.npz"),
])
def test_later_slice_parameters_raise_by_name(name, value):
    # only the mesh is left to a later slice; checkpoint and spec_heads_path
    # are served (tests/test_torch_checkpoint.py), and a file that is not
    # there, or spec_heads_path without spec_method='heads', is refused by name
    assert registry.LATER_SLICE_PARAMS == ("mesh",)
    with pytest.raises(GraphUnitError, match=name):
        create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", name: value},
                       device="cpu")


@pytest.mark.parametrize("name,value,feature_on", [
    ("lora_rank", 8, lambda c: c.model.lora_rank == 8 and c.model.lora_pool is not None),
    ("lora_targets", "qkvo+mlp", lambda c: "w_down" in c.model._lora),
    ("lora_adapters", "a,b:3", lambda c: len(c.model.lora_pool) == 2),
    ("adapter", "a", lambda c: c.adapter == "a"),
])
def test_lora_parameters_are_served(name, value, feature_on):
    params = {"preset": "tiny", "lora_rank": 2, "lora_adapters": "a", name: value}
    comp = create_builtin(Implementation.JAX_GENERATIVE, params, device="cpu")
    assert feature_on(comp)


@pytest.mark.parametrize("name,value,feature_on", [
    ("kv_cache_dtype", "int8",
     lambda m: m.kv_dtype == "int8" and m._cache["k"].dtype == torch.int8 and "k_scale" in m._cache),
    ("prefill_chunk", 64, lambda m: m.prefill_chunk == 64),
    ("kv_prefix_reuse", True, lambda m: m.prefix_index is not None),
])
def test_slice3_parameters_switch_their_feature_on(name, value, feature_on):
    comp = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", name: value},
                          device="cpu")
    off = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny"}, device="cpu")
    assert feature_on(comp.model) and not feature_on(off.model)


def test_registry_rules():
    comp = registry.build_generative_component(
        preset="tiny", max_seq=32, device="cpu", spec_draft=0, overlap=False
    )
    assert comp.model.seq_impl == "flash" and comp.model.decode_kernel
    with pytest.raises(GraphUnitError, match="ring"):
        registry.build_generative_component(preset="tiny", seq_impl="ring", device="cpu")
    with pytest.raises(TypeError, match="maxseq"):
        registry.build_generative_component(preset="tiny", maxseq=3, device="cpu")
    with pytest.raises(GraphUnitError, match="family"):
        create_builtin(Implementation.JAX_MODEL, {}, device="cpu")
    with pytest.raises(GraphUnitError, match="no built-in"):
        create_builtin(Implementation.UNKNOWN_IMPLEMENTATION, {}, device="cpu")


def test_cuda_entry_points_raise_without_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the entry points run there")
    _, _, tcfg, tparams = tiny
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerativeModel(tcfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.build_generative_component(preset="tiny")
    from seldon_core_tpu_torch.engine import app

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main(["--port", "0"])


_FORBIDDEN = re.compile(r"import jax|from jax|seldon_core_tpu(?!_torch)")
# chip_smoke.py's kernel table names each TPU kernel it replaces by file:line
_PROVENANCE = re.compile(r'"seldon_core_tpu/[\w/]+\.py:\d+"')


# sct: test-hygiene-ok one short import probe in a fresh interpreter, no server or device
def test_port_never_imports_jax_or_the_jax_package():
    sources = sorted((ROOT / "seldon_core_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    # the port's own copies of modules the JAX package also has
    for module in ("cache/prefix.py", "cache/tiers.py", "models/llama.py",
                   "executor/generation.py", "executor/multihost.py", "disagg/handoff.py",
                   "executor/lora.py", "executor/memory.py",
                   "qos/context.py", "graphllm/cascade.py", "graphllm/guardrail.py",
                   "graph/walker.py", "models/mlp.py", "models/cnn.py", "models/resnet.py",
                   "models/bert.py", "executor/compiled.py", "executor/batcher.py",
                   "executor/component.py", "qos/admission.py", "obs/spans.py",
                   "obs/metering.py", "cache/content.py", "cache/singleflight.py",
                   "cache/semantic.py", "wire/h1client.py", "engine/transport.py",
                   "runtime/server.py", "runtime/microservice.py", "runtime/outlier.py",
                   "runtime/persistence.py", "executor/arbiter.py", "chaos/__init__.py",
                   "chaos/plan.py", "executor/checkpoint.py", "models/convert.py",
                   "proto/prediction.py", "proto/grpc_defs.py", "wire/hpack.py",
                   "wire/h2grpc.py", "engine/grpc_app.py", "engine/grpc_transport.py",
                   "runtime/grpc_service.py", "gateway/grpc_gateway.py", "utils/loops.py"):
        assert ROOT / "seldon_core_tpu_torch" / module in sources
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in sources
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if _FORBIDDEN.search(_PROVENANCE.sub("", line))
    ]
    assert not hits
    probe = (
        "import importlib, pkgutil, sys, seldon_core_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(seldon_core_tpu_torch.__path__, 'seldon_core_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'seldon_core_tpu', 'transformers', 'grpc')\n"
        "       or m.startswith('google.protobuf')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", probe], cwd=ROOT, check=True, timeout=120)
