"""The port's batched multi-LoRA serving and memory ledger on the CPU,
inside the port (the parity with the JAX package is
``tests/test_torch_lora.py``).

Bit for bit: a null-adapter row equals a LoRA-off build (greedy, seeded
top-k, speculation with each proposer, chunked prefill, prefix reuse, int8
KV, a handoff); a mixed batch equals each adapter's solo run; with
adapters bound speculation on equals off, chunked equals monolithic and
reuse equals cold; prefix chains never cross adapters; registering an
adapter writes the pool's rows in place.  The adapter pool and the memory
ledger take the JAX package's cases; the engine selects a request's
adapter and answers 400 for one it does not hold.  The port's seeded
stand-in factors differ from the JAX package's (their generators differ)
and are checked here only.
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.cache.prefix import adapter_salt
from seldon_core_tpu_torch.disagg import handoff as th
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.generation import (
    GenerationScheduler,
    GenerativeComponent,
    GenerativeModel,
)
from seldon_core_tpu_torch.executor.lora import AdapterPool, AdapterPoolFull
from seldon_core_tpu_torch.executor.memory import HBMOverCommit, MemoryManager, hbm_budget_bytes
from seldon_core_tpu_torch.graph.spec import Implementation, PredictorSpec
from seldon_core_tpu_torch.graph.units import GraphUnitError, RandomABTest, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

RANK = 2
PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4], [11, 13, 17, 19, 23]]
LORA_KW = dict(lora_rank=RANK, lora_slots=4, lora_adapters="alpha,beta")
MLP_KW = dict(LORA_KW, lora_targets="qkvo+mlp")
ALL = tl.LORA_ATTN_TARGETS + tl.LORA_MLP_TARGETS


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _model(tiny, **kw):
    _, _, tcfg, tparams = tiny
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_block", 4)
    return GenerativeModel(tcfg, tparams, device="cpu", **kw)


def _generate(model, prompts=PROMPTS, adapters=None, *, seed=123, max_new=9, overlap=None,
              **kw):
    sched = (GenerationScheduler(model) if overlap is None
             else GenerationScheduler(model, overlap=overlap))
    sched._seed = seed

    async def go():
        try:
            return await asyncio.gather(*(
                sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                             adapter=adapters[i] if adapters else None, **kw)
                for i, p in enumerate(prompts)))
        finally:
            await sched.close()

    return [o.tolist() for o in asyncio.run(go())]



NULL_CASES = {
    "greedy": ({}, {}),
    "top_k_sampled": ({"top_k": 5}, {"temperature": 0.9}),
    "spec_ngram": ({"spec_draft": 3}, {}),
    "spec_heads": ({"spec_draft": 3, "spec_method": "heads"}, {}),
    "spec_draft": ({"spec_draft": 3, "spec_method": "draft", "spec_draft_model": "truncate:1"},
                   {}),
    "chunked": ({"prefill_chunk": 16}, {}),
    "int8": ({"kv_cache_dtype": "int8"}, {}),
}


@pytest.mark.parametrize("case", sorted(NULL_CASES))
def test_null_adapter_rows_equal_a_lora_off_build(tiny, case):
    model_kw, submit_kw = NULL_CASES[case]
    prompts = PROMPTS + [list(range(3, 40))] if case == "chunked" else PROMPTS
    off = _generate(_model(tiny, **model_kw), prompts, **submit_kw)
    on = _generate(_model(tiny, **MLP_KW, **model_kw), prompts, **submit_kw)
    assert on == off


def test_null_adapter_reuse_and_handoff_equal_a_lora_off_build(tiny):
    shared = list(range(7, 39))
    prompts = [shared + [50], shared + [51, 52]]

    def reuse(**kw):
        model = _model(tiny, n_slots=2, prefix_reuse=True, **kw)
        out = [_generate(model, [p])[0] for p in prompts]
        return out, model.prefills_reused

    assert reuse(**LORA_KW) == reuse() and reuse()[1] == 1
    frames = []
    for kw in ({}, LORA_KW):
        src = _model(tiny, n_slots=2, **kw)
        tok = src.admit(0, np.asarray(PROMPTS[0], np.int32), 0.0, 0, reserve_tokens=9)
        frames.append(th.build_handoff_frame(src, 0, np.asarray(PROMPTS[0], np.int32), tok,
                                             max_new_tokens=9))
    assert frames[0] == frames[1]  # no adapter field, the same blocks
    unified = _generate(_model(tiny, n_slots=2), [PROMPTS[0]])[0]
    comp = GenerativeComponent(_model(tiny, n_slots=2, **LORA_KW))

    async def go():
        try:
            return await th.apply_handoff(comp, th.decode_handoff(frames[1]))
        finally:
            await comp.close()

    assert asyncio.run(go()).tolist() == unified


def test_mixed_batch_equals_solo_runs(tiny):
    base = _generate(_model(tiny))
    mixed = _generate(_model(tiny, **MLP_KW), adapters=["alpha", None, "beta", None])
    alpha = _generate(_model(tiny, **MLP_KW), adapters=["alpha"] * 4)
    beta = _generate(_model(tiny, **MLP_KW), adapters=["beta"] * 4)
    assert mixed[0] == alpha[0] and mixed[2] == beta[2]
    assert mixed[1] == base[1] and mixed[3] == base[3]
    # each adapter changes generations (a row whose logits keep their
    # argmax under a small delta may keep its stream)
    assert alpha != base and beta != base and alpha != beta


@pytest.mark.parametrize("case", ["spec_on_off", "chunked_monolithic", "reuse_cold"])
def test_adapter_bound_streams_keep_the_feature_invariants(tiny, case):
    """With adapters bound: speculation on equals off, a chunked prefill
    equals the monolithic one, and a reused prefix equals a cold one."""
    adapters = ["alpha", "beta", None, "alpha"]
    if case == "spec_on_off":
        for method in ("ngram", "heads"):
            on = _generate(_model(tiny, spec_draft=3, spec_method=method, **LORA_KW),
                           adapters=adapters)
            assert on == _generate(_model(tiny, **LORA_KW), adapters=adapters), method
        return
    long = [list(range(3, 40)), list(range(50, 90)) + [7]]
    if case == "chunked_monolithic":
        chunked = _model(tiny, n_slots=2, prefill_chunk=16, **LORA_KW)
        assert (_generate(chunked, long, ["alpha", "beta"])
                == _generate(_model(tiny, n_slots=2, **LORA_KW), long, ["alpha", "beta"]))
        assert chunked.prefill_chunks >= 4
        return
    model = _model(tiny, n_slots=2, prefix_reuse=True, **LORA_KW)
    cold = _generate(_model(tiny, n_slots=2, **LORA_KW), [long[0]], ["alpha"])
    warm = [_generate(model, [long[0]], ["alpha"])[0] for _ in range(2)]
    assert warm == cold * 2 and model.prefills_reused == 1


def test_chains_never_cross_adapters(tiny):
    prompt = list(range(7, 39)) + [50]  # 2 full blocks + 1
    model = _model(tiny, n_slots=2, prefix_reuse=True, **LORA_KW)
    reused = []
    for adapter in ("alpha", "alpha", "beta", None, None):
        _generate(model, [prompt], [adapter], max_new=4)
        reused.append(model.prefills_reused)
    assert reused == [0, 1, 1, 1, 2]
    tokens = np.asarray(prompt, np.int32)
    assert model.export_prefix_kv(tokens, adapter="beta")[0] == 2
    assert model.export_prefix_kv(tokens, adapter="gamma") is None  # never registered
    depth, k, v, _, _ = model.export_prefix_kv(tokens, adapter="alpha")
    other = _model(tiny, n_slots=2, prefix_reuse=True, **LORA_KW)
    assert other.install_prefix_chain(tokens, k, v, adapter="alpha") == depth == 2
    assert other.prefix_index.peek_depth(tokens, 2) == 0
    assert other.prefix_index.peek_depth(tokens, 2, adapter_salt("alpha")) == 2
    with pytest.raises(GraphUnitError, match="not resident"):
        other.install_prefix_chain(tokens, k, v, adapter="gamma")


def test_unknown_adapter_and_lora_off_are_client_errors(tiny):
    with pytest.raises(GraphUnitError, match="not resident"):
        _generate(_model(tiny, **LORA_KW), [PROMPTS[0]], ["missing"])
    with pytest.raises(GraphUnitError, match="without multi-LoRA"):
        _generate(_model(tiny), [PROMPTS[0]], ["alpha"])
    model = _model(tiny, **LORA_KW)
    with pytest.raises(GraphUnitError, match="not resident"):
        model.admit(0, np.asarray(PROMPTS[0], np.int32), 0.0, 0, adapter="missing")
    assert model.adapters_snapshot()["adapters"]["alpha"]["slots"] == 0


def test_token_ledger_and_slot_refs(tiny):
    model = _model(tiny, **LORA_KW)
    _generate(model, adapters=["alpha", "alpha", "beta", None], max_new=8)
    snap = model.adapters_snapshot()
    assert snap["resident"] == 2 and snap["bytes"] == model.lora_bytes > 0
    # the prefill emits the first token, the decode blocks deliver the rest
    assert snap["adapters"]["alpha"]["tokens"] == 2 * 7
    assert snap["adapters"]["beta"]["tokens"] == 7
    assert all(a["slots"] == 0 for a in snap["adapters"].values())
    model.admit(1, np.asarray(PROMPTS[0], np.int32), 0.0, 0, adapter="beta")
    assert model.slot_adapter(1) == "beta" and model.slot_adapter(0) is None
    model.release_slot(1)
    assert model.slot_adapter(1) is None and int(model._slot_aidx[1]) == 0


def test_registration_writes_the_pool_rows_in_place(tiny):
    """Registering, refreshing and evicting an adapter mid-traffic writes
    the pool's rows in place (the captured blocks keep reading the same
    storage), the LRU evicts an idle row, and the decode block picks the
    new factors up."""
    model = _model(tiny, n_slots=2, lora_rank=RANK, lora_slots=3, lora_adapters="alpha,beta")
    ptrs = {t: (f["a"].data_ptr(), f["b"].data_ptr()) for t, f in model._lora.items()}
    before = _generate(model, [PROMPTS[0]], ["beta"])
    assert model.register_adapter("gamma", seed=99) == 1  # alpha is the LRU idle row
    assert "alpha" not in model.lora_pool and model.lora_pool.evictions == 1
    gamma = _generate(model, [PROMPTS[0]], ["gamma"])
    fresh = _model(tiny, n_slots=2, lora_rank=RANK, lora_slots=3, lora_adapters="gamma:99")
    assert gamma == _generate(fresh, [PROMPTS[0]], ["gamma"]) != before
    assert {t: (f["a"].data_ptr(), f["b"].data_ptr()) for t, f in model._lora.items()} == ptrs
    model.register_adapter("beta", seed=5)  # a refresh keeps the row
    assert model.lora_pool.snapshot()["adapters"]["beta"]["id"] == 2
    assert _generate(model, [PROMPTS[0]], ["beta"]) != before


def test_seeded_factors_are_reproducible_and_distinct(tiny):
    _, _, tcfg, _ = tiny

    def draw(seed):
        return tl.lora_adapter_factors(torch.Generator().manual_seed(seed), tcfg, RANK, ALL)

    a, b, c = draw(1), draw(1), draw(2)
    for t in ALL:
        assert torch.equal(a[t]["a"], b[t]["a"]) and torch.equal(a[t]["b"], b[t]["b"])
        assert not torch.equal(a[t]["b"], c[t]["b"])
        assert a[t]["a"].shape == (tcfg.n_layers,) + tl._lora_shapes(tcfg, RANK)[t][0]
    m1, m2 = _model(tiny, **LORA_KW), _model(tiny, **LORA_KW)
    assert all(torch.equal(m1._lora[t]["a"], m2._lora[t]["a"]) for t in m1._lora)
    assert not torch.any(m1._lora["wq"]["b"][:, 0])  # the null row stays zero


class TestAdapterPool:
    """The JAX package's pool cases, on the port's copy."""

    def _pool(self, n=4):
        writes = []
        return AdapterPool(n, 2, writer=lambda idx, fac: writes.append((idx, fac))), writes

    def test_register_assigns_rows_and_writes(self):
        pool, writes = self._pool()
        assert pool.register("a", "fa") == 1 and pool.register("b", "fb") == 2
        assert pool.register("a", "fa2") == 1  # a refresh keeps the row
        assert [w[0] for w in writes] == [1, 2, 1]
        assert "a" in pool and "c" not in pool

    def test_lru_eviction_under_pressure(self):
        pool, _ = self._pool(n=3)
        pool.register("a", None)
        pool.register("b", None)
        pool.acquire("a")
        pool.release_ref(1)
        assert pool.register("c", None) == 2  # b was the least recently used
        assert "b" not in pool and pool.evictions == 1

    def test_pool_full_when_all_referenced(self):
        pool, _ = self._pool(n=3)
        pool.register("a", None)
        pool.register("b", None)
        pool.acquire("a")
        pool.acquire("b")
        with pytest.raises(AdapterPoolFull):
            pool.register("c", None)
        pool.release_ref(1)
        pool.register("c", None)

    def test_null_row_reserved(self):
        pool, _ = self._pool()
        assert pool.capacity == 3 and pool.name_of(0) is None
        with pytest.raises(ValueError):
            AdapterPool(1, 2, writer=lambda *a: None)


class TestMemoryManager:
    def test_ledger_reserve_release(self):
        mm = MemoryManager(budget_bytes=1000, enforce=True)
        mm.reserve("m1", {"weights": 400, "kv_pool": 300})
        assert mm.reserved_bytes == 700 and mm.headroom_bytes() == 300
        mm.release("m1")
        assert mm.reserved_bytes == 0

    def test_overcommit_raises_when_enforcing(self):
        mm = MemoryManager(budget_bytes=1000, enforce=True)
        mm.reserve("m1", {"weights": 800})
        with pytest.raises(HBMOverCommit):
            mm.reserve("m2", {"weights": 300})
        assert mm.reserved_bytes == 800
        mm.reserve("m1", {"weights": 900})  # a re-reservation replaces
        assert mm.reserved_bytes == 900

    def test_non_enforcing_records_overcommit(self):
        mm = MemoryManager(budget_bytes=100, enforce=False)
        mm.reserve("m1", {"weights": 800})
        assert mm.reserved_bytes == 800 and mm.rejections == 1

    def test_second_deployment_rejected_at_build(self, tiny):
        mm = MemoryManager(budget_bytes=800_000, enforce=True)
        first = _model(tiny, n_slots=2, memory=mm, name="dep-a")
        with pytest.raises(HBMOverCommit):
            _model(tiny, n_slots=2, memory=mm, name="dep-b")
        first.release_memory()

    def test_budget_and_enforcement_settings(self, monkeypatch):
        monkeypatch.delenv("SCT_HBM_GB", raising=False)
        assert hbm_budget_bytes("cpu") == 16 << 30
        monkeypatch.setenv("SCT_HBM_GB", "2")
        monkeypatch.setenv("SCT_HBM_ENFORCE", "1")
        mm = MemoryManager()
        assert mm.budget_bytes == 2 << 30 and mm.enforce


def test_program_key_folds_the_lora_geometry(tiny):
    on = _model(tiny, top_k=3, **MLP_KW)
    off = _model(tiny, top_k=3)
    assert on._program_config[-4:-1] == (RANK, 4, ALL)
    assert off._program_config[-4:-1] == (0, 0, ())
    assert on._program_config != off._program_config
    assert off.lora_targets == () and off._lora is None
    with pytest.raises(GraphUnitError, match="lora_targets"):
        _model(tiny, lora_rank=2, lora_targets="q,v")


def test_row_variant_probes_name_the_delta_ops(tiny):
    """The probes take the deltas' batched products: splitting every
    delta op per query position keeps a verify row's bits equal to the
    plain step's."""
    _, _, tcfg, tparams = tiny
    names = set(tl._lora_product_shapes(tcfg, (RANK, ALL)))
    assert names == {f"{t}.lora" for t in ALL}
    found = tl.row_variant_ops(tcfg, 2, 4, lora=(RANK, ALL))
    assert found <= set(tl.ROW_OPS) | names
    assert tl.prefill_variant_ops(tcfg, (16, 32, 64), lora=(RANK, ALL)) <= set(tl.ROW_OPS) | names
    pool = tl.init_lora_params(tcfg, 3, RANK, ALL)
    for row, seed in ((1, 1), (2, 2)):
        fac = tl.lora_adapter_factors(torch.Generator().manual_seed(seed), tcfg, RANK, ALL)
        for t in ALL:
            for key in ("a", "b"):
                pool[t][key][:, row] = fac[t][key]
    cache = tl.init_paged_cache(tcfg, 2, 9, 16)
    aids = torch.tensor([1, 2])
    for s in range(2):
        toks = torch.from_numpy(np.arange(3 + s, 19 + s, dtype=np.int32)[None])
        row = 1 + 4 * s + np.arange(4, dtype=np.int32)
        tl.prefill_slot_paged(tparams, toks, 16, s, row, cache, tcfg, lora=pool,
                              adapter_id=aids[s:s + 1])
    qtok = torch.tensor([[4, 8, 15], [16, 23, 42]], dtype=torch.int32)
    act, qvalid = torch.ones(2, dtype=torch.bool), torch.ones(2, 3, dtype=torch.bool)
    passed = {k: v.clone() for k, v in cache.items()}
    verify, _ = tl.decode_slots_spec_paged(tparams, qtok, passed, act, qvalid, tcfg, window=64,
                                           row_split=frozenset(tl.ROW_OPS) | names, lora=pool,
                                           adapter_ids=aids)
    for j in range(3):
        step, _ = tl.decode_slots_paged(tparams, qtok[:, j].contiguous(), cache, act, tcfg,
                                        window=64, lora=pool, adapter_ids=aids)
        assert torch.equal(verify[:, j], step)


def test_host_syncs_stay_one_per_block_with_adapters_on(tiny):
    block, max_new = 8, 24
    model = _model(tiny, decode_block=block, **LORA_KW)
    outs = _generate(model, [[5 + i, 9, 2] for i in range(3)], ["alpha", "beta", None],
                     max_new=max_new, overlap=True)
    assert all(len(o) == max_new for o in outs)
    assert model.host_syncs == model.decode_blocks <= 3 * max_new // block + 4
    assert model.overlapped >= 1


def test_random_abtest_splits_between_adapters(tiny):
    """A seeded RandomABTest picks which adapter each request decodes
    through; the split lands in the per-adapter token ledger.  The JAX
    test's timeline assertions are left out: the port has no
    observability plane yet."""
    model = _model(tiny, **LORA_KW)
    ab = RandomABTest(ratioA=0.5, seed=1337)
    arms = [["alpha", "beta"][ab.route(np.zeros((1, 1)), [])] for _ in range(24)]
    outs = _generate(model, [[3 + i % 5, 9, 2] for i in range(24)], arms, max_new=5)
    assert all(len(o) == 5 for o in outs)
    snap = model.adapters_snapshot()["adapters"]
    assert arms.count("alpha") > 0 and arms.count("beta") > 0
    assert snap["alpha"]["tokens"] == arms.count("alpha") * 4
    assert snap["beta"]["tokens"] == arms.count("beta") * 4


def test_component_adapter_field_default_and_registry(tiny, monkeypatch):
    from seldon_core_tpu_torch.contract.payload import DataKind, Payload

    _, _, tcfg, tparams = tiny
    comp = GenerativeComponent(_model(tiny, n_slots=2, **LORA_KW), max_new_tokens=6,
                               adapter="alpha")
    base = GenerativeComponent(_model(tiny, n_slots=2), max_new_tokens=6)

    def ask(c, body):
        async def go():
            return json.loads((await c.predict_raw(
                Payload(json.dumps(body), [], DataKind.STRING, None))).data)["tokens"]

        return asyncio.run(go())

    body = {"tokens": [5, 9, 2]}
    assert ask(comp, body) != ask(base, body)  # the deployment default: alpha
    assert ask(comp, {**body, "adapter": None}) == ask(base, body)
    assert ask(comp, {**body, "adapter": "beta"}) != ask(comp, body)
    for c in (comp, base):
        asyncio.run(c.close())
    monkeypatch.setenv("SCT_LORA_RANK", "2")
    monkeypatch.setenv("SCT_LORA_SLOTS", "3")
    monkeypatch.setenv("SCT_LORA_TARGETS", "qkvo+mlp")
    monkeypatch.setenv("SCT_LORA_ADAPTERS", "x,y:4")
    built = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", "adapter": "y"},
                           device="cpu")
    m = built.model
    assert (m.lora_rank, m.lora_slots, m.lora_targets) == (2, 3, ALL)
    assert sorted(m.adapters_snapshot()["adapters"]) == ["x", "y"] and built.adapter == "y"


def _call(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_engine_selects_the_adapter_and_answers_400_for_an_unknown_one(tiny):
    params = [{"name": "preset", "value": "tiny", "type": "STRING"},
              {"name": "n_slots", "value": "2", "type": "INT"},
              {"name": "lora_rank", "value": "2", "type": "INT"},
              {"name": "lora_targets", "value": "qkvo+mlp", "type": "STRING"},
              {"name": "lora_adapters", "value": "alpha,beta", "type": "STRING"},
              {"name": "max_new_tokens", "value": "8", "type": "INT"}]
    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": params}})

    async def go():
        app = EngineApp(PredictionService(spec, device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        try:
            def pred(**extra):
                return _call(app.port, "/api/v0.1/predictions",
                             {"strData": json.dumps({"tokens": [5, 9, 2], **extra})})

            out = {name: await asyncio.to_thread(pred, **kw) for name, kw in (
                ("base", {}), ("alpha", {"adapter": "alpha"}), ("alpha2", {"adapter": "alpha"}),
                ("unknown", {"adapter": "nope"}))}
            out["stream_unknown"] = await asyncio.to_thread(
                _call, app.port, "/api/v0.1/predictions/stream",
                {"tokens": [5, 9, 2], "adapter": "nope"})
            out["generate"] = await asyncio.to_thread(
                _call, app.port, "/disagg/generate", {"tokens": [5, 9, 2], "adapter": "alpha"})
            return out
        finally:
            await app.close()

    out = asyncio.run(go())
    toks = {k: json.loads(json.loads(out[k][1])["strData"])["tokens"]
            for k in ("base", "alpha", "alpha2")}
    assert toks["alpha"] == toks["alpha2"] != toks["base"]
    assert out["unknown"][0] == 400 and b"not resident" in out["unknown"][1]
    assert out["stream_unknown"][0] == 400
    assert out["generate"][0] == 200
    assert json.loads(out["generate"][1])["tokens"] == toks["alpha"]


def test_engine_serves_an_adapter_that_only_the_routed_unit_holds(tiny):
    """A SIMPLE_ROUTER over a LoRA unit (branch 0, which it always routes
    to) and a LoRA-off unit: a request naming the LoRA unit's adapter is
    served by it, not refused for the other unit; an adapter no unit holds,
    and an adapter sent to a graph whose units have no LoRA, are 400."""
    def gen(name, lora):
        params = [{"name": "preset", "value": "tiny", "type": "STRING"},
                  {"name": "n_slots", "value": "2", "type": "INT"},
                  {"name": "max_new_tokens", "value": "6", "type": "INT"}]
        if lora:
            params += [{"name": "lora_rank", "value": "2", "type": "INT"},
                       {"name": "lora_adapters", "value": "alpha", "type": "STRING"}]
        return {"name": name, "type": "MODEL", "implementation": "JAX_GENERATIVE",
                "parameters": params}

    graphs = {"routed": {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
                         "children": [gen("with-lora", True), gen("without", False)]},
              "lora_off": gen("without", False)}

    async def serve(graph):
        app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                          device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        try:
            return [await asyncio.to_thread(
                _call, app.port, "/api/v0.1/predictions",
                {"strData": json.dumps({"tokens": [5, 9, 2], "adapter": ad})})
                for ad in ("alpha", "nope")]
        finally:
            await app.close()

    (alpha, nope), (off, _) = (asyncio.run(serve(graphs[k])) for k in ("routed", "lora_off"))
    assert alpha[0] == 200 and json.loads(alpha[1])["meta"]["routing"]["r"] == 0
    assert len(json.loads(json.loads(alpha[1])["strData"])["tokens"]) == 6
    assert nope[0] == 400 and b"not resident" in nope[1]
    assert off[0] == 400 and b"without multi-LoRA" in off[1]
