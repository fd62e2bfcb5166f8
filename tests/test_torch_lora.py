"""The port's batched multi-LoRA serving and memory ledger on the CPU,
against the JAX package and inside the port.

The same weights (the JAX ``init_params`` pytree at ``Config.tiny``, f32,
carried over by ``params_from_jax``) and the same adapters (JAX-drawn
``lora_adapter_factors``, carried over by ``lora_from_jax``) go through
both frameworks: the delta of every target, teacher-forced prefill, decode
and verify logits agree at 1e-4; greedy streams of a mixed-adapter batch
equal the JAX scheduler's; handoff frames naming an adapter are
byte-equal, and salted prefix-chain hashes equal the JAX index's; the
memory ledger answers as the JAX package's does.  What is checked inside
the port alone is in ``tests/test_torch_lora_serving.py``.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.cache.prefix import PrefixIndex as JaxPrefixIndex
from seldon_core_tpu.disagg import handoff as jh
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.cache.prefix import PrefixIndex, adapter_salt
from seldon_core_tpu_torch.disagg import handoff as th
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.executor.memory import MemoryManager
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import lora_from_jax, params_from_jax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
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


@pytest.fixture(scope="module")
def factors(tiny):
    """Two adapters' JAX-drawn factors over every target, as numpy."""
    cfg = tiny[0]
    return {name: jax.tree.map(np.asarray, jl.lora_adapter_factors(
        jax.random.PRNGKey(seed), cfg, RANK, targets=ALL)) for name, seed in
        (("alpha", 7), ("beta", 8))}


def _sub(fac, targets):
    return {t: fac[t] for t in targets}


def _pools(cfg, tcfg, factors, targets):
    """The same stacked pool in both frameworks: row 0 null, rows 1 and 2
    alpha and beta."""
    jpool = jl.init_lora_params(cfg, 3, RANK, targets=targets)
    for row, name in ((1, "alpha"), (2, "beta")):
        for t in targets:
            for key in ("a", "b"):
                jpool[t][key] = jpool[t][key].at[:, row].set(factors[name][t][key])
    return jpool, lora_from_jax(jax.tree.map(np.asarray, jpool))


def _model(tiny, **kw):
    _, _, tcfg, tparams = tiny
    kw.setdefault("n_slots", 4)
    kw.setdefault("decode_block", 4)
    return GenerativeModel(tcfg, tparams, device="cpu", **kw)


def _generate(model, prompts=PROMPTS, adapters=None, *, sched_cls=GenerationScheduler,
              seed=123, max_new=9, overlap=None, **kw):
    sched = (sched_cls(model) if overlap is None else sched_cls(model, overlap=overlap))
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


# ------------------------------------------------------ against JAX


@pytest.mark.parametrize("target", ALL)
def test_lora_delta_matches_jax(tiny, factors, target):
    """One target's delta over a mixed batch (rows on adapters 0, 1, 2, 1)
    and the base projection plus it, through the port's layer helpers."""
    cfg, jparams, tcfg, tparams = tiny
    jpool, tpool = _pools(cfg, tcfg, factors, (target,))
    shapes = tl._lora_shapes(tcfg, RANK)[target]
    rng = np.random.default_rng(3)
    in_shape = shapes[0][:-1]
    h = rng.standard_normal((4, 3) + in_shape).astype(np.float32)
    aid = np.array([0, 1, 2, 1], np.int32)
    la = {k: v[1] for k, v in jpool[target].items()}  # layer 1
    want = np.asarray(jl._lora_delta(jnp.asarray(h), la, jnp.asarray(aid)))
    tla = tl._lora_layer(tpool, 1)[target]
    got = tl._lora_delta(torch.from_numpy(h), tla, torch.from_numpy(aid).long())
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert not np.any(want[0])  # the null row's delta is exactly zero
    lp = tparams.layer(1)
    base = {"wq": lambda t: tl._proj_heads(t, lp["wq"]), "wk": lambda t: tl._proj_heads(t, lp["wk"]),
            "wv": lambda t: tl._proj_heads(t, lp["wv"]), "wo": lambda t: tl._out_proj(t, lp["wo"]),
            }.get(target, lambda t: t @ lp[target])
    x = torch.from_numpy(h)
    plus = tl._with_lora(tl._plain, target, base(x), x, tl._lora_layer(tpool, 1),
                         torch.from_numpy(aid).long())
    np.testing.assert_allclose((plus - base(x)).numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("targets", [tl.LORA_ATTN_TARGETS, ALL], ids=["qkvo", "qkvo+mlp"])
def test_adapter_bound_prefill_decode_and_verify_logits_match_jax(tiny, factors, targets):
    """Two slots prefilled through adapters 1 and 2, then three
    teacher-forced decode steps and one verify pass (L = 3) on the mixed
    batch: logits at 1e-4 of the JAX package's, and different from the
    base model's."""
    cfg, jparams, tcfg, tparams = tiny
    jpool, tpool = _pools(cfg, tcfg, factors, targets)
    rng = np.random.default_rng(5)
    jcache = jl.init_paged_cache(cfg, 2, 9, 16)
    tcache = tl.init_paged_cache(tcfg, 2, 9, 16)
    aids = np.array([1, 2], np.int32)
    for s, n in enumerate((13, 21)):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        row = np.zeros(4, np.int32)
        row[:4] = 1 + 4 * s + np.arange(4)
        jlog, jcache = jl.prefill_slot_paged(
            jparams, jnp.asarray(toks), jnp.int32(n), jnp.int32(s), jnp.asarray(row), jcache,
            cfg, lora=jpool, adapter_id=jnp.int32(aids[s]))
        tlog, _ = tl.prefill_slot_paged(tparams, torch.from_numpy(toks), n, s, row, tcache, tcfg,
                                        lora=tpool, adapter_id=torch.tensor([int(aids[s])]))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        base, _ = tl.prefill_slot_paged(tparams, torch.from_numpy(toks), n, s, row,
                                        tl.init_paged_cache(tcfg, 2, 9, 16), tcfg)
        assert not torch.allclose(base, tlog, **LOGIT_TOL)
    act = np.array([True, True])
    verify_at = {k: v.clone() for k, v in tcache.items()}
    jverify_at = dict(jcache)
    qtok = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    for j in range(3):
        tok = qtok[:, j].copy()
        jd, jcache = jl.decode_slots_paged(jparams, jnp.asarray(tok), dict(jcache),
                                           jnp.asarray(act), cfg, window=64, lora=jpool,
                                           adapter_ids=jnp.asarray(aids))
        td, _ = tl.decode_slots_paged(tparams, torch.from_numpy(tok), tcache,
                                      torch.from_numpy(act), tcfg, window=64, lora=tpool,
                                      adapter_ids=torch.from_numpy(aids))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LOGIT_TOL)
    qvalid = np.ones((2, 3), bool)
    jv, _ = jl.decode_slots_spec_paged(jparams, jnp.asarray(qtok), jverify_at, jnp.asarray(act),
                                       jnp.asarray(qvalid), cfg, window=64, lora=jpool,
                                       adapter_ids=jnp.asarray(aids))
    tv, _ = tl.decode_slots_spec_paged(tparams, torch.from_numpy(qtok), verify_at,
                                       torch.from_numpy(act), torch.from_numpy(qvalid), tcfg,
                                       window=64, lora=tpool, adapter_ids=torch.from_numpy(aids))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOGIT_TOL)


def test_mixed_batch_greedy_streams_equal_the_jax_scheduler(tiny, factors):
    cfg, jparams, tcfg, tparams = tiny
    adapters = ["alpha", None, "beta", "alpha"]
    jm = JaxGenerativeModel(cfg, jparams, n_slots=4, decode_block=4, lora_rank=RANK,
                            lora_slots=4, lora_targets="qkvo+mlp")
    tm = _model(tiny, lora_rank=RANK, lora_slots=4, lora_targets="qkvo+mlp")
    for name in ("alpha", "beta"):
        jm.register_adapter(name, factors=factors[name])
        tm.register_adapter(name, factors=lora_from_jax(factors[name]))
    want = _generate(jm, adapters=adapters, sched_cls=JaxScheduler)
    got = _generate(tm, adapters=adapters)
    assert got == want
    assert tm.host_syncs == tm.decode_blocks > 0
    assert tm.free_block_count == tm.kv_blocks - 1


def test_salted_chain_hashes_equal_the_jax_index():
    tokens = np.arange(1, 13, dtype=np.int32)
    port, ref = PrefixIndex(4), JaxPrefixIndex(4)
    for idx in (port, ref):
        idx.insert(tokens, [10, 11, 12], 0, salt=adapter_salt("billing"))
        idx.insert(tokens, [20, 21], 0)
    assert sorted(port.digest()["hashes"]) == sorted(ref.digest()["hashes"])
    assert port.match(tokens, 3, salt=adapter_salt("billing")) == [10, 11, 12]
    assert port.match(tokens, 3, salt=adapter_salt("other")) == []
    assert port.match(tokens, 3) == [20, 21]
    assert adapter_salt(None) == adapter_salt("") == b"" and adapter_salt("x") == b"x\x00"


def test_v4_frames_byte_equal_to_jax_and_refused_by_name(tiny):
    rng = np.random.default_rng(2)
    k, v = (rng.standard_normal((2, 1, 16, 2, 16)).astype(np.float32) for _ in range(2))
    prompt = np.arange(9, dtype=np.int32)
    kw = dict(block_size=16, max_new_tokens=5, adapter="alpha")
    port = th.encode_handoff(prompt, 3, torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert port == jh.encode_handoff(prompt, 3, k, v, **kw)
    chain = th.encode_prefix_chain(np.arange(16), torch.from_numpy(k), torch.from_numpy(v),
                                   block_size=16, adapter="alpha")
    assert chain == jh.encode_prefix_chain(np.arange(16), k, v, block_size=16, adapter="alpha")
    assert th.decode_prefix_chain(chain)["adapter"] == "alpha"
    payload = th.decode_handoff(port)
    assert payload["adapter"] == "alpha"
    th.check_pool(_model(tiny, **LORA_KW), payload)  # resident: accepted
    for other in (_model(tiny, lora_rank=RANK, lora_slots=4, lora_adapters="other"),
                  _model(tiny)):
        with pytest.raises(th.HandoffError, match="adapter 'alpha' but it is not resident"):
            th.check_pool(other, payload)


def test_adapter_handoff_frame_crosses_to_jax(tiny, factors):
    """A port prefill through ``alpha`` framed with its adapter imports
    into the JAX package, whose decode through its ``alpha`` gives the
    JAX unified engine's tokens."""
    cfg, jparams, tcfg, tparams = tiny
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4, lora_rank=RANK, lora_slots=4)
    tm = _model(tiny, n_slots=2, lora_rank=RANK, lora_slots=4)
    jm.register_adapter("alpha", factors=_sub(factors["alpha"], tl.LORA_ATTN_TARGETS))
    tm.register_adapter("alpha", factors=lora_from_jax(_sub(factors["alpha"],
                                                            tl.LORA_ATTN_TARGETS)))
    prompt = np.asarray(PROMPTS[0], np.int32)
    want = _generate(jm, [prompt], ["alpha"], sched_cls=JaxScheduler)[0]
    tok = tm.admit(0, prompt, 0.0, 0, reserve_tokens=9, adapter="alpha")
    frame = th.build_handoff_frame(tm, 0, prompt, tok, max_new_tokens=9)
    tm.release_slot(0)
    p = jh.decode_handoff(frame)
    assert p["adapter"] == "alpha"

    async def go():
        sched = JaxScheduler(jm)
        try:
            return await sched.submit_imported(p["prompt"], first_token=int(p["first_token"]),
                                               k=p["k"], v=p["v"], max_new_tokens=9,
                                               adapter=p["adapter"])
        finally:
            await sched.close()

    assert asyncio.run(go()).tolist() == want


def test_memory_ledger_matches_the_jax_ledger(tiny):
    """The same reservations give the same snapshots; a model reserves
    every class, ``adapter_pool`` being ``lora_pool_bytes`` exactly."""
    from seldon_core_tpu.executor.memory import MemoryManager as JaxMemoryManager

    port, ref = MemoryManager(1000, enforce=False), JaxMemoryManager(1000, enforce=False)
    for mm in (port, ref):
        mm.reserve("m1", {"weights": 400, "kv_pool": 300})
        mm.reserve("m2", {"weights": 800})
        mm.release("m1")
    assert port.snapshot() == ref.snapshot()
    _, _, tcfg, _ = tiny
    mm = MemoryManager(budget_bytes=1 << 30, enforce=True)
    model = _model(tiny, n_slots=2, memory=mm, kv_cache_dtype="int8", **MLP_KW)
    by_class = mm.snapshot()["by_class"]
    assert by_class["adapter_pool"] == model.lora_bytes == tl.lora_pool_bytes(
        tcfg, 4, RANK, ALL, torch.float32) > 0
    assert by_class["weights"] == model.param_bytes
    assert by_class["kv_pool"] > 0 and by_class["kv_scales"] > 0
    snap = model.spec_snapshot()
    assert snap["lora_rank"] == RANK and snap["adapters"]["resident"] == 2
    assert snap["pool"]["bytes"]["adapter_pool"] == model.lora_bytes
    assert snap["pool"]["hbm"]["reserved_bytes"] == mm.reserved_bytes
    assert _model(tiny, n_slots=2).spec_snapshot()["adapters"] is None
    model.release_memory()
    assert mm.reserved_bytes == 0
