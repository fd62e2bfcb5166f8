"""The port's prefix tiers on the CPU: the host-DRAM store under the radix
index and the peer tier's prefix-chain frames.

* ``HostPrefixStore``: the JAX package's store cases run as one
  parametrised test over both implementations (byte bound, chain-cost
  eviction, a shallow entry never displacing a deep chain, extensions
  doomed with their root, counters, salted chains, the digest);
* prefix-chain frames: the port's and the JAX package's encoders give the
  same bytes for the same chain (f32, bf16, int8 with scales), each
  decodes the other's, and torn, version-skewed, wrongly keyed and
  inconsistent frames are refused;
* inside the port, bit for bit (``seq_impl="dense"``, ``Config.tiny``):
  a generation whose prefix was demoted to DRAM and promoted back equals
  the pressure-free run (greedy, seeded top-k, int8 KV); an exported and
  installed chain, a demoted extension included, gives the exporter's
  tokens and is credited to the peer tier; demotion and promotion add no
  device-to-host fetch inside a decode block; ``prefix_dram_gb`` is a
  served graph parameter.
"""

import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_chunked import _FetchCounter

from seldon_core_tpu.cache.tiers import HostPrefixStore as JaxStore
from seldon_core_tpu.disagg import handoff as jh
from seldon_core_tpu.executor.multihost import encode_step as jax_encode_step
from seldon_core_tpu_torch.cache.prefix import adapter_salt, chain_hash
from seldon_core_tpu_torch.cache.tiers import HostPrefixStore as PortStore
from seldon_core_tpu_torch.disagg import handoff as th
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import Implementation
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import init_params

PREFIX = list(range(7, 39))  # 2 full 16-token blocks
BULK = list(range(60, 179))  # 119 tokens: an 8-block reservation with 8 new tokens
PRESSURE = [PREFIX + [40, 41, 42], BULK, PREFIX + [50, 51, 52]]


# ------------------------------------------------------- the DRAM store


def _entry(depth: int, nbytes: int = 200) -> dict:
    half = nbytes // 2
    return dict(depth=depth, k=np.zeros(half, np.int8), v=np.zeros(nbytes - half, np.int8))


A = np.arange(32, dtype=np.int32)
B = np.arange(100, 132, dtype=np.int32)


def _key(store, tokens, k, salt=b""):
    return store.level_key(tokens, k, 4, salt)


def _byte_bound(Store):
    store = Store(4, budget_bytes=500)
    assert not store.put(_key(Store, A, 1), **_entry(1, nbytes=501))
    assert store.rejected == 1 and len(store) == 0 and store.bytes == 0
    assert store.put(_key(Store, A, 1), **_entry(1))
    assert store.bytes == 200 and store.demotions == 1


def _cost_order(Store):
    store = Store(4, budget_bytes=800)
    for lvl in (1, 2, 3):
        assert store.put(_key(Store, A, lvl), **_entry(lvl))
    assert store.put(_key(Store, B, 1), **_entry(1))
    C = np.arange(200, 232, dtype=np.int32)
    assert store.put(_key(Store, C, 1), **_entry(1))  # evicts B's 1-deep chain only
    assert store.evictions == 1
    assert store.peek_depth(B, 1, 1) == 0 and store.peek_depth(A, 1, 3) == 3


def _shallow_never_displaces_deep(Store):
    store = Store(4, budget_bytes=600)
    for lvl in (1, 2, 3):
        assert store.put(_key(Store, A, lvl), **_entry(lvl))
    D = np.arange(300, 332, dtype=np.int32)
    assert not store.put(_key(Store, D, 1), **_entry(1))
    assert store.rejected == 1 and store.peek_depth(A, 1, 3) == 3
    assert store.put(_key(Store, D, 4), **_entry(4))  # a deeper one may
    assert store.peek_depth(A, 1, 3) == 2


def _dooms_extensions(Store):
    store = Store(4, budget_bytes=600)
    for lvl in (1, 2, 3):
        assert store.put(_key(Store, A, lvl), **_entry(lvl))
    assert store.put(_key(Store, B, 10), **_entry(10, nbytes=600))
    assert store.evictions == 3 and len(store) == 1 and store.peek_depth(A, 1, 3) == 0


def _match_drop_peek(Store):
    store = Store(4, budget_bytes=10_000)
    for lvl in (1, 2):
        store.put(_key(Store, A, lvl), **_entry(lvl))
    assert store.peek_depth(A, 1, 4) == 2 and store.hits == store.misses == 0
    got = store.match(A, 1, 4)
    assert [depth for _k, depth, *_ in got] == [1, 2] and store.hits == 1
    assert store.match(B, 1, 4) == [] and store.misses == 1
    store.drop([k for k, *_ in got])
    assert store.promotions == 2 and store.bytes == 0 and len(store) == 0
    snap = store.snapshot()
    assert snap["promotions"] == 2 and snap["demotions"] == 2


def _salted(Store):
    store = Store(4, budget_bytes=10_000)
    salt = adapter_salt("alpha")
    store.put(_key(Store, A, 1, salt), **_entry(1))
    assert store.peek_depth(A, 1, 1) == 0 and store.match(A, 1, 1) == []
    assert store.peek_depth(A, 1, 1, salt) == 1


def _digest(Store):
    store = Store(4, budget_bytes=10_000)
    for lvl in (1, 2):
        store.put(_key(Store, A, lvl), **_entry(lvl))
    digest = store.digest()
    key = _key(Store, A, 2)
    assert digest["block_size"] == 4 and digest["entries"] == 2
    assert chain_hash(key[0] + key[1]) in digest["hashes"] and digest["depths"] == [2, 1]


STORE_CASES = {f.__name__.strip("_"): f for f in (
    _byte_bound, _cost_order, _shallow_never_displaces_deep, _dooms_extensions,
    _match_drop_peek, _salted, _digest)}


@pytest.mark.parametrize("Store", [JaxStore, PortStore], ids=["jax", "port"])
@pytest.mark.parametrize("case", list(STORE_CASES), ids=list(STORE_CASES))
def test_host_prefix_store_cases_in_both_implementations(Store, case):
    STORE_CASES[case](Store)


def test_store_keys_and_digest_equal_across_frameworks():
    stores = [JaxStore(4, 10_000), PortStore(4, 10_000)]
    for store in stores:
        for lvl in (1, 2, 3):
            store.put(store.level_key(A, lvl, 4, b""), **_entry(lvl))
    assert stores[0].digest() == stores[1].digest()
    assert stores[0].snapshot() == stores[1].snapshot()


# -------------------------------------------------- prefix-chain frames


def _chain(kind: str, depth: int = 2):
    """(port k, v, ks, vs as torch; the JAX package's as numpy)."""
    rng = np.random.default_rng(4)
    shape = (2, depth, 16, 2, 16)
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.random(shape[:4]).astype(np.float32) for _ in range(2))
        return ([torch.from_numpy(a) for a in (k, v, ks, vs)], [k, v, ks, vs])
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "bfloat16":
        port = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        jax_side = [t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for t in port]
        return port + [None, None], jax_side + [None, None]
    return [torch.from_numpy(k), torch.from_numpy(v), None, None], [k, v, None, None]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_prefix_chain_frames_equal_and_cross_decode(kind):
    tokens = np.arange(40, dtype=np.int32)
    (pk, pv, pks, pvs), (jk, jv, jks, jvs) = _chain(kind)
    port = th.encode_prefix_chain(tokens, pk, pv, block_size=16, k_scale=pks, v_scale=pvs)
    ref = jh.encode_prefix_chain(tokens, jk, jv, block_size=16, k_scale=jks, v_scale=jvs)
    assert port == ref
    got = th.decode_prefix_chain(ref)
    assert got["depth"] == 2 and got["tokens"].tolist() == tokens[:32].tolist()
    for name, want in (("k", pk), ("v", pv), ("k_scale", pks), ("v_scale", pvs)):
        if want is not None:
            assert got[name].dtype == want.dtype and torch.equal(got[name], want)
    back = jh.decode_prefix_chain(port)
    assert np.asarray(back["k"]).tobytes() == np.asarray(jk).tobytes()


def test_prefix_chain_frames_refused_when_torn_skewed_or_inconsistent():
    tokens = np.arange(32, dtype=np.int32)
    (k, v, _, _), _ = _chain("float32")
    frame = th.encode_prefix_chain(tokens, k, v, block_size=16)
    for torn in (frame[:-7], frame[:5], b"XXXX" + frame[4:]):
        with pytest.raises(ValueError):
            th.decode_prefix_chain(torn)
        with pytest.raises(ValueError):
            jh.decode_prefix_chain(torn)
    payload = {"tokens": tokens, "depth": 2, "block_size": 16, "kv_dtype": "float32",
               "pv": th.PREFIX_VERSION + 1, "k": k.numpy(), "v": v.numpy()}
    with pytest.raises(th.HandoffError, match="newer"):
        th.decode_prefix_chain(jax_encode_step(th.PREFIX_KEY, payload))
    with pytest.raises(th.HandoffError, match="not a prefix chain"):
        th.decode_prefix_chain(jax_encode_step(th.HANDOFF_KEY, {**payload, "pv": 1}))
    with pytest.raises(th.HandoffError, match="cover"):
        th.decode_prefix_chain(jax_encode_step(th.PREFIX_KEY, {
            **payload, "pv": 1, "tokens": tokens[:20]}))


# --------------------------------------------- promotion, export, install


@pytest.fixture(scope="module")
def tparams():
    cfg = tl.Config.tiny(max_seq=128)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _model(tparams, reuse=True, dram_gb=0.001, kv_blocks=None, **kw):
    cfg, params = tparams
    return GenerativeModel(cfg, params, n_slots=2, kv_block_size=16, kv_blocks=kv_blocks,
                           prefix_reuse=reuse, prefix_dram_gb=dram_gb if reuse else None,
                           seq_impl="dense", device="cpu", **kw)


def _generate(model, prompts, max_new=8, temperature=0.0, seed=None):
    """The prompts one after another through one scheduler."""

    async def go():
        sched = GenerationScheduler(model)
        if seed is not None:
            sched._seed = seed
        try:
            return [(await sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                                        temperature=temperature)).tolist() for p in prompts]
        finally:
            await sched.close()

    return asyncio.run(go())


def _assert_round_trip(model):
    snap = model.prefix_snapshot()
    dram = snap["tiers"]["dram"]
    assert dram["demotions"] >= 1 and dram["promotions"] >= 1 and model.dram_hits >= 1
    assert dram["bytes"] == model.host_store.bytes
    # every block is free or in the index once the slots are released
    assert snap["free_blocks"] + snap["entries"] == snap["pool_blocks"]


@pytest.mark.parametrize("kw,sampling", [
    ({}, {}), ({"top_k": 4}, {"temperature": 0.8, "seed": 1234}),
    ({"kv_cache_dtype": "int8"}, {}),
], ids=["greedy", "seeded-topk", "int8"])
def test_promoted_generation_bit_identical_to_pressure_free(tparams, kw, sampling):
    base = _generate(_model(tparams, reuse=False, **kw), PRESSURE, **sampling)
    model = _model(tparams, kv_blocks=10, **kw)  # the bulk prompt evicts the prefix
    assert _generate(model, PRESSURE, **sampling) == base
    _assert_round_trip(model)


def test_export_and_install_of_a_chain_bit_identical(tparams):
    prompt = PREFIX + [40, 41, 42]
    base = _generate(_model(tparams, reuse=False), [prompt])
    a = _model(tparams)
    _generate(a, [prompt])
    depth, k, v, ks, vs = a.export_prefix_kv(np.asarray(prompt, np.int32))
    assert depth == 2 and ks is None and a.peer_serves == 1
    # through the wire format, as a peer pull carries it
    frame = th.decode_prefix_chain(th.encode_prefix_chain(
        np.asarray(prompt, np.int32), k, v, block_size=16))
    b = _model(tparams)
    free = b.free_block_count
    assert b.install_prefix_chain(frame["tokens"], frame["k"], frame["v"]) == 2
    assert b.free_block_count == free - 2
    assert b.install_prefix_chain(frame["tokens"], frame["k"], frame["v"]) == 0  # resident
    assert _generate(b, [prompt]) == base
    snap = b.prefix_snapshot()
    assert b.peer_hits == 1 and snap["tiers"]["peer"]["hits"] == 1
    assert snap["tiers"]["peer"]["promotions"] == 2
    with pytest.raises(GraphUnitError, match="skew"):
        b.install_prefix_chain(frame["tokens"], frame["k"][:, :, :8], frame["v"][:, :, :8])


def test_export_includes_a_demoted_extension(tparams):
    """The DRAM levels that extend the index's chain leave in the same
    frame, and installing it elsewhere gives the pressure-free tokens."""
    model = _model(tparams, kv_blocks=10)
    _generate(model, PRESSURE[:2])  # warm, then the bulk prompt demotes the chain
    assert model.host_store.demotions >= 1 and model.prefix_index.peek_depth(
        np.asarray(PREFIX, np.int32), 2) == 0
    depth, k, v, _, _ = model.export_prefix_kv(np.asarray(PREFIX + [40, 41], np.int32))
    assert depth == 2 and k.shape[1] == 2
    other = _model(tparams)
    assert other.install_prefix_chain(np.asarray(PREFIX, np.int32), k, v) == 2
    base = _generate(_model(tparams, reuse=False), [PRESSURE[2]])
    assert _generate(other, [PRESSURE[2]]) == base and other.peer_hits == 1


def test_tiers_add_no_fetch_inside_a_decode_block(tparams, monkeypatch):
    """Demotion is one device-to-host fetch at an admission sync point and
    promotion none: every other fetch is a decode block's or a sync
    point's first token."""
    model = _model(tparams, kv_blocks=10, decode_block=4)
    demotion_fetches = []
    fetch = model._fetch_blocks
    model._fetch_blocks = lambda phys: demotion_fetches.append(len(phys)) or fetch(phys)
    fetches = _FetchCounter(monkeypatch)
    outs = _generate(model, PRESSURE, max_new=12)
    assert [len(o) for o in outs] == [12, 9, 12]  # the bulk prompt's budget ends at max_seq
    _assert_round_trip(model)
    assert model.host_syncs == model.decode_blocks > 0 and demotion_fetches
    assert fetches.count == model.host_syncs + len(PRESSURE) + len(demotion_fetches)


def test_prefix_dram_gb_is_served(monkeypatch):
    comp = create_builtin(Implementation.JAX_GENERATIVE,
                          {"preset": "tiny", "kv_prefix_reuse": True, "prefix_dram_gb": 0.5},
                          device="cpu")
    assert comp.model.host_store.budget_bytes == 1 << 29
    assert "dram" in comp.model.prefix_snapshot()["tiers"]
    monkeypatch.setenv("SCT_PREFIX_DRAM_GB", "0.25")
    env = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", "kv_prefix_reuse": True},
                         device="cpu")
    assert env.model.host_store.budget_bytes == 1 << 28
    off = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny"}, device="cpu")
    assert off.model.host_store is None  # no index, no tier
    with pytest.raises(GraphUnitError, match="kv_prefix_reuse"):
        create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", "prefix_dram_gb": 1.0},
                       device="cpu")
