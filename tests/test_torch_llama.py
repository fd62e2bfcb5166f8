"""The PyTorch port's llama model and generation engine against the JAX
package, on the CPU.

The same weights (the JAX ``init_params`` pytree, carried over by
``params_from_jax``) and the same seeded numpy inputs go through both
frameworks.  The JAX side runs its Pallas kernels in interpret mode
(``seq_impl="flash"``, ``kernel=True``), the port its plain versions.
Logits agree at 1e-4 in f32; greedy tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.executor.generation import GenerativeModel, OutOfKVBlocks
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import init_params, params_from_jax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = np.array([5, 9, 2, 17, 3], np.int32)


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tl.Config.tiny(max_seq=64))
    return cfg, jparams, tl.Config.tiny(max_seq=64), tparams


def test_config_presets_match_the_jax_package():
    for name in ("tiny", "llama3_1b", "llama3_8b"):
        j, t = getattr(jl.Config, name)(), getattr(tl.Config, name)()
        assert [getattr(j, f) for f in j.__dataclass_fields__] == [
            getattr(t, f) for f in t.__dataclass_fields__
        ]
        assert j.head_dim == t.head_dim


def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tl._rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl._rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **LOGIT_TOL,
    )
    np.testing.assert_allclose(
        tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), **LOGIT_TOL,
    )


@pytest.fixture(scope="module")
def prefilled(tiny):
    """One 16-token prompt prefilled into slot 0 by both frameworks."""
    cfg, jparams, tcfg, tparams = tiny
    toks = np.arange(1, 17, dtype=np.int32)[None]
    row = np.zeros(4, np.int32)
    row[:4] = np.arange(1, 5)
    jcache = jl.init_paged_cache(cfg, 2, 9, 16)
    jlog, jcache = jl.prefill_slot_paged(
        jparams, jnp.asarray(toks), jnp.int32(16), jnp.int32(0), jnp.asarray(row), jcache,
        cfg, seq_impl="flash",
    )
    tcache = tl.init_paged_cache(tcfg, 2, 9, 16)
    tlog, tcache = tl.prefill_slot_paged(tparams, torch.from_numpy(toks), 16, 0, row, tcache, tcfg)
    return jlog, jcache, tlog, tcache


def test_prefill_slot_paged_logits_and_pool_match(prefilled):
    jlog, jcache, tlog, tcache = prefilled
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **LOGIT_TOL)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    assert tcache["table"].tolist() == np.asarray(jcache["table"]).tolist()


def test_one_decode_step_matches(tiny, prefilled):
    cfg, jparams, tcfg, tparams = tiny
    jlog, jcache, tlog, tcache = prefilled
    tcache = {k: v.clone() for k, v in tcache.items()}  # the port updates in place
    tok = np.array([int(np.argmax(np.asarray(jlog))), 0], np.int32)
    act = np.array([True, False])
    jd, jcache = jl.decode_slots_paged(
        jparams, jnp.asarray(tok), dict(jcache), jnp.asarray(act), cfg, window=64, kernel=True
    )
    td, tcache = tl.decode_slots_paged(
        tparams, torch.from_numpy(tok), tcache, torch.from_numpy(act), tcfg, window=64
    )
    np.testing.assert_allclose(td.numpy()[0], np.asarray(jd)[0], **LOGIT_TOL)
    assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    # the inactive slot's write went to the sink block 0, as in JAX
    np.testing.assert_allclose(tcache["k"].numpy()[:, 0], np.asarray(jcache["k"])[:, 0],
                               **LOGIT_TOL)


def test_dense_forward_matches(tiny):
    cfg, jparams, tcfg, tparams = tiny
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jl.forward(jparams, jnp.asarray(toks), cfg, seq_impl="dense")
    for impl in ("dense", "flash"):
        got = tl.forward(tparams, torch.from_numpy(toks), tcfg, seq_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    with pytest.raises(ValueError, match="seq_impl"):
        tl.forward(tparams, torch.from_numpy(toks), tcfg, seq_impl="ring")


def test_greedy_generation_equals_jax_generative_model(tiny):
    """admit + step_k greedy tokens of the port equal those of the JAX
    GenerativeModel(seq_impl="flash", decode_kernel=True), two slots."""
    cfg, jparams, tcfg, tparams = tiny
    prompts = [PROMPT, np.arange(20, 43, dtype=np.int32)]
    S, k = 2, 6
    jm = JaxGenerativeModel(cfg, jparams, n_slots=S, seq_impl="flash", decode_block=k,
                            decode_kernel=True)
    tm = GenerativeModel(tcfg, tparams, n_slots=S, seq_impl="flash", decode_block=k,
                         device="cpu")
    streams = []
    for m in (jm, tm):
        first = np.array([m.admit(i, p, 0.0, 0, reserve_tokens=k + 1) for i, p in enumerate(prompts)],
                         np.int32)
        toks, act = m.step_k(first, np.ones(S, bool), np.zeros(S, np.float32), 0,
                             np.full(S, -1, np.int32), np.full(S, k, np.int32), k)
        assert act.all()
        streams.append(np.concatenate([first[None], toks]).T.tolist())
    assert streams[0] == streams[1]
    assert tm.decode_blocks == tm.host_syncs == 1


def test_step_k_stops_a_slot_at_eos_and_budget_on_device(tiny):
    _, _, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, device="cpu")
    first = np.array([m.admit(i, PROMPT + i, 0.0, 0, 8) for i in range(2)], np.int32)
    ref, _ = m.step_k(first, np.ones(2, bool), np.zeros(2, np.float32), 0,
                      np.full(2, -1, np.int32), np.full(2, 8, np.int32), 4)
    m.reset()
    first = np.array([m.admit(i, PROMPT + i, 0.0, 0, 8) for i in range(2)], np.int32)
    # slot 0 stops at the first token of the block not seen before it
    j = next(i for i in range(1, 4) if ref[i, 0] not in ref[:i, 0] and ref[i, 0] != first[0])
    eos = np.array([ref[j, 0], -1], np.int32)
    toks, act = m.step_k(first, np.ones(2, bool), np.zeros(2, np.float32), 0, eos,
                         np.array([8, 3], np.int32), 4)
    assert act[:, 0].tolist() == [i <= j for i in range(4)]
    assert act[:, 1].tolist() == [True, True, True, False]  # budget of 3
    assert toks[:2, 0].tolist() == ref[:2, 0].tolist()
    assert m.host_syncs == m.decode_blocks == 2


def test_kv_block_allocator(tiny):
    _, _, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, kv_block_size=16, kv_blocks=6, device="cpu")
    assert m.prefill_buckets == (16, 32, 64)
    assert all(b % m.kv_block_size == 0 for b in m.prefill_buckets)
    row = m.reserve_blocks(0, 40)  # 3 blocks
    assert 0 not in row[:3] and row[3:].tolist() == [0]
    with pytest.raises(OutOfKVBlocks):
        m.reserve_blocks(1, 33)  # 3 more blocks, 2 free
    m.release_slot(0)
    assert m.free_block_count == 5
    assert m._window_for(np.array([True, False]), 16) == 64


def test_warmup_runs_every_bucket_and_resets(tiny):
    cfg, jparams, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=2, device="cpu")
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2)
    assert m._window_buckets() == jm._window_buckets()
    assert m.warmup() == len(m.prefill_buckets) + len(m._window_buckets())
    assert m._cache["pos"].tolist() == [0, 0]
    assert m.free_block_count == m.kv_blocks - 1
    assert m.prefills == m.steps == m.host_syncs == 0
    assert m.admit(0, PROMPT, 0.0, 0) >= 0 and m.warmup() == 0  # traffic came first


def test_model_rules(tiny):
    _, _, tcfg, tparams = tiny
    with pytest.raises(GraphUnitError, match="seq_impl"):
        GenerativeModel(tcfg, tparams, seq_impl="ring", device="cpu")
    with pytest.raises(GraphUnitError, match="kv_blocks"):
        GenerativeModel(tcfg, tparams, kv_blocks=3, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tl.Llama(tcfg, {**{k: v.data for k, v in _named(tparams).items()},
                        "ln_f": torch.ones(3)})


def _named(params):
    return {"tok_emb": params.tok_emb, "ln_f": params.ln_f, "head": params.head,
            **{f"layers/{k}": v for k, v in params.layers.items()}}


def test_seeded_init_is_reproducible():
    cfg = tl.Config.tiny(max_seq=32)
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    for (name, x), y in zip(_named(a).items(), _named(b).values()):
        assert torch.equal(x, y), name
    assert float(a.layers["ln_att"].min()) == 1.0


def test_row_tiled_prefill_ops_run_fixed_tiles_and_match_the_jax_prefill(tiny):
    """``row_tiled_op`` runs the named ops in calls of exactly ``tile`` rows
    (the last zero-padded, its rows dropped) and the others in one call;
    a prefill through it still matches the JAX prefill's logits."""
    cfg, jparams, tcfg, tparams = tiny
    rows = []

    def fn(t):
        rows.append(t.shape[1])
        return t * 2.0

    op = tl.row_tiled_op(frozenset({"w_down", "norm"}), 8)
    t = torch.arange(1 * 21 * 3, dtype=torch.float32).reshape(1, 21, 3)
    assert torch.equal(op("w_down", fn, t), t * 2.0) and rows == [8, 8, 8]
    rows.clear()
    assert torch.equal(op("wq", fn, t), t * 2.0) and rows == [21]
    want = np.asarray(jl.forward(jparams, jnp.asarray(PROMPT[None]), cfg))[0, -1]
    cache = tl.init_paged_cache(tcfg, 1, 9, 16)
    padded = torch.zeros(1, 16, dtype=torch.int32)
    padded[0, :PROMPT.size] = torch.from_numpy(PROMPT)
    split = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "norm"})
    got, _ = tl.prefill_slot_paged(tparams, padded, PROMPT.size, 0, np.arange(1, 5), cache, tcfg,
                                   op=tl.row_tiled_op(split, 4))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
