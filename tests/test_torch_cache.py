"""The PyTorch port's int8 paged KV and KV prefix reuse against the JAX
package, on the CPU.

The same weights (the JAX ``init_params`` pytree, carried over by
``params_from_jax``) and the same seeded numpy inputs go through both
frameworks at ``Config.tiny`` (``max_seq=128``), 16-row blocks, f32:

* ``_quant_kv``/``_dequant_kv`` give the same int8 bytes and scales, in
  f32 and bf16, exact half-way ties and all-zero rows included;
* ``init_paged_cache(kv_dtype="int8")`` and ``paged_kv_slot_bytes`` agree;
* int8 ``prefill_slot_paged`` and ``decode_slots_paged``, and
  ``prefill_suffix_paged`` over float and int8 pools: logits within 1e-4,
  the written blocks equal (int8) or within 1e-5 (float);
* ``PrefixIndex``: one sequence of operations on both copies gives the same
  matches, evictions, digests and snapshots;
* inside the port, generation from a reused prefix is bit-identical to a
  cold prefill (``seq_impl="dense"``, as the JAX package pins it).
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.cache import prefix as jprefix
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.cache import prefix as tprefix
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX side compiled once per shape: cheaper on the CPU than op by op
j_prefill = jax.jit(jl.prefill_slot_paged, static_argnames=("cfg", "seq_impl"))
j_suffix = jax.jit(jl.prefill_suffix_paged, static_argnames=("cfg", "prefix_window"))
j_decode = jax.jit(jl.decode_slots_paged, static_argnames=("cfg", "window"))
BS = 16
ROW = np.array([3, 1, 4, 2, 5, 0, 0, 0], np.int32)  # slot 0's table row, 5 blocks reserved


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=128)
    # compiled once: cheaper on the CPU than the initializer op by op
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=128)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _np(x):
    """A JAX array as numpy; bf16 (which numpy lacks) as float32."""
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _torch_cache(jcache) -> dict:
    """The port's pool holding exactly the JAX pool's contents."""
    return {k: torch.from_numpy(np.array(_np(v))) for k, v in jcache.items()}


# ------------------------------------------------------------ int8 math


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_quant_kv_bytes_and_scales_equal_jax(jdt, tdt):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    # exact half-way ties: amax 127 gives scale 1, amax 254 gives scale 2,
    # so these rows hold x / scale = k + 0.5 exactly (half to even decides)
    x[0, 0] = np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5] * 2, np.float32)
    x[0, 1] = np.array([254, 5, -7, 1, 3, -3, 9, 11] * 2, np.float32)
    x[1, 2] = 0.0  # all-zero row: scale 0, q 0
    x[2, 3, :] = -0.0
    qj, sj = jl._quant_kv(jnp.asarray(x), jdt)
    qt, st = tl._quant_kv(torch.from_numpy(x), tdt)
    assert qt.dtype == torch.int8 and st.dtype == tdt
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(), _np(sj))
    assert qt[0, 0, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]
    assert qt[0, 1, :8].tolist() == [127, 2, -4, 0, 2, -2, 4, 6]
    assert not qt[1, 2].any() and float(st[1, 2]) == 0.0
    dj = jl._dequant_kv(qj, sj, jnp.float32)
    np.testing.assert_array_equal(tl._dequant_kv(qt, st, torch.float32).numpy(), np.asarray(dj))


def test_int8_pool_layout_and_slot_bytes_match_jax():
    cfg, tcfg = jl.Config.tiny(max_seq=128), tl.Config.tiny(max_seq=128)
    jc = jl.init_paged_cache(cfg, 2, 9, BS, dtype=jnp.bfloat16, kv_dtype="int8")
    tc = tl.init_paged_cache(tcfg, 2, 9, BS, dtype=torch.bfloat16, kv_dtype="int8")
    assert sorted(tc) == sorted(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    assert tc["k"].dtype == tc["v"].dtype == torch.int8
    assert tc["k_scale"].dtype == tc["v_scale"].dtype == torch.bfloat16
    assert tc["k_scale"].shape == (tcfg.n_layers, 9, BS, tcfg.n_kv_heads)
    assert "k_scale" not in tl.init_paged_cache(tcfg, 2, 9, BS)
    with pytest.raises(ValueError, match="kv_dtype"):
        tl.init_paged_cache(tcfg, 2, 9, BS, kv_dtype="fp8")
    for name in ("tiny", "llama3_1b"):
        for kv in (None, "int8"):
            for dt, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                want = jl.paged_kv_slot_bytes(getattr(jl.Config, name)(), BS, kv_dtype=kv, dtype=dt)
                for d in (dt, tdt):
                    got = tl.paged_kv_slot_bytes(getattr(tl.Config, name)(), BS, kv_dtype=kv, dtype=d)
                    assert got == want, (name, kv, d)
    # llama3-1b at 2048 tokens: 16 layers x 2 x 8 KV heads x (64 + 2) bytes x 2048
    one_b = tl.Config.llama3_1b()
    assert tl.paged_kv_slot_bytes(one_b, BS, kv_dtype="int8", dtype="bfloat16") == 34_603_008
    assert tl.paged_kv_slot_bytes(one_b, BS, dtype=torch.bfloat16) == 67_108_864


@pytest.fixture(scope="module")
def int8_prefilled(tiny):
    """A 40-token prompt (48-row bucket) prefilled into slot 0 of an int8
    pool by both frameworks."""
    cfg, jparams, tcfg, tparams = tiny
    toks = np.zeros((1, 48), np.int32)
    toks[0, :40] = np.random.default_rng(5).integers(0, cfg.vocab_size, 40)
    jc = jl.init_paged_cache(cfg, 2, 9, BS, kv_dtype="int8")
    jlog, jc = j_prefill(jparams, jnp.asarray(toks), jnp.int32(40), jnp.int32(0),
                         jnp.asarray(ROW), jc, cfg=cfg, seq_impl="dense")
    tc = tl.init_paged_cache(tcfg, 2, 9, BS, kv_dtype="int8")
    tlog, tc = tl.prefill_slot_paged(tparams, torch.from_numpy(toks), 40, 0, ROW, tc, tcfg,
                                     seq_impl="dense")
    return jlog, jc, tlog, tc


def _assert_pool_equal(tc, jc):
    for key in ("k", "v"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), rtol=1e-5, atol=0, err_msg=key)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    assert tc["table"].tolist() == np.asarray(jc["table"]).tolist()


def test_int8_prefill_matches_jax(int8_prefilled):
    jlog, jc, tlog, tc = int8_prefilled
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    _assert_pool_equal(tc, jc)
    assert tc["k"][:, ROW[:3]].abs().max() == 127  # the rows really are quantized


def test_int8_decode_matches_jax(tiny, int8_prefilled):
    """Two decode steps, slot 1 inactive: its rows and scales go to the sink
    block 0 in both frameworks; the port reads through the kernel's plain
    version (dequantizing), JAX through its XLA gather."""
    cfg, jparams, tcfg, tparams = tiny
    jlog, jc, tlog, tc = int8_prefilled
    tc = {k: v.clone() for k, v in tc.items()}  # the port updates in place
    jc = dict(jc)
    act = np.array([True, False])
    tok = np.array([int(np.argmax(np.asarray(jlog))), 7], np.int32)
    for _ in range(2):
        jd, jc = j_decode(jparams, jnp.asarray(tok), jc, jnp.asarray(act), cfg=cfg, window=64)
        td, tc = tl.decode_slots_paged(tparams, torch.from_numpy(tok), tc,
                                       torch.from_numpy(act), tcfg, window=64)
        np.testing.assert_allclose(td.numpy()[0], np.asarray(jd)[0], **LOGIT_TOL)
        tok = np.array([int(np.argmax(np.asarray(jd)[0])), 7], np.int32)
    _assert_pool_equal(tc, jc)
    assert tc["k_scale"][:, 0].abs().sum() > 0  # the inactive slot wrote the sink


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("prefix_len", [16, 32])
def test_prefill_suffix_paged_matches_jax(tiny, kv_dtype, prefix_len, monkeypatch):
    """The JAX package prefills ``prefix_len`` tokens; both frameworks then
    run the suffix program from that same pool.  A 28-token suffix in a
    32-row bucket: the second suffix block runs past the 60-token length,
    and at prefix_len 16 the window (16) ends exactly at the prefix."""
    cfg, jparams, tcfg, tparams = tiny
    full = np.random.default_rng(prefix_len).integers(0, cfg.vocab_size, 60).astype(np.int32)
    L = prefix_len + 28
    jc = jl.init_paged_cache(cfg, 2, 9, BS, kv_dtype=kv_dtype)
    _, jc = j_prefill(jparams, jnp.asarray(full[None, :prefix_len]), jnp.int32(prefix_len),
                      jnp.int32(0), jnp.asarray(ROW), jc, cfg=cfg, seq_impl="dense")
    tc = _torch_cache(jc)
    suffix = np.zeros((1, 32), np.int32)
    suffix[0, :28] = full[prefix_len:L]
    pb = prefix_len // BS
    sblocks = ROW[pb:pb + 2].copy()
    window = prefix_len
    jlog, jc = j_suffix(
        jparams, jnp.asarray(suffix), jnp.int32(prefix_len), jnp.int32(L), jnp.int32(0),
        jnp.asarray(ROW), jnp.asarray(sblocks), jc, cfg=cfg, prefix_window=window)
    seen = []  # the port's quantizer calls: (x, q, scale), k then v per layer
    quant = tl._quant_kv

    def recording(x, scale_dtype):
        q, s = quant(x, scale_dtype)
        seen.append((x.float(), q, s.float()))
        return q, s

    monkeypatch.setattr(tl, "_quant_kv", recording)
    tlog, tc = tl.prefill_suffix_paged(tparams, torch.from_numpy(suffix), prefix_len, L, 0,
                                       ROW, sblocks, tc, tcfg, prefix_window=window)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    assert tc["table"].tolist() == np.asarray(jc["table"]).tolist()
    if kv_dtype is None:
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), rtol=0, atol=1e-5)
        return
    assert len(seen) == 2 * tcfg.n_layers
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), rtol=1e-5, atol=0, err_msg=key)
    # The int8 bytes are equal except where the two frameworks' f32 K/V
    # (equal to ~1e-7) straddle a rounding tie of x / scale: such a byte
    # may differ by one step.  Every differing byte must be such a tie.
    flips = 0
    for ki, key in enumerate(("k", "v")):
        diff = tc[key].numpy().astype(np.int32) - np.asarray(jc[key]).astype(np.int32)
        for li, blk, r, h, d in np.argwhere(diff):
            assert abs(diff[li, blk, r, h, d]) == 1
            x, _, s = seen[2 * li + ki]
            j = int(np.flatnonzero(sblocks == blk)[0]) * BS + r
            frac = float(x[0, j, h, d] / s[0, j, h]) % 1.0
            assert abs(frac - 0.5) < 1e-3, (key, li, blk, r, h, d, frac)
            flips += 1
    # a flipped byte moves one attended K/V element by one step (amax/127);
    # with none, the logits agree as in f32
    tol = LOGIT_TOL if flips == 0 else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    assert flips <= 2
    assert int(np.argmax(tlog.numpy())) == int(np.argmax(np.asarray(jlog)))


# ------------------------------------------------------------ prefix index


def _index_ops(mod):
    """One sequence of operations on a PrefixIndex of module ``mod``;
    returns everything the index answered."""
    idx = mod.PrefixIndex(4)
    a = np.arange(1, 20, dtype=np.int32)
    b = np.concatenate([a[:8], np.arange(50, 60, dtype=np.int32)])
    c = np.arange(100, 113, dtype=np.int32)
    out = [mod.chain_hash(b"\x01\x02"), mod.adapter_salt(None), mod.adapter_salt("x")]
    out.append(idx.match(a, 4))  # miss
    out.append(idx.insert(a, [11, 12, 13, 14], 0))
    out.append(idx.match(b, 4))  # shares 2 blocks with a
    out.append(idx.peek_depth(a, 4))
    out.append(idx.insert(b, [21, 22], 2))
    out.append(idx.insert(a, [99], 1))  # level 2 already present: rejected
    out.append(idx.insert(c, [31, 32, 33], 0))
    out.append([(k, d, blk) for k, d, blk in idx.acquire(c, 3)])
    idx.release(c, 3)
    idx.ref_range(a, 0, 2)
    out.append(idx.snapshot())
    out.append(idx.evict(3))  # b's 2-block chain is referenced (match above)
    idx.release(b, 2)
    idx.release(a, 2)
    out.append([(k, d, blk) for k, d, blk in idx.evict_entries(2)])
    out.append(idx.digest())
    out.append(idx.digest(max_entries=1))
    out.append(idx.flush())
    out.append(idx.snapshot())
    out.append(len(idx))
    return out


def test_prefix_index_answers_like_the_jax_index():
    assert _index_ops(tprefix) == _index_ops(jprefix)


# --------------------------------------------- reuse equals cold, in the port

REUSE_PREFIX = list(range(7, 39))  # 32 tokens = 2 full 16-token blocks


def _serve_sequentially(model, prompts, *, temperature=0.0, seed=None, max_new=8):
    sched = GenerationScheduler(model)
    if seed is not None:
        sched._seed = seed

    async def go():
        try:
            return [
                (await sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                                    temperature=temperature)).tolist()
                for p in prompts
            ]
        finally:
            await sched.close()

    return asyncio.run(go())


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "topk"])
def test_reuse_is_bit_identical_to_cold_prefill(tiny, kv_dtype, temperature):
    """After ``tests/test_cache.py::TestPrefixReusePinnedEqual``: three
    prompts sharing a 2-block prefix, served one after another; the second
    and third reuse the first's blocks."""
    _, _, tcfg, tparams = tiny
    prompts = [REUSE_PREFIX + [40 + i, 41 + i, 42 + i] for i in range(3)]

    def serve(reuse):
        model = GenerativeModel(tcfg, tparams, n_slots=2, kv_block_size=BS, top_k=4,
                                seq_impl="dense", kv_cache_dtype=kv_dtype,
                                prefix_reuse=reuse, device="cpu")
        return _serve_sequentially(model, prompts, temperature=temperature, seed=4242), model

    cold, _ = serve(False)
    warm, model = serve(True)
    assert warm == cold
    assert model.prefills_reused == 2
    snap = model.prefix_snapshot()
    assert snap["tokens_reused"] == 64  # 2 hits x 2 blocks x 16 tokens
    assert snap["prefills_reused"] == 2 and snap["hits"] == 2
    assert snap["free_blocks"] + snap["entries"] == snap["pool_blocks"]


def test_reuse_logits_and_pool_rows_bit_identical(tiny):
    """The suffix program from shared blocks writes the rows and samples
    from the logits a cold prefill gives, bit for bit (dense, f32)."""
    _, _, tcfg, tparams = tiny
    prompt = np.asarray(REUSE_PREFIX + list(range(60, 73)), np.int32)  # 45 tokens
    logits = {}
    for kv_dtype in (None, "int8"):
        for reuse in (False, True):
            model = GenerativeModel(tcfg, tparams, n_slots=2, seq_impl="dense",
                                    kv_cache_dtype=kv_dtype, prefix_reuse=reuse, device="cpu")
            if reuse:
                model.admit(0, prompt[:33], 0.0, 0)
                model.release_slot(0)  # absorbs the 2 full prefix blocks
            row, plen = model.reserve_for_prompt(1, prompt, prompt.size)
            assert plen == (32 if reuse else 0)
            if reuse:
                suffix = np.zeros((1, 16), np.int32)
                suffix[0, :13] = prompt[32:]
                lg, _ = tl.prefill_suffix_paged(
                    model.params, torch.from_numpy(suffix), 32, prompt.size, 1, row, row[2:3],
                    model._cache, tcfg, prefix_window=32)
            else:
                padded = np.zeros((1, 48), np.int32)
                padded[0, :45] = prompt
                lg, _ = tl.prefill_slot_paged(model.params, torch.from_numpy(padded), prompt.size,
                                              1, row, model._cache, tcfg, seq_impl="dense")
            rows = {k: model._cache[k][:, row[:3].tolist()].flatten(1, 2)[:, :45].clone()
                    for k in ("k", "v", "k_scale", "v_scale") if k in model._cache}
            logits[kv_dtype, reuse] = (lg, rows)
        (cold, cold_rows), (warm, warm_rows) = logits[kv_dtype, False], logits[kv_dtype, True]
        assert torch.equal(cold, warm), kv_dtype
        for key in cold_rows:
            assert torch.equal(cold_rows[key], warm_rows[key]), (kv_dtype, key)


def test_pool_pressure_evicts_the_index_before_failing(tiny):
    """A pool of 8 blocks: eight requests of 2 blocks each, one after
    another, each leaving its 1-block prefix in the index; the last one
    finds only one free block and must evict, not starve."""
    _, _, tcfg, tparams = tiny
    model = GenerativeModel(tcfg, tparams, n_slots=2, kv_blocks=1 + 8, seq_impl="dense",
                            prefix_reuse=True, device="cpu")
    prompts = [[10 + i] * 16 + [60 + i, 61 + i] for i in range(8)]  # 8 distinct 1-block prefixes
    outs = _serve_sequentially(model, prompts, max_new=4)
    assert [len(o) for o in outs] == [4] * 8
    snap = model.prefix_snapshot()
    assert snap["evicted"] >= 1
    # whatever the index holds plus the free list is the whole pool
    assert snap["free_blocks"] + snap["entries"] == snap["pool_blocks"]
    model.reset()
    assert len(model.prefix_index) == 0 and model.free_block_count == model.kv_blocks - 1
