"""The PyTorch port's speculative decoding against the JAX package, on the CPU.

The same weights (the JAX ``init_params`` pytree, carried over by
``params_from_jax``) and the same seeded numpy inputs go through both
frameworks at ``Config.tiny`` (``max_seq=64``, 2 layers, 4 slots,
``decode_block=4``, f32):

* ``propose_ngram`` drafts equal JAX's exactly (random rings, no match, a
  match at the ring's edge, wrap-around); ``seed_history`` rows are equal;
* ``apply_medusa_heads`` matches at 1e-5; ``decode_slots_spec_paged``
  logits and hidden states at 1e-4, the pool rows it writes equal (int8:
  but for one-step rounding ties), rows with ``qvalid`` false in the sink;
* greedy streams and the acceptance ledger ``(spec_emitted_tokens,
  spec_verify_passes)`` equal the JAX ``GenerativeModel`` and scheduler
  for ``ngram``, ``heads`` (the JAX heads carried over) and ``draft``
  (``truncate:1``) at ``spec_draft`` 3 and 4, ``draft`` with
  ``preset:tiny`` (the JAX draft's weights carried over), ``ngram`` with prefix
  reuse and chunked prefill (a history ring seeded from the suffix alone
  changes acceptance, not tokens);
* inside the port, greedy speculation on equals off bit for bit for every
  method, plain and with int8 KV, prefix reuse and chunked prefill; an eos
  inside a pass stops there; seeded sampling is reproducible and
  ``top_k=1`` is greedy; each decode block costs exactly one
  device-to-host fetch.
"""

import asyncio
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chunked import _FetchCounter

from seldon_core_tpu.executor import speculative as jspec
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.executor import speculative as tspec
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import Implementation
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import medusa_heads_from_jax, params_from_jax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BS = 16
PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4], [11, 13, 17, 19, 23]]
REPETITIVE = np.tile([3, 7, 11], 8).tolist()  # drafts are accepted here
WAVE = PROMPTS + [REPETITIVE]
PREFIX = list(range(7, 39))  # 2 full 16-token blocks
# two waves: the second shares the first's 2-block prefix (reuse); the
# 33-35-token prompts run as 3 chunks of 16 and the 24-token one as 2
# (prefill_chunk)
WAVES = [[PREFIX + [40, 41], REPETITIVE, [30, 7]], [PREFIX + [50], PREFIX + [60, 61, 62], [5, 9]]]
METHODS = {
    "ngram": {"spec_method": "ngram"},
    "heads": {"spec_method": "heads", "spec_heads": 3},
    "draft": {"spec_method": "draft", "spec_draft_model": "truncate:1"},
}
method = pytest.mark.parametrize("mkw", list(METHODS.values()), ids=list(METHODS))
j_prefill = jax.jit(jl.prefill_slot_paged, static_argnames=("cfg", "seq_impl"))
j_spec = jax.jit(jl.decode_slots_spec_paged,
                 static_argnames=("cfg", "window", "return_hidden"))
j_ngram = jax.jit(jspec.propose_ngram, static_argnames=("n", "draft"))


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    # compiled once: cheaper on the CPU than the initializer op by op
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _serve(model, sched_cls, waves, *, max_new=11, temperature=0.0, seed=None, eos=None):
    """Each wave's prompts concurrently, the waves one after another."""
    sched = sched_cls(model)
    if seed is not None:
        sched._seed = seed

    async def go():
        out = []
        try:
            for wave in waves:
                out += await asyncio.gather(*(
                    sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                                 temperature=temperature, eos_id=eos)
                    for p in wave
                ))
        finally:
            await sched.close()
        return [o.tolist() for o in out]

    return asyncio.run(go())


def _port(tcfg, tparams, **kw):
    return GenerativeModel(tcfg, tparams, n_slots=4, decode_block=4, seq_impl="dense",
                           device="cpu", **kw)


# ------------------------------------------------------------ proposers


def _ring(H, seq):
    hist = np.zeros((1, H), np.int32)
    for p, t in enumerate(seq):
        hist[0, p % H] = t
    return hist, len(seq) - 1


def _ngram_cases():
    rng = np.random.default_rng(3)
    # position p at hist[p % 16]: 1 2 3 4 1 2 3 matches [2, 3] at 1
    hist, pos = _ring(16, [1, 2, 3, 4, 1, 2, 3])
    cases = [("continuation", hist, [pos], [3], 2, 2, [[4, 1]])]
    hist, pos = _ring(16, [9, 8, 7, 6, 5])
    cases.append(("no_match", hist, [pos], [5], 2, 3, [[5, 5, 5]]))
    # the only earlier match starts right at the ring's oldest row
    seq = [4, 5, 6] + list(range(20, 30)) + [4, 5]
    hist, pos = _ring(16, seq)
    cases.append(("ring_edge", hist, [pos], [5], 2, 1, None))
    # a long repetitive sequence that has wrapped the ring several times
    hist, pos = _ring(16, np.tile([3, 7, 11, 2], 12).tolist())
    cases.append(("wrapped", hist, [pos], [2], 3, 4, None))
    # random small-vocabulary rings (many matches, many ties of recency)
    hist = rng.integers(0, 4, (6, 32)).astype(np.int32)
    pos = rng.integers(0, 200, 6)
    cur = hist[np.arange(6), pos % 32]
    cases += [(f"random_n{n}_d{d}", hist, pos, cur, n, d, None) for n, d in ((1, 3), (2, 4), (3, 3))]
    return cases


@pytest.mark.parametrize("case", _ngram_cases(), ids=lambda c: c[0])
def test_propose_ngram_equals_jax(case):
    _, hist, pos, cur, n, d, want = case
    j = j_ngram(jnp.asarray(hist), jnp.asarray(pos, jnp.int32), jnp.asarray(cur, jnp.int32),
                n=n, draft=d)
    t = tspec.propose_ngram(torch.from_numpy(hist), torch.as_tensor(np.asarray(pos, np.int32)),
                            torch.as_tensor(np.asarray(cur, np.int32)), n=n, draft=d)
    assert t.dtype == torch.int32
    assert t.tolist() == np.asarray(j).tolist()
    if want is not None:
        assert t.tolist() == want


@pytest.mark.parametrize("length,H", [(1, 16), (5, 16), (15, 16), (16, 16), (40, 16), (100, 64)])
def test_seed_history_equals_jax(length, H):
    prompt = np.random.default_rng(length).integers(0, 256, length)
    np.testing.assert_array_equal(tspec.seed_history(prompt, H), jspec.seed_history(prompt, H))


def test_medusa_heads_and_truncated_draft_match_jax(tiny):
    cfg, jparams, tcfg, tparams = tiny
    jheads = jl.init_medusa_heads(jax.random.PRNGKey(1), cfg, 3, base_head=jparams["head"])
    theads = medusa_heads_from_jax(jax.tree.map(np.asarray, jheads))
    h = np.random.default_rng(0).standard_normal((4, cfg.hidden)).astype(np.float32)
    np.testing.assert_allclose(tl.apply_medusa_heads(theads, torch.from_numpy(h)).numpy(),
                               np.asarray(jl.apply_medusa_heads(jheads, jnp.asarray(h))),
                               rtol=1e-5, atol=1e-5)
    assert tl.medusa_head_bytes(tcfg, 3) == jl.medusa_head_bytes(cfg, 3, np.float32)
    # the port's synthesized heads start at the lm_head, with JAX's shapes
    own = tl.init_medusa_heads(torch.Generator().manual_seed(1), tcfg, 3, base_head=tparams.head)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in jheads.items()}
    assert torch.equal(own["head"][2], tparams.head)
    assert float(own["w1"].std()) == pytest.approx(0.01, rel=0.05)
    # truncate:1 slices the layer stacks and shares everything else
    dp = tl.truncate_params(tparams, 1)
    assert dp.cfg == dataclasses.replace(tcfg, n_layers=1)
    assert dp.head.data_ptr() == tparams.head.data_ptr()
    assert dp.layers["wq"].data_ptr() == tparams.layers["wq"].data_ptr()
    assert all(v.shape[0] == 1 for v in dp.layers.values())


# ------------------------------------------------------------ verify pass


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
def test_decode_slots_spec_paged_matches_jax(tiny, kv_dtype):
    """Slots at positions 14 and 30 verify 4 positions each (slot 0's
    cross into its next block); slot 0's budget ends after 2 of them, so
    positions 16 and 17 go to the sink block 0 and its own block keeps
    zeros there; slot 2 is inactive.  Logits and hidden states of the
    active slots at 1e-4, every block but the sink equal."""
    cfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(11)
    table = np.array([[3, 1, 0, 0], [2, 4, 5, 0], [0, 0, 0, 0]], np.int32)
    jc = jl.init_paged_cache(cfg, 3, 7, BS, kv_dtype=kv_dtype)
    for slot, n in ((0, 14), (1, 30)):  # 16- and 32-row buckets: slot 0's block 1 stays empty
        toks = np.zeros((1, 16 if n < 16 else 32), np.int32)
        toks[0, :n] = rng.integers(0, cfg.vocab_size, n)
        _, jc = j_prefill(jparams, jnp.asarray(toks), jnp.int32(n), jnp.int32(slot),
                          jnp.asarray(table[slot]), jc, cfg=cfg, seq_impl="dense")
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    qtok = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    act = np.array([True, True, False])
    qvalid = act[:, None] & (np.arange(4)[None, :] < np.array([2, 4, 4])[:, None])
    jlog, jc2, jhid = j_spec(jparams, jnp.asarray(qtok), jc, jnp.asarray(act),
                             jnp.asarray(qvalid), cfg=cfg, window=64, return_hidden=True)
    tlog, tc2, thid = tl.decode_slots_spec_paged(
        tparams, torch.from_numpy(qtok), tc, torch.from_numpy(act), torch.from_numpy(qvalid),
        tcfg, window=64, return_hidden=True)
    assert tlog.shape == (3, 4, cfg.vocab_size) and thid.shape == (3, 4, cfg.hidden)
    np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], **LOGIT_TOL)
    np.testing.assert_allclose(thid.numpy()[:2], np.asarray(jhid)[:2], **LOGIT_TOL)
    assert tc2["pos"].tolist() == [14, 30, 0]  # the caller advances pos
    for key in ("k", "v"):
        got, want = tc2[key].numpy()[:, 1:], np.asarray(jc2[key])[:, 1:]
        if kv_dtype is None:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=key)
        else:  # one-step rounding ties only (tests/test_torch_cache.py)
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).sum() <= 2, key
        # slot 0's positions 16 and 17 (block 1, rows 0-1) went to the sink
        assert not tc2[key][:, 1, :2].any() and tc2[key][:, 0].any(), key
    if kv_dtype is not None:
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc2[key].numpy()[:, 1:], np.asarray(jc2[key])[:, 1:],
                                       rtol=1e-5, atol=0, err_msg=key)
            assert not tc2[key][:, 1, :2].any() and tc2[key][:, 0].any(), key


# --------------------------------------------------- against the JAX scheduler


SCHED_CASES = {
    "ngram-d3": ({"spec_draft": 3, **METHODS["ngram"]}, [WAVE]),
    "ngram-d4": ({"spec_draft": 4, **METHODS["ngram"]}, [WAVE]),
    "heads-d3": ({"spec_draft": 3, **METHODS["heads"]}, [WAVE]),
    "heads-d4": ({"spec_draft": 4, **METHODS["heads"]}, [WAVE]),
    "draft-d3": ({"spec_draft": 3, **METHODS["draft"]}, [WAVE]),
    "draft-d4": ({"spec_draft": 4, **METHODS["draft"]}, [WAVE]),
    # the JAX package seeds a preset draft with PRNGKey(0): carried over
    "draft-preset-d3": ({"spec_draft": 3, "spec_method": "draft",
                         "spec_draft_model": "preset:tiny"}, [WAVE]),
    "ngram-d3-reuse-chunk": ({"spec_draft": 3, "prefix_reuse": True, "prefill_chunk": 16},
                             WAVES),
}


@pytest.mark.parametrize("case", list(SCHED_CASES), ids=list(SCHED_CASES))
def test_streams_and_acceptance_equal_the_jax_scheduler(tiny, case):
    cfg, jparams, tcfg, tparams = tiny
    kw, waves = SCHED_CASES[case]
    jm = JaxGenerativeModel(cfg, jparams, n_slots=4, decode_block=4, **kw)
    want = _serve(jm, JaxScheduler, waves)
    carried = {}
    if kw.get("spec_method") == "heads":  # JAX draws w1 from its own PRNG
        carried["medusa_heads"] = medusa_heads_from_jax(jax.tree.map(np.asarray, jm._spec_ps))
    if kw.get("spec_draft_model", "").startswith("preset:"):
        dcfg = tl.Config(**{f.name: getattr(jm._draft_cfg, f.name)
                            for f in dataclasses.fields(tl.Config)})
        carried["draft_params"] = params_from_jax(jax.tree.map(np.asarray, jm._spec_ps), dcfg)
    tm = _port(tcfg, tparams, **kw, **carried)
    got = _serve(tm, GenerationScheduler, waves)
    assert got == want
    ledger = (tm.spec_emitted_tokens, tm.spec_verify_passes)
    assert ledger == (jm.spec_emitted_tokens, jm.spec_verify_passes)
    assert ledger[0] == sum(map(len, want)) - sum(map(len, waves))  # first tokens aside
    assert ledger[0] > ledger[1] > 0  # some drafts were accepted
    if "prefix_reuse" in kw:
        assert (tm.prefills_reused, tm.prefill_chunks) == (jm.prefills_reused, jm.prefill_chunks)
        assert tm.prefills_reused == 2


# ------------------------------------------------------------ inside the port


FEATURES = {
    "plain": {},
    "int8": {"kv_cache_dtype": "int8"},
    "reuse": {"prefix_reuse": True},
    "chunk16": {"prefill_chunk": 16},
}


@pytest.fixture(scope="module")
def spec_off(tiny):
    """The port's greedy streams with speculation off, per feature."""
    _, _, tcfg, tparams = tiny
    return {name: _serve(_port(tcfg, tparams, **kw), GenerationScheduler, WAVES)
            for name, kw in FEATURES.items()}


@pytest.mark.parametrize("feature", list(FEATURES), ids=list(FEATURES))
@method
def test_spec_on_equals_spec_off_bit_for_bit(tiny, spec_off, feature, mkw):
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, spec_draft=3, **mkw, **FEATURES[feature])
    assert _serve(model, GenerationScheduler, WAVES) == spec_off[feature]
    assert model.spec_emitted_tokens > model.spec_verify_passes > 0
    assert model.host_syncs == model.decode_blocks
    if mkw["spec_method"] == "draft":
        assert model.draft_prefills == sum(map(len, WAVES))
    if feature == "reuse":
        assert model.prefills_reused == 2
    if feature == "chunk16":
        assert model.prefill_chunks == 3 * 3 + 2  # 16-token chunks of 33-35 and 24 tokens


@method
def test_eos_inside_a_pass_stops_there(tiny, mkw):
    _, _, tcfg, tparams = tiny
    base = _serve(_port(tcfg, tparams), GenerationScheduler, [[REPETITIVE]], max_new=24)[0]
    eos = base[5]
    stop_at = base.index(eos) + 1
    off = _serve(_port(tcfg, tparams), GenerationScheduler, [[REPETITIVE]], max_new=24, eos=eos)
    model = _port(tcfg, tparams, spec_draft=4, **mkw)
    on = _serve(model, GenerationScheduler, [[REPETITIVE]], max_new=24, eos=eos)
    assert on == off and len(on[0]) == stop_at and on[0][-1] == eos
    assert model.spec_emitted_tokens == stop_at - 1


@method
def test_seeded_sampling_reproducible_and_top_k_1_is_greedy(tiny, mkw):
    _, _, tcfg, tparams = tiny

    def run(top_k, temperature):
        model = _port(tcfg, tparams, spec_draft=3, top_k=top_k, **mkw)
        return _serve(model, GenerationScheduler, [WAVE], temperature=temperature, seed=4242)

    one = run(4, 0.9)
    assert one == run(4, 0.9)
    assert run(1, 0.9) == run(0, 0.0)


@method
def test_one_device_to_host_fetch_per_block(tiny, monkeypatch, mkw):
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, spec_draft=3, **mkw)
    fetches = _FetchCounter(monkeypatch)
    out = _serve(model, GenerationScheduler, [[[5 + i, 9, 2] for i in range(3)]], max_new=24)
    assert [len(o) for o in out] == [24] * 3
    # one fetch per decode block and one for the admission sync point
    assert model.host_syncs == model.decode_blocks > 0
    assert fetches.count == model.host_syncs + 1


def test_a_request_ending_mid_pass_frees_its_slot_once(tiny, monkeypatch):
    """Budgets of 2, 3 and 6 tokens end inside a 5-row pass: each slot is
    released once, when its request finishes, and the positions past the
    budget wrote only the sink."""
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, spec_draft=4)
    released = []
    real = model.release_slot

    def counted(slot):
        if slot in model._slot_blocks:
            released.append(slot)
        return real(slot)

    monkeypatch.setattr(model, "release_slot", counted)
    sched = GenerationScheduler(model)

    async def go():
        try:
            return await asyncio.gather(*(
                sched.submit(np.asarray(REPETITIVE, np.int32), max_new_tokens=n)
                for n in (2, 3, 6)))
        finally:
            await sched.close()

    out = asyncio.run(go())
    base = _serve(_port(tcfg, tparams), GenerationScheduler, [[REPETITIVE]], max_new=6)[0]
    assert [o.tolist() for o in out] == [base[:2], base[:3], base]
    assert sorted(released) == [0, 1, 2]


def test_draft_pool_misses_the_last_draft_row_after_full_acceptance(tiny):
    """The JAX package's draft unroll feeds the draft model the current
    token and the first ``spec_draft - 1`` drafts, never the last: after a
    pass that accepts every draft, row ``pos + spec_draft`` of the draft
    pool stays unwritten and the next pass drafts over it (ROADMAP Queue
    C).  Only acceptance pays; the port keeps the JAX package's unroll so
    that its acceptance ledger equals the reference's."""
    _, _, tcfg, tparams = tiny
    # a preset draft carrying these weights: the model drafts for itself
    model = _port(tcfg, tparams, spec_draft=3, spec_method="draft",
                  spec_draft_model="preset:tiny", draft_params=copy.deepcopy(tparams))
    first = model.admit(0, np.asarray(PROMPTS[0], np.int32), 0.0, 0, reserve_tokens=20)
    dk, table = model._draft_cache["k"], model._draft_cache["table"]
    before = [dk[:, table[0, p // BS], p % BS].clone() for p in range(5, 9)]  # prefill padding
    _, emitted = model.step_k(np.array([first, 0, 0, 0], np.int32), np.eye(4, dtype=bool)[0],
                              np.zeros(4, np.float32), 0, np.full(4, -1, np.int32),
                              np.array([19, 0, 0, 0], np.int32), 1)
    assert emitted[:, 0].tolist() == [True] * 4  # every draft accepted
    after = [dk[:, table[0, p // BS], p % BS] for p in range(5, 9)]
    # rows 5-7 took the current token and two drafts; row 8, the third
    # (accepted) draft's, still holds the prefill's padding
    assert [not torch.equal(a, b) for a, b in zip(before, after)] == [True, True, True, False]


def test_spec_configuration(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny
    with pytest.raises(GraphUnitError) as ei:
        GenerativeModel(tcfg, tparams, n_slots=2, decode_block=1, spec_draft=2, device="cpu")
    assert "decode_block" in str(ei.value) and "SCT_SPEC_DRAFT" in str(ei.value)
    assert GenerativeModel(tcfg, tparams, decode_block=1, device="cpu").spec_method is None
    with pytest.raises(GraphUnitError, match="spec_method"):
        _port(tcfg, tparams, spec_draft=2, spec_method="lookahead")
    with pytest.raises(GraphUnitError, match="spec_hist"):
        _port(tcfg, tparams, spec_draft=4, spec_ngram=4, spec_hist=8)
    with pytest.raises(GraphUnitError, match="truncate:2"):
        _port(tcfg, tparams, spec_draft=2, spec_method="draft", spec_draft_model="truncate:2")
    with pytest.raises(GraphUnitError, match="spec_draft_model"):
        _port(tcfg, tparams, spec_draft=2, spec_method="draft", spec_draft_model="big")
    with pytest.raises(GraphUnitError, match="medusa_heads"):
        _port(tcfg, tparams, spec_draft=2, medusa_heads={})
    m = _port(tcfg, tparams, spec_draft=2, spec_method="draft", spec_draft_model="preset:tiny")
    assert m._draft_cfg == tcfg and m.draft_weight_bytes == sum(
        p.nbytes for p in tparams.parameters())
    m = _port(tcfg, tparams, spec_draft=3, spec_method="draft")  # truncate:auto is 1 of 2
    assert m._draft_cfg.n_layers == 1 and 0 < m.draft_weight_bytes < sum(
        p.nbytes for p in tparams.parameters())
    assert m.draft_kv_bytes == 2 * 1 * (1 + 4 * 4) * BS * tcfg.n_kv_heads * tcfg.head_dim * 4
    monkeypatch.setenv("SCT_SPEC_DRAFT", "3")
    monkeypatch.setenv("SCT_SPEC_NGRAM", "2")
    monkeypatch.setenv("SCT_SPEC_METHOD", "heads")
    monkeypatch.setenv("SCT_SPEC_HEADS", "5")
    m = _port(tcfg, tparams)
    snap = m.spec_snapshot()
    assert (snap["spec_draft"], snap["spec_ngram"], snap["spec_method"], snap["spec_heads"]) == (
        3, 2, "heads", 5)
    assert m.spec_heads_bytes == tl.medusa_head_bytes(tcfg, 5)
    monkeypatch.setenv("SCT_SPEC_METHOD", "draft")
    monkeypatch.setenv("SCT_SPEC_DRAFT_MODEL", "truncate:1")
    assert _port(tcfg, tparams).spec_snapshot()["spec_draft_model"] == "truncate:1"


@pytest.mark.parametrize("params,method_name", [
    ({"spec_draft": 3}, "ngram"),
    ({"spec_draft": 2, "spec_method": "heads", "spec_heads": 3}, "heads"),
    ({"spec_draft": 2, "spec_method": "draft", "spec_draft_model": "truncate:1"}, "draft"),
])
def test_slice4_parameters_switch_speculation_on(params, method_name):
    comp = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", **params},
                          device="cpu")
    assert comp.model.spec_method == method_name
    assert create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny"},
                          device="cpu").model.spec_method is None
    with pytest.raises(GraphUnitError, match="spec_heads_path"):
        create_builtin(Implementation.JAX_GENERATIVE,
                       {"preset": "tiny", "spec_heads_path": "/heads.npz", **params}, device="cpu")


def test_warmup_runs_verify_passes_and_a_draft_prefill(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny
    m = _port(tcfg, tparams, spec_draft=3, **METHODS["draft"])
    calls = {"verify": 0, "draft": 0}
    verify, draft = m._verify_pass, m.draft_prefill_dispatch

    def v(*a, **kw):
        calls["verify"] += 1
        return verify(*a, **kw)

    def d(*a, **kw):
        calls["draft"] += 1
        return draft(*a, **kw)

    monkeypatch.setattr(m, "_verify_pass", v)
    monkeypatch.setattr(m, "draft_prefill_dispatch", d)
    assert m.warmup() == len(m.prefill_buckets) + 1
    assert calls["verify"] == 4 and calls["draft"] == len(m.prefill_buckets)
    assert (m.spec_emitted_tokens, m.spec_verify_passes, m.draft_prefills) == (0, 0, 0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("slots,split", [(4, "probed"), (4, "all"), (1, "probed")],
                         ids=["4slots-probed", "4slots-all", "1slot-probed"])
def test_verify_rows_equal_plain_steps_bit_for_bit(tiny, kv_dtype, slots, split):
    """A verify pass at L = 4 against four plain steps on a copy of one
    pool, teacher-forced with the pass's tokens: every row a slot's budget
    covers has the step's logits and writes the step's pool bytes, bit for
    bit (budgets 4, 2, 1 and 3 end inside the pass).  The ops run per
    query position are those the device rounds otherwise at 4x the rows
    (``probed``; on this CPU every op at one slot) or all of them."""
    _, _, tcfg, tparams = tiny
    L = 4
    row_split = (tl.row_variant_ops(tcfg, slots, L) if split == "probed"
                 else frozenset(tl.ROW_OPS))
    rng = np.random.default_rng(11)
    cache = tl.init_paged_cache(tcfg, slots, 1 + 4 * slots, BS, kv_dtype=kv_dtype)
    for s in range(slots):
        n = int(rng.integers(5, 40))
        padded = np.zeros((1, 64), np.int32)
        padded[0, :n] = rng.integers(0, tcfg.vocab_size, n)
        row = np.zeros(tcfg.max_seq // BS, np.int32)
        row[:] = 1 + 4 * s + np.arange(4)
        tl.prefill_slot_paged(tparams, torch.from_numpy(padded), n, s, row, cache, tcfg,
                              seq_impl="dense")
    qtok = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (slots, L)).astype(np.int32))
    budget = torch.tensor([4, 2, 1, 3][:slots])
    qvalid = torch.arange(L)[None, :] < budget[:, None]
    act = torch.ones(slots, dtype=torch.bool)
    passed = {k: v.clone() for k, v in cache.items()}
    verify, _ = tl.decode_slots_spec_paged(tparams, qtok, passed, act, qvalid, tcfg, window=64,
                                           row_split=row_split)
    stepped = {k: v.clone() for k, v in cache.items()}
    for j in range(L):
        step, _ = tl.decode_slots_paged(tparams, qtok[:, j].contiguous(), stepped, qvalid[:, j],
                                        tcfg, window=64)
        for s in range(slots):
            if qvalid[s, j]:
                assert torch.equal(verify[s, j], step[s]), (s, j)
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:  # block 0 is the sink the rows past a budget go to
            assert torch.equal(passed[key][:, 1:], stepped[key][:, 1:]), key
    if slots == 1 and split == "probed":
        assert row_split  # the split path ran
