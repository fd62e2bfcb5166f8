"""The port's overlapped decode pipeline on the CPU.

Block N+1 is dispatched from block N's device carry before block N's
tokens are fetched (``GenerationScheduler(overlap=...)``,
``GenerativeModel.step_k_continue``).  Overlap on must equal overlap off
bit for bit (greedy, sampled with a fixed scheduler seed, with prefix
reuse and with speculation), the port's greedy streams must equal the JAX
scheduler's with overlap on (weights carried by ``params_from_jax``, the
JAX model running its Pallas kernels in interpret mode), every block must
cost one host sync, and each named cause that breaks the chain must be
counted.  All comparisons are exact: the same ops run in the same order
whichever way a block was dispatched.
"""

import asyncio

import jax
import numpy as np
import pytest

from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import Implementation
from seldon_core_tpu_torch.graph.units import create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4], [11, 12, 13], [40, 41, 42, 43, 44, 45]]


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _model(tiny, **kw):
    _, _, tcfg, tparams = tiny
    kw.setdefault("n_slots", 2)
    kw.setdefault("decode_block", 4)
    return GenerativeModel(tcfg, tparams, device="cpu", **kw)


def _generate(sched, prompts=PROMPTS, seed=None, **kw):
    """Submit ``prompts`` together; returns the token lists."""
    if seed is not None:
        sched._seed = seed

    async def go():
        try:
            return await asyncio.gather(*(sched.submit(np.asarray(p, np.int32), **kw)
                                          for p in prompts))
        finally:
            await sched.close()

    return [o.tolist() for o in asyncio.run(go())]


@pytest.mark.parametrize("case", ["greedy", "sampled", "sampled_top_k", "int8"])
def test_overlap_equals_sequential(tiny, case):
    kw = {"top_k": 5} if case == "sampled_top_k" else {}
    if case == "int8":
        kw["kv_cache_dtype"] = "int8"
    sample = {"temperature": 0.9} if case.startswith("sampled") else {}
    # sampled: every request is admitted at the first sync point (as many
    # slots as prompts), so both pipelines spend the same seeds in order
    n_slots = len(PROMPTS) if sample else 2
    base = _generate(GenerationScheduler(_model(tiny, n_slots=n_slots, **kw), overlap=False),
                     seed=1234, max_new_tokens=11, **sample)
    model = _model(tiny, n_slots=n_slots, **kw)
    sched = GenerationScheduler(model, overlap=True)
    got = _generate(sched, seed=1234, max_new_tokens=11, **sample)
    assert got == base
    assert model.overlapped >= 1  # the overlap happened, not a sequential fallback
    assert model.host_syncs == model.decode_blocks > 0
    assert model.free_block_count == model.kv_blocks - 1


def test_overlap_equals_sequential_with_prefix_reuse(tiny):
    prefix = list(range(7, 39))  # 2 full 16-token blocks
    prompts = [prefix + [40 + i, 41 + i] for i in range(3)]

    def gen(reuse, overlap):
        model = _model(tiny, kv_block_size=16, prefix_reuse=reuse)
        sched = GenerationScheduler(model, overlap=overlap)

        async def go():
            try:  # one at a time: each later prompt reuses the absorbed prefix
                return [(await sched.submit(np.asarray(p, np.int32), max_new_tokens=10)).tolist()
                        for p in prompts]
            finally:
                await sched.close()

        return asyncio.run(go()), model

    base, _ = gen(False, False)
    for reuse in (False, True):
        outs, model = gen(reuse, True)
        assert outs == base, reuse
        assert model.overlapped >= 1
        if reuse:
            assert model.prefills_reused >= 1


@pytest.mark.parametrize("method", ["ngram", "heads", "draft"])
def test_overlap_equals_sequential_with_speculation(tiny, method):
    spec = {"spec_draft": 2, "spec_method": method}
    if method == "draft":
        spec["spec_draft_model"] = "truncate:1"
    off = _generate(GenerationScheduler(_model(tiny), overlap=False), max_new_tokens=13)
    seq = _generate(GenerationScheduler(_model(tiny, **spec), overlap=False), max_new_tokens=13)
    model = _model(tiny, **spec)
    got = _generate(GenerationScheduler(model, overlap=True), max_new_tokens=13)
    assert got == seq == off
    assert model.overlapped >= 1
    assert model.host_syncs == model.decode_blocks


def test_greedy_streams_equal_the_jax_scheduler_with_overlap(tiny):
    cfg, jparams, _, _ = tiny
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, seq_impl="flash", decode_block=4,
                            decode_kernel=True)
    jsched = JaxScheduler(jm, overlap=True)

    async def go():
        try:
            return await asyncio.gather(*(jsched.submit(np.asarray(p, np.int32),
                                                        max_new_tokens=9) for p in PROMPTS))
        finally:
            await jsched.close()

    want = [o.tolist() for o in asyncio.run(go())]
    model = _model(tiny)
    got = _generate(GenerationScheduler(model, overlap=True), max_new_tokens=9)
    assert got == want
    assert jm.overlapped >= 1 and model.overlapped >= 1


class TestHostSyncAudit:
    """The port's copy of the JAX package's audit (tests/test_perf.py):
    syncs per generated token are ~1/decode_block, never ~1."""

    def test_steady_state_decode_has_no_per_token_syncs(self, tiny):
        block, max_new, n_req = 8, 24, 3
        model = _model(tiny, n_slots=4, decode_block=block)
        sched = GenerationScheduler(model, overlap=True)
        before = model.host_syncs
        outs = _generate(sched, [[5 + i, 9, 2] for i in range(n_req)], max_new_tokens=max_new)
        assert all(len(o) == max_new for o in outs)
        syncs = model.host_syncs - before
        tokens = n_req * max_new
        assert syncs <= tokens // block + 4, f"{syncs} host syncs for {tokens} tokens"
        assert syncs < tokens / 2, "per-token sync pattern detected"
        assert syncs == model.decode_blocks
        assert model.overlapped >= 1


class TestOverlapConfig:
    def test_env_kill_switch_disables_overlap(self, tiny, monkeypatch):
        monkeypatch.setenv("SCT_GEN_OVERLAP", "0")
        model = _model(tiny)
        sched = GenerationScheduler(model)
        assert sched.overlap is False
        out = _generate(sched, [[5, 9, 2]], max_new_tokens=8)
        assert len(out[0]) == 8
        assert model.overlapped == 0

    def test_decode_block_one_never_overlaps(self, tiny):
        model = _model(tiny, decode_block=1)
        sched = GenerationScheduler(model, overlap=True)
        assert sched.overlap is False
        out = _generate(sched, [[5, 9, 2]], max_new_tokens=6)
        assert len(out[0]) == 6
        assert model.overlapped == 0

    def test_default_is_on_for_fused_blocks_and_served(self, tiny, monkeypatch):
        monkeypatch.delenv("SCT_GEN_OVERLAP", raising=False)
        assert GenerationScheduler(_model(tiny)).overlap is True
        on = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny"}, device="cpu")
        off = create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", "overlap": False},
                             device="cpu")
        assert on.scheduler.overlap is True and off.scheduler.overlap is False


class TestBreakCauses:
    """Each named cause that keeps a block from continuing off the carry
    is counted, and the streams still equal the sequential pipeline's."""

    def _run(self, tiny, prompts, *, model_kw=None, max_new=12, hook=None):
        model = _model(tiny, **(model_kw or {}))
        sched = GenerationScheduler(model, overlap=True)

        async def go():
            try:
                tasks = [asyncio.ensure_future(sched.submit(np.asarray(p, np.int32),
                                                            max_new_tokens=max_new))
                         for p in prompts]
                if hook is not None:
                    await hook(sched, tasks)
                return await asyncio.gather(*tasks, return_exceptions=True)
            finally:
                await sched.close()

        return asyncio.run(go()), sched, model

    def test_admission(self, tiny):
        outs, sched, _ = self._run(tiny, PROMPTS)  # 5 prompts, 2 slots: requests wait
        assert sched.overlap_breaks["admission"] >= 1
        base = _generate(GenerationScheduler(_model(tiny), overlap=False), max_new_tokens=12)
        assert [o.tolist() for o in outs] == base

    def test_kv_starved(self, tiny):
        # a pool of 8 blocks: one 40-token request holds 4, a second must
        # wait in the overflow for blocks while the first decodes
        long = [list(range(1, 25)), list(range(30, 54))]
        outs, sched, model = self._run(tiny, long, model_kw={"kv_blocks": 6}, max_new=16)
        assert all(o.size == 16 for o in outs)
        assert sched.overlap_breaks["kv-starved"] >= 1
        assert model.free_block_count == model.kv_blocks - 1

    def test_chunked_prefill(self, tiny):
        async def late(sched, tasks):
            await asyncio.sleep(0)
            while not sched.model.decode_blocks:
                await asyncio.sleep(0.001)
            tasks.append(asyncio.ensure_future(sched.submit(
                np.arange(1, 41, dtype=np.int32), max_new_tokens=8)))

        outs, sched, _ = self._run(tiny, [[5, 9, 2]], model_kw={"prefill_chunk": 16},
                                   max_new=40, hook=late)
        assert sched.overlap_breaks["chunked-prefill"] >= 1
        assert sched.chunks_paced >= 1
        assert [o.size for o in outs] == [40, 8]

    def test_carry_dirty(self, tiny):
        async def cancel_after_first_block(sched, tasks):
            while sched.model.decode_blocks < 1:
                await asyncio.sleep(0.001)
            tasks[0].cancel()

        outs, sched, model = self._run(tiny, [[5, 9, 2], [30, 7]], max_new=40,
                                       hook=cancel_after_first_block)
        assert isinstance(outs[0], asyncio.CancelledError)
        assert outs[1].size == 40
        assert sched.overlap_breaks["carry-dirty"] >= 1
        assert model.free_block_count == model.kv_blocks - 1

    def test_handoff_release(self, tiny):
        async def pin_then_release(sched, tasks):
            slot, _ = await sched.submit_prefill(np.asarray([8, 8, 8], np.int32))
            while sched.model.decode_blocks < 2:
                await asyncio.sleep(0.001)
            sched.release_external(slot)

        outs, sched, model = self._run(tiny, [[5, 9, 2]], max_new=40, hook=pin_then_release)
        assert outs[0].size == 40
        assert sched.overlap_breaks["handoff-release"] >= 1
        assert model.free_block_count == model.kv_blocks - 1

    def test_dispatch_error(self, tiny):
        model = _model(tiny)
        real = model.step_k_continue
        calls = {"n": 0}

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected")
            return real(*a, **kw)

        model.step_k_continue = flaky
        sched = GenerationScheduler(model, overlap=True)
        got = _generate(sched, PROMPTS[:2], max_new_tokens=14)
        base = _generate(GenerationScheduler(_model(tiny), overlap=False), PROMPTS[:2],
                         max_new_tokens=14)
        assert got == base
        assert sched.overlap_breaks["dispatch-error"] == 1
        assert sched.overlap_snapshot()["breaks"]["dispatch-error"] == 1


def test_failed_fetch_drains_the_chained_block_and_fails_the_requests(tiny):
    model = _model(tiny)
    real = model.step_k_fetch
    calls = {"n": 0}

    def failing(handle):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device fault")
        return real(handle)

    model.step_k_fetch = failing
    sched = GenerationScheduler(model, overlap=True)

    async def go():
        try:
            return await asyncio.gather(*(sched.submit(np.asarray(p, np.int32), max_new_tokens=20)
                                          for p in PROMPTS[:2]), return_exceptions=True)
        finally:
            await sched.close()

    outs = asyncio.run(go())
    assert all(isinstance(o, RuntimeError) and "device fault" in str(o) for o in outs)
    assert calls["n"] == 3  # the failed block's fetch, then the chained block drained
    assert model.free_block_count == model.kv_blocks - 1


def test_continue_needs_a_carried_block(tiny):
    model = _model(tiny)
    with pytest.raises(RuntimeError, match="without a carried block"):
        model.step_k_continue(np.zeros(2, bool), 0, 4)


def test_replay_yardstick_is_the_cpu_body(tiny):
    """On the CPU no graph is captured: the body runs eagerly, and the
    program counters stay at zero."""
    model = _model(tiny)
    out = _generate(GenerationScheduler(model, overlap=True), PROMPTS[:2], max_new_tokens=9)
    assert all(len(o) == 9 for o in out)
    snap = model.program_snapshot()
    assert snap["program_compiles"] == snap["program_hits"] == 0 and snap["graphs"] == []
    assert snap["overlapped"] == model.overlapped >= 1
