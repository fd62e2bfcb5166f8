"""The PyTorch port's chunked prefill, and its scheduler with int8 KV,
prefix reuse and chunking, on the CPU.

* Greedy streams of the port's scheduler equal the JAX package's
  ``GenerativeModel`` and scheduler on the same weights with int8 KV,
  prefix reuse and ``prefill_chunk=16``, each alone and all together.
* A cancelled or failed admission leaves no unwritten block for the
  prefix index: the retry of the same prompt equals a cold prefill.
* Inside the port, chunked equals monolithic bit for bit (greedy and
  seeded top-k, float and int8 pools; ``seq_impl="dense"``).
* Pacing: while a stream decodes, a long admission advances one chunk per
  sync point and adds no device-to-host fetch (counted here, apart from
  the model's own counters); an idle scheduler admits at once.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

# tests/test_chunked.py's mixed lengths: several longer than one 16-token
# chunk, one shorter
PROMPTS = [
    list(range(5, 50)),
    [30, 7],
    list(range(1, 70)),
    [11, 13, 17, 19, 23],
]
# a second wave extends each prompt by one token, so prompts of at least
# one full block find their prefix in the index
WAVES = [PROMPTS, [p + [7] for p in PROMPTS]]


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=128)
    # compiled once: cheaper on the CPU than the initializer op by op
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=128)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _serve_waves(model, sched_cls, waves, *, temperature=0.0, seed=None, max_new=9):
    sched = sched_cls(model)
    if seed is not None:
        sched._seed = seed

    async def go():
        out = []
        try:
            for wave in waves:
                out += await asyncio.gather(*(
                    sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                                 temperature=temperature)
                    for p in wave
                ))
        finally:
            await sched.close()
        return [o.tolist() for o in out]

    return asyncio.run(go())


@pytest.fixture(scope="module")
def jax_streams(tiny):
    """The JAX scheduler's greedy streams with prefix reuse and
    ``prefill_chunk=16`` on, over a float and an int8 pool, with its
    counters.  The JAX package pins reuse == cold and chunked == monolithic
    (``tests/test_cache.py``, ``tests/test_chunked.py``), so each stream is
    also what it serves with either feature alone: one run per pool dtype
    holds all four configurations below."""
    cfg, jparams, _, _ = tiny
    out = {}
    for kv_dtype in (None, "int8"):
        jm = JaxGenerativeModel(cfg, jparams, n_slots=4, decode_block=4, kv_cache_dtype=kv_dtype,
                                prefix_reuse=True, prefill_chunk=16)
        out[kv_dtype] = (_serve_waves(jm, JaxScheduler, WAVES),
                         (jm.prefills, jm.prefills_reused, jm.prefill_chunks))
    return out


# per wave, the prompts of 45 and 69 (then 46 and 70) tokens chunk into 3
# and 5 chunks cold; reused, wave 2 keeps 14 and 6 novel tokens: 1 chunk each
CHUNKS_COLD, CHUNKS_REUSED = 3 + 5 + 3 + 5, 3 + 5 + 1 + 1


@pytest.mark.parametrize("features,chunks", [
    ({"kv_cache_dtype": "int8"}, 0),
    ({"prefix_reuse": True}, 0),
    ({"prefill_chunk": 16}, CHUNKS_COLD),
    ({"kv_cache_dtype": "int8", "prefix_reuse": True, "prefill_chunk": 16}, CHUNKS_REUSED),
], ids=["int8", "reuse", "chunk16", "all"])
def test_scheduler_streams_equal_the_jax_scheduler(tiny, jax_streams, features, chunks):
    _, _, tcfg, tparams = tiny
    want, jax_counts = jax_streams[features.get("kv_cache_dtype")]
    assert jax_counts == (8, 2, CHUNKS_REUSED)  # 8 prompts, the 2 of wave 2 reused
    tm = GenerativeModel(tcfg, tparams, n_slots=4, decode_block=4, seq_impl="dense",
                         device="cpu", **features)
    got = _serve_waves(tm, GenerationScheduler, WAVES)
    assert got == want
    assert (tm.prefills, tm.prefills_reused, tm.prefill_chunks) == (
        8, 2 * ("prefix_reuse" in features), chunks)
    assert tm.host_syncs == tm.decode_blocks > 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "topk"])
def test_chunked_is_bit_identical_to_monolithic(tiny, kv_dtype, temperature):
    _, _, tcfg, tparams = tiny

    def serve(chunk):
        model = GenerativeModel(tcfg, tparams, n_slots=4, decode_block=4, top_k=4,
                                seq_impl="dense", kv_cache_dtype=kv_dtype,
                                prefill_chunk=chunk, device="cpu")
        return _serve_waves(model, GenerationScheduler, [PROMPTS], temperature=temperature,
                            seed=4242), model

    mono, _ = serve(0)
    chunked, model = serve(16)
    assert chunked == mono
    assert model.prefill_chunks >= 2  # the long prompts really chunked
    assert model.prefills == len(PROMPTS)  # one LOGICAL prefill each


def test_chunked_with_prefix_reuse_skips_the_reused_chunks(tiny):
    """Reuse composes: the matched prefix skips its chunks, only the novel
    suffix is chunked (after ``tests/test_chunked.py``)."""
    _, _, tcfg, tparams = tiny
    prefix = list(range(7, 39))  # 2 full 16-token blocks
    prompts = [[prefix + list(range(40 + i, 60 + i))] for i in range(3)]  # one per wave

    def serve(**kw):
        model = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, seq_impl="dense",
                                device="cpu", **kw)
        return _serve_waves(model, GenerationScheduler, prompts, max_new=6), model

    base, _ = serve()
    both, model = serve(prefill_chunk=16, prefix_reuse=True)
    assert both == base
    assert model.prefills_reused == 2
    assert model.prefill_chunks == 4 + 2 + 2  # 52 tokens in 16s cold, then 20 after 32 reused


class _FetchCounter:
    """Counts reads of tensor values into the host (``cpu``, ``item``,
    ``tolist``, ``numpy``, ``int``/``float``/``bool``) that would each be a
    device-to-host fetch on the card; reads of a tensor already fetched by
    ``cpu()`` are free."""

    READS = ("item", "tolist", "numpy", "__int__", "__float__", "__bool__", "__index__")

    def __init__(self, monkeypatch):
        self.count = 0
        self._fetched: list[torch.Tensor] = []  # kept alive: ids stay unique
        self._ids: set[int] = set()
        cpu = torch.Tensor.cpu

        def fetch(t, *a, **kw):
            self.count += 1
            out = cpu(t, *a, **kw)
            self._fetched.append(out)
            self._ids.add(id(out))
            return out

        monkeypatch.setattr(torch.Tensor, "cpu", fetch)
        for name in self.READS:
            monkeypatch.setattr(torch.Tensor, name, self._wrap(getattr(torch.Tensor, name)))

    def _wrap(self, read):
        def counted(t, *a, **kw):
            if id(t) not in self._ids:
                self.count += 1
            return read(t, *a, **kw)

        return counted


def _record_events(model, monkeypatch, events: list):
    """Log each decode block's dispatch (from host state or from the
    previous block's carry) and each chunk dispatch of ``model``, in
    order."""
    chunk = model.prefill_chunk_dispatch

    def logged(fn):
        def dispatch(*a, **kw):
            events.append("block")
            return fn(*a, **kw)

        return dispatch

    def logged_chunk(plan, i):
        events.append(("chunk", plan["slot"], i))
        return chunk(plan, i)

    for name in ("step_k_dispatch", "step_k_continue"):
        monkeypatch.setattr(model, name, logged(getattr(model, name)))
    monkeypatch.setattr(model, "prefill_chunk_dispatch", logged_chunk)


async def _interleaved_flood(model, *, max_new=40, floods=2):
    """One interactive stream decoding while long-prompt admissions arrive:
    the scenario chunking exists for (after tests/test_chunked.py)."""
    sched = GenerationScheduler(model)
    first = asyncio.Event()
    real_deliver = sched._deliver

    def deliver(*a, **kw):  # the stream is live once its first block came back
        real_deliver(*a, **kw)
        first.set()

    sched._deliver = deliver
    interactive = asyncio.create_task(
        sched.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=max_new))
    await asyncio.wait_for(first.wait(), 60)
    flood = [asyncio.create_task(sched.submit(np.arange(1, 60, dtype=np.int32),
                                              max_new_tokens=2))
             for _ in range(floods)]
    out = await interactive
    rest = await asyncio.gather(*flood)
    await sched.close()
    return out.tolist(), [r.tolist() for r in rest], sched


def test_paced_chunks_one_per_sync_point_and_no_extra_fetch(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny

    def model(chunk):
        return GenerativeModel(tcfg, tparams, n_slots=3, decode_block=4, seq_impl="dense",
                               prefill_chunk=chunk, device="cpu")

    # 48 tokens: the stream stays live through every flood chunk, also
    # when the overlap has run two blocks ahead before the floods arrive
    base = asyncio.run(_interleaved_flood(model(0), max_new=48))
    m = model(16)
    events = []
    _record_events(m, monkeypatch, events)
    fetches = _FetchCounter(monkeypatch)
    out, floods, sched = asyncio.run(_interleaved_flood(m, max_new=48))
    assert (out, floods) == base[:2]  # pacing changes no token
    # 59-token floods in 16-token chunks: 4 chunks each, all paced
    assert m.prefill_chunks == 8 and sched.chunks_paced == 8
    chunks_between = [0]
    for e in events:
        if e == "block":
            chunks_between.append(0)
        else:
            chunks_between[-1] += 1
    assert max(chunks_between) == 1, events  # one chunk per sync point
    # every fetch is a decode block's or one of the three admission sync
    # points' (the stream's admission, each flood's final chunk); the
    # intermediate chunks added none
    assert m.host_syncs == m.decode_blocks
    assert fetches.count == m.host_syncs + 1 + 2


def test_idle_scheduler_admits_a_long_prompt_at_once(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny
    prompt = [list(range(1, 70))]
    base = _serve_waves(GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4,
                                        seq_impl="dense", device="cpu"),
                        GenerationScheduler, [prompt])
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, seq_impl="dense",
                        prefill_chunk=16, device="cpu")
    events = []
    _record_events(m, monkeypatch, events)
    fetches = _FetchCounter(monkeypatch)
    assert _serve_waves(m, GenerationScheduler, [prompt]) == base
    # 5 chunks back to back before the first block, one fetch for the token
    assert events[:6] == [("chunk", 0, i) for i in range(5)] + ["block"]
    assert m.prefill_chunks == 5 and fetches.count == m.host_syncs + 1


def test_chunk_and_kv_configuration(tiny, monkeypatch):
    _, _, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, prefill_chunk=20, device="cpu")
    assert m.prefill_chunk == 32  # rounded up to a block multiple
    assert m.kv_dtype is None and m.prefix_index is None
    monkeypatch.setenv("SCT_PREFILL_CHUNK", "16")
    monkeypatch.setenv("SCT_KV_DTYPE", "int8")
    monkeypatch.setenv("SCT_CACHE_PREFIX", "1")
    m = GenerativeModel(tcfg, tparams, n_slots=2, device="cpu")
    assert (m.prefill_chunk, m.kv_dtype) == (16, "int8") and m.prefix_index is not None
    assert GenerativeModel(tcfg, tparams, kv_cache_dtype="bf16", device="cpu").kv_dtype is None
    with pytest.raises(Exception, match="kv_cache_dtype"):
        GenerativeModel(tcfg, tparams, kv_cache_dtype="fp8", device="cpu")
    # int8 pool accounting: 2 layers x 2 x 2 KV heads x (16 + 4) bytes per row
    assert m.kv_bytes_per_block() == 2 * 2 * 2 * 16 * (16 + 4)
    assert m.kv_bytes_per_slot() == m.kv_bytes_per_block() * m.max_blocks_per_slot
    assert m.kv_bytes_per_slot() == tl.paged_kv_slot_bytes(tcfg, 16, kv_dtype="int8")
    param_bytes = sum(p.nbytes for p in m.params.parameters())
    budget = param_bytes + 10 * m.kv_bytes_per_slot() + 1
    assert m.kv_slots_per_chip(budget) == 10
    monkeypatch.delenv("SCT_HBM_GB", raising=False)
    with pytest.raises(ValueError, match="hbm_bytes"):
        m.kv_slots_per_chip()


def test_warmup_runs_a_suffix_prefill_and_leaves_a_clean_index(tiny):
    _, _, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=2, prefix_reuse=True,
                        prefill_chunk=32, kv_cache_dtype="int8", device="cpu")
    plain = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=2, device="cpu")
    assert m.warmup() == plain.warmup() + 1
    assert len(m.prefix_index) == 0 and m.prefix_snapshot()["hits"] == 0
    assert m.free_block_count == m.kv_blocks - 1
    assert m.prefills == m.prefills_reused == m.prefill_chunks == 0


async def _abort_then_retry(model, prompt, abort_at, *, max_new=6):
    """A stream decodes while ``prompt`` is admitted; ``abort_at(task)``
    is installed on the model to cancel or fail that admission mid-way.
    Then the same prompt is sent again, as a client retrying would."""
    sched = GenerationScheduler(model)
    first = asyncio.Event()
    real_deliver = sched._deliver

    def deliver(*a, **kw):
        real_deliver(*a, **kw)
        first.set()

    sched._deliver = deliver
    stream = asyncio.create_task(
        sched.submit(np.asarray([5, 9, 2], np.int32), max_new_tokens=40))
    await asyncio.wait_for(first.wait(), 60)
    doomed = asyncio.create_task(sched.submit(prompt, max_new_tokens=max_new))
    abort_at(doomed, asyncio.get_running_loop())
    with pytest.raises((asyncio.CancelledError, RuntimeError)):
        await doomed
    retry = await sched.submit(prompt, max_new_tokens=max_new)
    await stream
    await sched.close()
    return retry.tolist()


@pytest.mark.parametrize("abort", ["cancel", "fail"])
@pytest.mark.parametrize("chunk", [0, 16], ids=["monolithic", "chunked"])
def test_aborted_prefill_gives_the_index_no_unwritten_block(tiny, monkeypatch, abort, chunk):
    """With reuse on, an admission cancelled by its client or failed before
    its prompt was fully written must not leave its blocks in the prefix
    index: the retry of the same prompt would attend blocks no one wrote.
    Chunked, the abort lands at the second of four chunks; monolithic, the
    cancel lands during the prefill (which completes, so its blocks are
    reusable) and the failure before it."""
    _, _, tcfg, tparams = tiny
    prompt = np.arange(1, 60, dtype=np.int32)  # 3 full blocks + 11 tokens
    cold = _serve_waves(GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4,
                                        seq_impl="dense", device="cpu"),
                        GenerationScheduler, [[prompt]], max_new=6)[0]
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, seq_impl="dense",
                        prefix_reuse=True, prefill_chunk=chunk, device="cpu")
    calls = {"n": 0}

    def abort_at(task, loop):
        name = "_exec_prefill_suffix" if chunk else "_exec_prefill"
        real = getattr(m, name)

        def hooked(payload):
            calls["n"] += 1
            if calls["n"] == 1 and payload["length"] > 16:
                if abort == "fail":
                    raise RuntimeError("device lost mid-prefill")
                loop.call_soon_threadsafe(task.cancel)
            return real(payload)

        monkeypatch.setattr(m, name, hooked)

    retry = asyncio.run(_abort_then_retry(m, prompt, abort_at))
    assert calls["n"] >= 1
    assert retry == cold
    # only a prefill that completed (cancelled monolithic) left its 3 full
    # prompt blocks in the index for the retry
    completed = chunk == 0 and abort == "cancel"
    assert m.prefills_reused == int(completed)
    assert m.prefix_snapshot()["tokens_reused"] == 48 * int(completed)
