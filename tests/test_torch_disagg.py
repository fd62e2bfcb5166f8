"""The port's KV handoff between engines (disaggregated prefill/decode) on
the CPU, against the JAX package and inside the port.

The same weights (the JAX ``init_params`` pytree at ``Config.tiny``, f32,
carried over by ``params_from_jax``) and the same prompts go through both
frameworks:

* the port's and the JAX package's handoff encoders give the same bytes
  for the same payload (f32, bf16, int8 with scales, the v5 speculation
  envelope), and each decodes the other's frames;
* a frame the JAX ``build_handoff_frame`` exports from a JAX
  ``GenerativeModel`` imports into the port, whose greedy decode gives the
  JAX unified engine's tokens; a port frame imports into the JAX package
  the same way (float and int8 pools, and ``spec_method=ngram``);
* inside the port, bit for bit: a handoff equals a unified decode (float,
  int8, an import landing on blocks the importer already holds, Medusa
  heads with the carried hidden); a killed handoff and a failed import
  release every block; a pinned slot is kept out of admission; two
  engines over loopback HTTP answer ``mode == "disagg"`` with the unified
  tokens, fall back to local decode when the peer is dead, refuse imports
  on a prefill engine (409), malformed frames (400) and a block-size skew
  (409); a third engine pulls a prefix chain from a peer and serves it
  from the peer tier.
"""

import asyncio
import json
import socket
import time
import urllib.error
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from seldon_core_tpu.disagg import handoff as jh
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import disagg
from seldon_core_tpu_torch.disagg import handoff as th
from seldon_core_tpu_torch.engine import app as engine_app
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor import multihost
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

PROMPTS = [[5, 9, 2, 17, 3], list(range(3, 40)), [30, 7]]
PREFIX = list(range(7, 39))  # 2 full 16-token blocks
MAX_NEW = 9


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _port(tcfg, tparams, **kw):
    kw.setdefault("n_slots", 2)
    return GenerativeModel(tcfg, tparams, decode_block=4, seq_impl="dense", device="cpu", **kw)


def _unified(model, sched_cls, prompts, max_new=MAX_NEW):
    async def go():
        sched = sched_cls(model)
        try:
            return [(await sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new)).tolist()
                    for p in prompts]
        finally:
            await sched.close()

    return asyncio.run(go())


def _import_all(model, sched_cls, frames, decode):
    """Decode each frame (``decode``: a framework's ``decode_handoff``) and
    run it to the end on ``model`` through its scheduler."""

    async def go():
        sched = sched_cls(model)
        out = []
        try:
            for frame in frames:
                p = decode(frame)
                kw = {k: p.get(k) for k in ("k_scale", "v_scale")}
                if p.get("spec_state") is not None:
                    kw["spec_state"] = p["spec_state"]
                out.append((await sched.submit_imported(
                    p["prompt"], first_token=int(p["first_token"]), k=p["k"], v=p["v"],
                    max_new_tokens=int(p["max_new_tokens"]), **kw)).tolist())
        finally:
            await sched.close()
        return out

    return asyncio.run(go())


def _export_all(model, frame_fn, prompts, max_new=MAX_NEW):
    """Prefill each prompt into slot 0 of ``model`` and frame its handoff."""
    frames = []
    for p in prompts:
        tok = model.admit(0, np.asarray(p, np.int32), 0.0, 0, reserve_tokens=max_new)
        frames.append(frame_fn(model, 0, np.asarray(p, np.int32), tok, max_new_tokens=max_new))
        model.release_slot(0)
    return frames


# ------------------------------------------------------------- the codec


def _blocks(kind):
    """(port tensors, JAX arrays) for one 2-block handoff: k, v, k_scale,
    v_scale (None for a float pool)."""
    rng = np.random.default_rng(2)
    shape = (2, 2, 16, 2, 16)
    if kind == "int8":
        arrays = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
        arrays += [rng.random(shape[:4]).astype(np.float32) for _ in range(2)]
        return [torch.from_numpy(a) for a in arrays], arrays
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if kind == "bfloat16":
        port = [torch.from_numpy(a).to(torch.bfloat16) for a in (k, v)]
        return port + [None, None], [
            t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for t in port] + [None, None]
    return [torch.from_numpy(k), torch.from_numpy(v), None, None], [k, v, None, None]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "spec-heads"])
def test_handoff_frames_byte_equal_across_frameworks(kind):
    """Without the optional v3/v4 fields both encoders write the same
    fields in the same order, so the same payload gives the same bytes;
    each decodes the other's frame to the same blocks."""
    (pk, pv, pks, pvs), (jk, jv, jks, jvs) = _blocks("float32" if kind == "spec-heads" else kind)
    hidden = np.linspace(-1, 1, 64, dtype=np.float32)
    kw = dict(block_size=16, max_new_tokens=7, temperature=0.5, eos_id=2)
    pspec = jspec = None
    if kind == "spec-heads":
        pspec = {"method": "heads", "hlast": torch.from_numpy(hidden)}
        jspec = {"method": "heads", "hlast": hidden}
    prompt = np.arange(20, dtype=np.int32)
    port = th.encode_handoff(prompt, 11, pk, pv, k_scale=pks, v_scale=pvs, spec_state=pspec, **kw)
    ref = jh.encode_handoff(prompt, 11, jk, jv, k_scale=jks, v_scale=jvs, spec_state=jspec, **kw)
    assert port == ref
    got = th.decode_handoff(ref)
    assert got["hv"] == th.HANDOFF_VERSION == jh.HANDOFF_VERSION
    assert (got["first_token"], got["max_new_tokens"], got["eos_id"]) == (11, 7, 2)
    for name, want in (("k", pk), ("v", pv), ("k_scale", pks), ("v_scale", pvs)):
        if want is not None:
            assert got[name].dtype == want.dtype and torch.equal(got[name], want)
    if pspec:
        assert torch.equal(got["spec_state"]["hlast"], pspec["hlast"])
    back = jh.decode_handoff(port)
    assert np.asarray(back["k"]).tobytes() == np.asarray(jk).tobytes()
    assert multihost.FRAME_MAGIC == b"SCT1" and multihost.FRAME_VERSION == 1


def test_handoff_codec_refusals_and_optional_fields():
    (k, v, _, _), (jk, jv, _, _) = _blocks("float32")
    prompt = np.arange(20, dtype=np.int32)
    # the v3 and v4 fields, as the JAX package writes them, are read back
    frame = jh.encode_handoff(prompt, 1, jk, jv, block_size=16, max_new_tokens=4,
                              traceparent="00-" + "a" * 32 + "-" + "b" * 16 + "-01",
                              deadline_ms=500.0, priority="batch", adapter="alpha")
    got = th.decode_handoff(frame)
    assert got["priority"] == "batch" and got["adapter"] == "alpha"
    pool = type("Pool", (), {"kv_block_size": 16, "kv_dtype": None})()
    with pytest.raises(th.HandoffError, match="adapter 'alpha'"):  # a pool without LoRA
        th.check_pool(pool, got)
    with pytest.raises(ValueError):
        th.decode_handoff(frame[:-3])
    with pytest.raises(ValueError, match="magic"):
        th.decode_handoff(b"NOPE" + frame[4:])
    newer = multihost.encode_step(th.HANDOFF_KEY, {
        "prompt": prompt, "first_token": 1, "block_size": 16, "k": k.numpy(), "v": v.numpy(),
        "kv_dtype": "float32", "hv": th.HANDOFF_VERSION + 1})
    with pytest.raises(th.HandoffError, match="newer"):
        th.decode_handoff(newer)
    with pytest.raises(th.HandoffError, match="missing"):
        th.decode_handoff(multihost.encode_step(th.HANDOFF_KEY, {"prompt": prompt}))
    with pytest.raises(th.HandoffError, match="not a KV handoff"):
        th.decode_handoff(multihost.encode_step(th.PREFIX_KEY, {"prompt": prompt}))


def test_roles():
    assert disagg.resolve_role(environ={}) == "unified"
    assert disagg.resolve_role(environ={"SCT_ENGINE_ROLE": " Prefill "}) == "prefill"
    assert disagg.resolve_role("decode", environ={"SCT_ENGINE_ROLE": "prefill"}) == "decode"
    with pytest.raises(ValueError, match="not one of"):
        disagg.resolve_role("decoder", environ={})
    assert disagg.decode_upstreams(environ={"SCT_DISAGG_DECODE": "a:1, b:2,"}) == ["a:1", "b:2"]
    with pytest.raises(SystemExit):
        engine_app.main(["--role", "decoder", "--device", "cpu"])


# --------------------------------------------------- across frameworks


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"}, {"spec_draft": 3}],
                         ids=["float", "int8", "ngram"])
def test_frames_cross_between_frameworks(tiny, kw):
    """JAX prefill -> port decode, and port prefill -> JAX decode, each
    equal to the JAX unified engine's greedy tokens."""
    cfg, jparams, tcfg, tparams = tiny
    jm = JaxGenerativeModel(cfg, jparams, n_slots=2, decode_block=4, **kw)
    want = _unified(jm, JaxScheduler, PROMPTS)
    jframes = _export_all(jm, jh.build_handoff_frame, PROMPTS)
    pm = _port(tcfg, tparams, **kw)
    assert _import_all(pm, GenerationScheduler, jframes, th.decode_handoff) == want
    assert pm.imports == len(PROMPTS)
    pframes = _export_all(_port(tcfg, tparams, **kw), th.build_handoff_frame, PROMPTS)
    assert _import_all(jm, JaxScheduler, pframes, jh.decode_handoff) == want


# -------------------------------------------------------- inside the port


@pytest.mark.parametrize("kw", [{}, {"kv_cache_dtype": "int8"},
                                {"spec_draft": 3, "spec_method": "heads"}],
                         ids=["float", "int8", "heads"])
def test_handoff_equals_unified_decode(tiny, kw):
    _, _, tcfg, tparams = tiny
    want = _unified(_port(tcfg, tparams, **kw), GenerationScheduler, PROMPTS)
    frames = _export_all(_port(tcfg, tparams, **kw), th.build_handoff_frame, PROMPTS)
    importer = _port(tcfg, tparams, **kw)
    assert _import_all(importer, GenerationScheduler, frames, th.decode_handoff) == want
    if "spec_method" in kw:
        assert th.decode_handoff(frames[0])["spec_state"]["hlast"].shape == (tcfg.hidden,)
        assert importer.spec_verify_passes > 0


def test_import_lands_on_warm_prefix_blocks(tiny):
    """Blocks the importer already holds for the prompt's leading blocks
    are referenced, not written; the stream equals a unified decode."""
    _, _, tcfg, tparams = tiny
    prompt = PREFIX + [40, 41, 42]
    want = _unified(_port(tcfg, tparams), GenerationScheduler, [prompt])
    frames = _export_all(_port(tcfg, tparams), th.build_handoff_frame, [prompt])
    importer = _port(tcfg, tparams, prefix_reuse=True)
    _unified(importer, GenerationScheduler, [PREFIX + [50, 51]])  # warms the 2-block chain
    put = []
    write = importer._put_blocks
    importer._put_blocks = lambda phys, blocks: put.append(len(phys)) or write(phys, blocks)
    assert _import_all(importer, GenerationScheduler, frames, th.decode_handoff) == want
    assert put == [1]  # 3 prompt blocks, 2 already held
    assert importer.prefix_snapshot()["tokens_reused"] == 32


def test_killed_handoff_and_failed_import_leak_no_block(tiny):
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, n_slots=2)
    start = model.free_block_count

    async def go():
        sched = GenerationScheduler(model)
        try:
            slot, tok = await sched.submit_prefill(np.asarray(PROMPTS[1], np.int32))
            pinned = model.free_block_count
            sched.release_external(slot)  # the handoff died before its POST
            await sched.submit(np.asarray([1, 2], np.int32), max_new_tokens=2)
            with pytest.raises(GraphUnitError, match="skew"):  # a frame of another shape
                await sched.submit_imported(
                    np.asarray(PROMPTS[1], np.int32), first_token=tok,
                    k=torch.zeros(2, 3, 8, 2, 16), v=torch.zeros(2, 3, 8, 2, 16))
            return pinned, model.free_block_count
        finally:
            await sched.close()

    pinned, after = asyncio.run(go())
    assert pinned < start and after == start


def test_pinned_slot_is_kept_out_of_admission(tiny):
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, n_slots=2)
    admitted = []
    admit = model.admit_dispatch
    model.admit_dispatch = lambda slot, *a, **kw: admitted.append(slot) or admit(slot, *a, **kw)

    async def go():
        sched = GenerationScheduler(model)
        try:
            slot, _ = await sched.submit_prefill(np.asarray(PROMPTS[0], np.int32))
            waves = [sched.submit(np.asarray(p, np.int32), max_new_tokens=4) for p in PROMPTS]
            outs = await asyncio.gather(*waves)
            during = list(admitted[1:])
            sched.release_external(slot)
            await sched.submit(np.asarray([4, 4], np.int32), max_new_tokens=2)
            return slot, during, outs
        finally:
            await sched.close()

    slot, during, outs = asyncio.run(go())
    assert len(during) == 3 and slot not in during and all(len(o) == 4 for o in outs)
    assert admitted[-1] == slot  # back in the pool once released


def test_request_arriving_during_a_sync_point_is_admitted_beside_pinned_slots(tiny):
    """Two of three slots pinned by handoffs, and a request submitted while
    the second one's prefill runs in its thread: the loop must not park on
    the wake-up that request already gave, but admit it into the free slot
    before any pinned slot is released."""
    _, _, tcfg, tparams = tiny
    model = _port(tcfg, tparams, n_slots=3)
    admit = model.admit_dispatch
    late = []

    async def go():
        loop = asyncio.get_running_loop()
        sched = GenerationScheduler(model)

        def admit_and_submit(slot, *a, **kw):
            if not late:  # submit while this sync point's thread runs
                loop.call_soon_threadsafe(lambda: late.append(asyncio.ensure_future(
                    sched.submit(np.asarray(PROMPTS[2], np.int32), max_new_tokens=3))))
                deadline = time.monotonic() + 10
                while not sched._waiting and time.monotonic() < deadline:
                    time.sleep(0.001)
            return admit(slot, *a, **kw)

        try:
            first, _ = await sched.submit_prefill(np.asarray(PROMPTS[0], np.int32))
            model.admit_dispatch = admit_and_submit
            second, _ = await sched.submit_prefill(np.asarray(PROMPTS[1], np.int32))
            out = await asyncio.wait_for(late[0], timeout=10)
            pinned = set(sched._external)
            sched.release_external(first)
            sched.release_external(second)
            return out, pinned, {first, second}
        finally:
            await sched.close()

    out, pinned, handoffs = asyncio.run(go())
    assert len(out) == 3 and pinned == handoffs


# ------------------------------------------------------------ over HTTP


def _graph(**extra):
    params = {"family": ("llama", "STRING"), "preset": ("tiny", "STRING"),
              "n_slots": (2, "INT"), "max_new_tokens": (MAX_NEW, "INT"),
              "decode_block": (4, "INT"), **extra}
    return PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "gen", "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": [{"name": k, "value": str(v), "type": t} for k, (v, t) in params.items()],
    }})


def _call(port, path, body=None, headers=None, raw=False):
    data = body if raw else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers=headers or {}, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _engines(specs: list[tuple]) -> list[EngineApp]:
    apps = []
    for spec, kw in specs:
        app = EngineApp(PredictionService(spec, device="cpu"), **kw)
        await app.start("127.0.0.1", 0)
        await app.boot()
        apps.append(app)
    return apps


def test_two_engines_hand_off_over_http(tiny, monkeypatch):
    def gen(port, prompt, headers=None):
        code, body = _call(port, "/disagg/generate", {"tokens": prompt}, headers)
        return code, json.loads(body)

    async def go():
        b, = await _engines([(_graph(), {"role": "decode"})])
        monkeypatch.setenv("SCT_DISAGG_DECODE", f"127.0.0.1:{b.port}")
        a, = await _engines([(_graph(), {"role": "prefill"})])
        dead, = await _engines([(_graph(), {
            "role": "prefill", "decode_upstreams": [f"127.0.0.1:{_free_port()}"]})])
        skew, = await _engines([(_graph(kv_block_size=(8, "INT")), {"role": "decode"})])
        try:
            model_a, model_dead = (x.service.walker.component.model for x in (a, dead))
            free = (model_a.free_block_count, model_dead.free_block_count)
            out = {"disagg": [await asyncio.to_thread(gen, a.port, p) for p in PROMPTS],
                   "unified": [await asyncio.to_thread(gen, b.port, p) for p in PROMPTS],
                   "fallback": [await asyncio.to_thread(gen, dead.port, p) for p in PROMPTS]}
            frame = th.build_handoff_frame(model_a, *_pinned(model_a), max_new_tokens=4)
            model_a.release_slot(0)
            out["import_on_prefill"] = await asyncio.to_thread(
                _call, a.port, "/disagg/import", frame, {}, True)
            out["malformed"] = await asyncio.to_thread(
                _call, b.port, "/disagg/import", frame[:-9], {}, True)
            out["block_skew"] = await asyncio.to_thread(
                _call, skew.port, "/disagg/import", frame, {}, True)
            out["stats"] = json.loads((await asyncio.to_thread(
                _call, a.port, "/stats/disagg"))[1])["disagg"]
            out["free"] = free, (model_a.free_block_count, model_dead.free_block_count)
            return out
        finally:
            for app in (a, b, dead, skew):
                await app.close()

    out = asyncio.run(go())
    unified = [body["tokens"] for code, body in out["unified"]]
    assert all(code == 200 and body["mode"] == "unified" for code, body in out["unified"])
    assert [(c, b["mode"]) for c, b in out["disagg"]] == [(200, "disagg")] * len(PROMPTS)
    assert [b["tokens"] for _, b in out["disagg"]] == unified
    assert [b["mode"] for _, b in out["fallback"]] == ["unified-fallback"] * len(PROMPTS)
    assert [b["tokens"] for _, b in out["fallback"]] == unified
    before, after = out["free"]
    assert before == after  # neither the handoffs nor the fallbacks leak a block
    assert out["import_on_prefill"][0] == 409 and out["malformed"][0] == 400
    assert out["block_skew"][0] == 409 and b"block size" in out["block_skew"][1]
    stats = out["stats"]
    assert stats["role"] == "prefill" and stats["handoffs_ok"] == len(PROMPTS)
    assert stats["handoff_bytes"] > 0 and stats["local_fallbacks"] == 0


def _pinned(model):
    """Prefill PROMPTS[1] into slot 0 of ``model`` -> (slot, prompt, first token)."""
    prompt = np.asarray(PROMPTS[1], np.int32)
    return 0, prompt, model.admit(0, prompt, 0.0, 0, reserve_tokens=4)


def test_peer_pull_serves_the_prefix_from_the_peer_tier(tiny, monkeypatch):
    """C pulls A's chain before prefilling, on ``/disagg/generate`` and on
    the predictions route, only with ``SCT_PREFIX_PEER_PULL=1`` and the
    peer header; it serves the prompt from the peer tier with A's tokens."""
    prompts = [PREFIX + [40, 41, 42], list(range(90, 122)) + [5, 6]]
    reuse = {"kv_prefix_reuse": ("true", "BOOL")}

    def predict(port, prompt, headers):
        code, body = _call(port, "/api/v0.1/predictions", {"strData": json.dumps(
            {"tokens": prompt, "max_new_tokens": MAX_NEW})}, headers)
        return code, {"tokens": json.loads(json.loads(body)["strData"])["tokens"]}

    async def go():
        a, c = await _engines([(_graph(**reuse), {}), (_graph(**reuse), {})])
        try:
            warm = [await asyncio.to_thread(_call, a.port, "/disagg/generate", {"tokens": p})
                    for p in prompts]
            miss = await asyncio.to_thread(_call, a.port, "/disagg/prefix/pull",
                                           {"tokens": [1, 2, 3] * 11})
            hint = {"x-sct-prefix-peer": f"127.0.0.1:{a.port}"}
            off = await asyncio.to_thread(_call, c.port, "/disagg/generate",
                                          {"tokens": [9] + prompts[0][1:]}, hint)
            monkeypatch.setenv("SCT_PREFIX_PEER_PULL", "1")
            pulled = [await asyncio.to_thread(_call, c.port, "/disagg/generate",
                                              {"tokens": prompts[0]}, hint),
                      await asyncio.to_thread(predict, c.port, prompts[1], hint)]
            model = c.service.walker.component.model
            return warm, miss, off, pulled, model.prefix_snapshot(), c.prefix_pull_stats
        finally:
            for app in (a, c):
                await app.close()

    warm, miss, off, pulled, snap, stats = asyncio.run(go())
    assert [w[0] for w in warm] == [200, 200] and off[0] == 200 and miss[0] == 404
    assert json.loads(pulled[0][1])["tokens"] == json.loads(warm[0][1])["tokens"]
    assert pulled[1] == (200, {"tokens": json.loads(warm[1][1])["tokens"]})
    assert stats["pulls_ok"] == 2 and stats["pull_blocks"] == 4  # none without the env
    assert snap["tiers"]["peer"]["hits"] == 2 and snap["tiers"]["peer"]["promotions"] == 4
