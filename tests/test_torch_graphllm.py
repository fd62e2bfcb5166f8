"""The port's LLM graph units and device hooks against the JAX package's,
on the CPU (``tiny`` llama, f32).

* ``CascadeRouter.decide``/``read_confidence``, ``Guardrail.apply`` and
  the ``qos/context`` parsers equal the JAX units over a corpus.
* The confidence signal: the per-token top-2 logit margins and each
  request's ``confidence`` from the port's scheduler equal the JAX
  scheduler's with ``conf_signal`` on (weights carried by
  ``params_from_jax``; the JAX model runs its Pallas kernels in interpret
  mode), within 1e-4, for greedy decode and for verify passes
  (``spec_method='ngram'``); tokens, ``host_syncs`` and ``decode_blocks``
  are those of the signal off.
* ``embed_pooled`` equals the JAX function within 1e-5 and gives the same
  vector from two buckets.
* Through the port's engine: a cascade over two tiny tiers ships and
  escalates as the JAX walker does; ``/api/v0.1/feedback`` (and its
  ``/api/v1.0`` alias) replays the routed path; ``/api/v0.1/embeddings``
  answers the pooled vectors (400 without an embed unit).
"""

import asyncio
import base64
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu import qos as jqos
from seldon_core_tpu.contract import payload as jpayload
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeComponent as JaxComponent
from seldon_core_tpu.executor.generation import GenerativeModel as JaxModel
from seldon_core_tpu.graph.spec import PredictiveUnitSpec as JaxUnitSpec
from seldon_core_tpu.graph.units import GraphUnitError as JaxGraphUnitError
from seldon_core_tpu.graph.walker import GraphWalker as JaxWalker
from seldon_core_tpu.graphllm import CascadeRouter as JaxCascade
from seldon_core_tpu.graphllm import Guardrail as JaxGuardrail
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu_torch import qos as tqos
from seldon_core_tpu_torch.contract.payload import DataKind, Payload
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.executor.generation import (
    GenerationScheduler,
    GenerativeComponent,
    GenerativeModel,
)
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.graph.units import GraphUnitError
from seldon_core_tpu_torch.graphllm import CascadeRouter, Guardrail
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models.weights import params_from_jax

PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [11, 12, 13]]


# --------------------------------------------------------------------------
# host-only units over a corpus
# --------------------------------------------------------------------------


@pytest.mark.parametrize("threshold,ttft_ms", [(2.0, 0.0), (0.0, 0.0), (float("inf"), 0.0),
                                               (2.0, 50.0)])
def test_cascade_decisions_equal_the_jax_unit(threshold, ttft_ms):
    jr, tr = JaxCascade(threshold=threshold, ttft_ms=ttft_ms), CascadeRouter(
        threshold=threshold, ttft_ms=ttft_ms)
    replies = [{"confidence": 1.5}, {"confidence": [1.0, 3.0]}, {"confidence": [None, 0.25]},
               {"confidence": []}, {"tokens": [1]}, {"confidence": "x"}, {"confidence": 2.0}]
    for body in replies:
        data = json.dumps(body)
        assert tr.read_confidence(Payload(data, [], DataKind.STRING)) == jr.read_confidence(
            jpayload.Payload(data, [], jpayload.DataKind.STRING))
    assert tr.read_confidence(Payload(np.zeros(2), [], DataKind.NDARRAY)) is None
    assert tr.read_confidence(Payload("not json", [], DataKind.STRING)) is None
    for budget in (None, 10.0, 5000.0):
        jqos.set_budget_ms(budget)
        tqos.set_budget_ms(budget)
        try:
            for conf in (None, 0.0, 0.1, 1.999, 2.0, 7.5):
                for tier in (0, 1):
                    assert tr.decide(conf, tier, 3) == jr.decide(conf, tier, 3)
        finally:
            jqos.set_budget_ms(None)
            tqos.set_budget_ms(None)
    for r in (jr, tr):
        r.note_escalation()
        r.note_served(1)
        r.note_served(0)
    assert (tr.tags(), tr.metrics()) == (jr.tags(), jr.metrics())


GUARD_CORPUS = [
    "hello world", "mail a.user+x@example.com ssn 123-45-6789 phone (415) 555-1234",
    "call +1 415.555.1234 or 415-555-1234 now", "this is ForBidden text", "a SECRET plan",
    "abcdefEND tail", "short", "x" * 40, "stop here STOP and more", "bob@example.org END",
    "ok but reject-me please", "tokens [1234, 5678, 91011] are not phones",
]
GUARD_CONFIGS = [
    {}, {"block": "forbidden,secret"}, {"scrub_pii": "0", "stop_tokens": "END", "max_chars": 4},
    {"stop_tokens": "STOP,END", "max_chars": 12}, {"block": "[unclosed"},
    {"classifier": "reject"},
]


def _classifier(text):
    return (False, "policy") if "reject" in text else (True, "")


def _apply_all(cls, err_cls, cfg):
    cfg = dict(cfg, classifier=_classifier) if "classifier" in cfg else cfg
    try:
        g = cls(**cfg)
    except err_cls as e:
        return [("config", str(e))]
    out = []
    for text in GUARD_CORPUS:
        try:
            out.append(g.apply(text))
        except err_cls as e:
            out.append(("error", str(e)))
    return out + [sorted(g.actions.items()), g.metrics(), g.DETERMINISTIC]


@pytest.mark.parametrize("cfg", GUARD_CONFIGS, ids=lambda c: ",".join(c) or "default")
def test_guardrail_equals_the_jax_unit(cfg):
    want = _apply_all(JaxGuardrail, JaxGraphUnitError, cfg)
    got = _apply_all(Guardrail, GraphUnitError, cfg)
    assert got == want
    assert len(got) > 1 or cfg.get("block") == "[unclosed"


def test_guardrail_payload_stages_and_qos_class_equal_the_jax_unit():
    for side, (cls, pmod, qos) in {"jax": (JaxGuardrail, jpayload, jqos),
                                   "torch": (Guardrail, None, tqos)}.items():
        P = pmod.Payload if pmod else Payload
        K = pmod.DataKind if pmod else DataKind
        g = cls(qos_class="batch")
        qos.set_priority("interactive")
        try:
            out = g.transform_input_raw(P("mail bob@example.com", [], K.STRING))
            assert out.data == "mail [REDACTED]" and qos.get_priority() == "batch", side
            numeric = P(np.array([[1, 2]]), [], K.NDARRAY)
            assert g.transform_output_raw(numeric) is numeric
            clean = P("clean", [], K.STRING)
            assert g.transform_output_raw(clean) is clean
        finally:
            qos.set_priority("interactive")


def test_qos_parsers_equal_the_jax_package():
    for v in (None, "", "0", "-5", "12.5", b"40", "inf", "nan", "abc", 7, 1e3):
        assert tqos.parse_deadline_ms(v) == jqos.parse_deadline_ms(v)
    for v in (None, "batch", " BATCH ", b"batch", "interactive", "bulk", 3):
        assert tqos.parse_priority(v) == jqos.parse_priority(v)
    for seed in ((None, None), ("250", "batch"), ("-1", "nope")):
        got, want = tqos.seed_from_headers(*seed), jqos.seed_from_headers(*seed)
        assert got == want
        assert (tqos.get_priority(), tqos.get_deadline() is None) == (
            jqos.get_priority(), jqos.get_deadline() is None)
        assert set(tqos.outgoing_qos_headers()) == set(jqos.outgoing_qos_headers())
    tqos.seed_from_headers(None, None)
    jqos.seed_from_headers(None, None)


# --------------------------------------------------------------------------
# the confidence signal and embeddings against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.Config.tiny(max_seq=64)
    return cfg, jparams, tcfg, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def _log_margins(model, log):
    """Record each fetched block's emitted mask and stashed margins."""
    fetch = model.step_k_fetch

    def logged(handle):
        toks, act = fetch(handle)
        log.append((np.asarray(act, bool), model.last_conf_seq))
        return toks, act

    model.step_k_fetch = logged


def _serve(sched, model, prompts, max_new):
    """One request after the other (one live slot): -> tokens, infos and
    each request's per-token margins."""
    log, out = [], []
    _log_margins(model, log)

    async def go():
        try:
            for p in prompts:
                info, start = {}, len(log)
                toks = await sched.submit(np.asarray(p, np.int32), max_new_tokens=max_new,
                                          info=info)
                margins = [m[a].tolist() if m is not None else None for a, m in log[start:]]
                out.append((toks.tolist(), info, margins))
        finally:
            await sched.close()

    asyncio.run(go())
    return out


SPEC = {"spec_draft": 2, "spec_method": "ngram"}


@pytest.mark.parametrize("spec", [{}, SPEC], ids=["greedy", "verify_ngram"])
def test_margins_and_confidence_equal_the_jax_scheduler(tiny, spec):
    cfg, jparams, tcfg, tparams = tiny
    jm = JaxModel(cfg, jparams, n_slots=2, seq_impl="flash", decode_block=4, decode_kernel=True,
                  conf_signal=True, **spec)
    want = _serve(JaxScheduler(jm, overlap=False), jm, PROMPTS, 11)
    tm = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, conf_signal=True,
                         device="cpu", **spec)
    got = _serve(GenerationScheduler(tm, overlap=False), tm, PROMPTS, 11)
    for (wt, wi, wm), (gt, gi, gm) in zip(want, got):
        assert gt == wt
        assert gi["conf_tokens"] == wi["conf_tokens"] == 10  # the first token has no margin
        assert abs(gi["confidence"] - wi["confidence"]) <= 1e-4
        flat_w = [x for blk in wm for x in blk]
        flat_g = [x for blk in gm for x in blk]
        assert len(flat_g) == len(flat_w) == 10
        np.testing.assert_allclose(flat_g, flat_w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("spec", [{}, SPEC], ids=["greedy", "verify_ngram"])
def test_conf_signal_changes_no_token_and_no_sync(tiny, spec):
    """The sequential loop (overlap off), as the JAX package's audit runs
    it: with the overlap on, how many blocks a wave takes depends on when
    the host gets to each sync point, which a loaded machine moves."""
    _, _, tcfg, tparams = tiny
    runs = {}
    for conf in (False, True):
        m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, conf_signal=conf,
                            device="cpu", **spec)
        sched = GenerationScheduler(m, overlap=False)

        async def go(sched=sched):
            try:
                return await asyncio.gather(*(sched.submit(np.asarray(p, np.int32),
                                                           max_new_tokens=13) for p in PROMPTS))
            finally:
                await sched.close()

        outs = [o.tolist() for o in asyncio.run(go())]
        runs[conf] = (outs, m.host_syncs, m.decode_blocks, m._program_config[-1])
        assert m.host_syncs == m.decode_blocks > 0
    assert runs[True][:3] == runs[False][:3]
    # the graph cache keys a block with the signal apart from one without
    assert (runs[True][3], runs[False][3]) == (True, False)


def test_component_reply_adds_only_confidence(tiny):
    _, _, tcfg, tparams = tiny
    body = json.dumps({"tokens": [[5, 9, 2], [7, 8]], "max_new_tokens": 5})
    replies = {}
    for conf in (False, True):
        comp = GenerativeComponent(GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4,
                                                   conf_signal=conf, device="cpu"))

        async def go(comp=comp):
            try:
                return (await comp.predict_raw(Payload(body, [], DataKind.STRING))).data
            finally:
                await comp.close()

        replies[conf] = json.loads(asyncio.run(go()))
    assert set(replies[True]) == {"tokens", "confidence"} and set(replies[False]) == {"tokens"}
    assert replies[True]["tokens"] == replies[False]["tokens"]
    assert len(replies[True]["confidence"]) == 2
    assert all(np.isfinite(c) and c >= 0 for c in replies[True]["confidence"])


def test_embed_pooled_equals_jax_and_ignores_the_bucket(tiny):
    cfg, jparams, tcfg, tparams = tiny
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 11).astype(np.int32)
    vecs = {}
    for bucket in (16, 32):
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :11] = prompt
        want = np.asarray(jl.embed_pooled(jparams, jnp.asarray(padded), 11, cfg))
        got = tl.embed_pooled(tparams, torch.from_numpy(padded), 11, tcfg).numpy()
        assert got.shape == (tcfg.hidden,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        vecs[bucket] = got
    np.testing.assert_allclose(vecs[16], vecs[32], rtol=1e-6, atol=0)


def test_embed_wave_is_one_fetch_and_takes_no_slot(tiny):
    _, _, tcfg, tparams = tiny
    m = GenerativeModel(tcfg, tparams, n_slots=2, decode_block=4, embed=True, device="cpu")
    assert m.warmup() == len(m._window_buckets()) + 2 * len(m.prefill_buckets)
    comp = GenerativeComponent(m)
    rows = [np.asarray(p, np.int32) for p in PROMPTS]

    async def go():
        try:
            gen = asyncio.create_task(comp.scheduler.submit(rows[0], max_new_tokens=9))
            vecs = await comp.embed_rows(rows)
            return vecs, await gen
        finally:
            await comp.close()

    free = m.free_block_count
    vecs, toks = asyncio.run(go())
    assert vecs.shape == (len(rows), tcfg.hidden) and len(toks) == 9
    assert (m.embeds, m.embed_fetches) == (len(rows), 1)
    for r, v in zip(rows, vecs):
        np.testing.assert_array_equal(v, m.embed(r))
    assert m.free_block_count == free


# --------------------------------------------------------------------------
# through the port's engine
# --------------------------------------------------------------------------


def _tier_cfgs(tiny):
    cfg, jparams, tcfg, _ = tiny
    out = {}
    for name, layers in (("small", 1), ("large", 2)):
        jc = dataclasses.replace(cfg, n_layers=layers)
        jp = jl.init_params(jax.random.PRNGKey(layers), jc)
        tc = dataclasses.replace(tcfg, n_layers=layers)
        out[name] = (jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp), tc))
    return out


def _cascade_graph(threshold):
    return {"name": "casc", "type": "CASCADE_ROUTER", "implementation": "CASCADE_ROUTER",
            "parameters": [{"name": "threshold", "value": str(threshold), "type": "FLOAT"}],
            "children": [{"name": "small", "type": "MODEL"}, {"name": "large", "type": "MODEL"}]}


def _http(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), headers=headers or {},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


async def _engine(graph, components=None):
    app = EngineApp(PredictionService(PredictorSpec.from_dict({"name": "p", "graph": graph}),
                                      device="cpu", components=components))
    await app.start("127.0.0.1", 0)
    await app.boot()
    return app


@pytest.mark.parametrize("threshold", [0.0, "inf"], ids=["ships_cheap", "escalates"])
def test_cascade_over_the_engine_equals_the_jax_walker(tiny, threshold):
    tiers = _tier_cfgs(tiny)
    body = {"strData": json.dumps({"tokens": PROMPTS[0], "max_new_tokens": 6})}

    def jax_comps():
        return {n: JaxComponent(JaxModel(jc, jp, n_slots=2, seq_impl="flash", decode_block=4,
                                         decode_kernel=True, conf_signal=True, name=n))
                for n, (jc, jp, _, _) in tiers.items()}

    async def jax_walk():
        w = JaxWalker(JaxUnitSpec.from_dict(_cascade_graph(threshold)), components=jax_comps())
        try:
            out = await w.predict(jpayload.Payload(body["strData"], [], jpayload.DataKind.STRING))
            return json.loads(out.data), out.meta
        finally:
            await w.aclose()

    want, jmeta = asyncio.run(jax_walk())

    async def port_walk():
        comps = {n: GenerativeComponent(GenerativeModel(tc, tp, n_slots=2, decode_block=4,
                                                        conf_signal=True, name=n, device="cpu"))
                 for n, (_, _, tc, tp) in tiers.items()}
        app = await _engine(_cascade_graph(threshold), comps)
        try:
            reply = await asyncio.to_thread(_http, app.port, "/api/v0.1/predictions", body)
            direct = {n: json.loads((await c.predict_raw(Payload(body["strData"], [],
                                                                  DataKind.STRING))).data)
                      for n, c in comps.items()}
            return reply, direct, app.service.walker.component
        finally:
            await app.close()

    (code, reply), direct, router = asyncio.run(port_walk())
    tier = 0 if threshold == 0.0 else 1
    got = json.loads(reply["strData"])
    assert code == 200 and reply["meta"]["routing"] == jmeta.routing == {"casc": tier}
    assert got == direct[["small", "large"][tier]]  # the tier's reply, unmodified
    assert got["tokens"] == want["tokens"]
    assert abs(got["confidence"] - want["confidence"]) <= 1e-4
    assert set(reply["meta"]["requestPath"]) == set(jmeta.request_path)
    assert abs(reply["meta"]["tags"]["cascade_confidence"]
               - jmeta.tags["cascade_confidence"]) <= 1e-4
    assert ([m["key"] for m in reply["meta"]["metrics"] if "cascade" in m["key"]]
            == [m.key for m in jmeta.metrics if "cascade" in m.key])
    assert (router.escalations, router.served_by_tier) == (tier, {tier: 1})


def _bandit_graph(embed):
    gen = [{"name": n, "value": v, "type": t} for n, v, t in (
        ("preset", "tiny", "STRING"), ("n_slots", "2", "INT"), ("decode_block", "4", "INT"),
        ("max_new_tokens", "4", "INT"), ("embed", str(embed).lower(), "BOOL"))]
    return {"name": "eg", "type": "ROUTER", "implementation": "EPSILON_GREEDY",
            "parameters": [{"name": "epsilon", "value": "0.8", "type": "FLOAT"},
                           {"name": "seed", "value": "7", "type": "INT"}],
            "children": [{"name": f"g{i}", "type": "MODEL", "implementation": "JAX_GENERATIVE",
                          "parameters": gen + [{"name": "rng", "value": str(i), "type": "INT"}]}
                         for i in range(2)]}


def test_feedback_and_embeddings_over_the_engine():
    from seldon_core_tpu_torch.graph.units import EpsilonGreedy

    async def go():
        app = await _engine(_bandit_graph(embed=True))
        bare = await _engine(_bandit_graph(embed=False))
        try:
            seen, ref = [], EpsilonGreedy(n_branches=2, epsilon=0.8, seed=7)
            for i in range(6):
                body = {"strData": json.dumps({"tokens": [5 + i, 9, 2]})}
                code, reply = await asyncio.to_thread(_http, app.port, "/api/v0.1/predictions",
                                                      body)
                assert code == 200
                branch = reply["meta"]["routing"]["eg"]
                seen.append((branch, ref.route(None, [])))
                reward = float(branch == 1)
                ref.send_feedback(None, [], reward, routing=seen[-1][1])
                path = ("/api/v0.1/feedback", "/api/v1.0/feedback")[i % 2]
                fb = await asyncio.to_thread(_http, app.port, path, {
                    "request": body, "response": reply, "reward": reward})
                assert fb == (200, {"status": {"code": 200, "status": "SUCCESS"}})
            bad = await asyncio.to_thread(_http, app.port, "/api/v0.1/feedback",
                                          {"reward": "lots"})
            emb = await asyncio.to_thread(_http, app.port, "/api/v0.1/embeddings",
                                          {"tokens": [[5, 9, 2], [1, 2, 3, 4]]})
            flat = await asyncio.to_thread(_http, app.port, "/api/v0.1/embeddings",
                                           {"strData": json.dumps({"tokens": [5, 9, 2]})})
            empty = await asyncio.to_thread(_http, app.port, "/api/v0.1/embeddings",
                                            {"tokens": []})
            none = await asyncio.to_thread(_http, bare.port, "/api/v0.1/embeddings",
                                           {"tokens": [5, 9, 2]})
            g0 = app.service.generative_units()[0]
            cfg = g0.model.cfg
            malformed = [await asyncio.to_thread(_http, app.port, "/api/v0.1/embeddings",
                                                 {"tokens": rows})
                         for rows in ([[5, 9, 2], []], [[5, cfg.vocab_size]], [[-1, 2]],
                                      [[1] * cfg.max_seq])]
            want = np.stack([g0.model.embed(np.asarray(r, np.int32))
                             for r in ([5, 9, 2], [1, 2, 3, 4])])
            router = app.service.walker.component
            return seen, bad, emb, flat, empty, none, malformed, want, router, cfg.hidden
        finally:
            await app.close()
            await bare.close()

    seen, bad, emb, flat, empty, none, malformed, want, router, hidden = asyncio.run(go())
    assert [a for a, _ in seen] == [b for _, b in seen]  # the host-only unit's sequence
    assert {a for a, _ in seen} == {0, 1}
    assert router.pulls.sum() == 6
    assert bad[0] == 400 and bad[1]["status"]["status"] == "FAILURE"
    code, body = emb
    raw = body["rawTensor"]
    vecs = np.frombuffer(base64.b64decode(raw["data"]), np.float32).reshape(raw["shape"])
    assert code == 200 and raw["dtype"] == "float32" and raw["shape"] == [2, hidden]
    np.testing.assert_array_equal(vecs, want)
    assert flat[0] == 200 and flat[1]["rawTensor"]["shape"] == [1, hidden]
    assert empty[0] == 400
    assert none[0] == 400 and "embed" in none[1]["status"]["info"]
    assert [code for code, _ in malformed] == [400] * 4

