"""The port's inference-graph walk against the JAX package's, on the CPU.

The same spec and the same numpy-seeded payloads go through the JAX
``GraphWalker`` and the port's (``seldon_core_tpu_torch/graph/walker.py``)
with each package's built-in units: replies and ``meta`` (tags, routing,
request path, metrics) must be equal, and a unit that fails must fail in
both.  Every case of ``tests/test_graph.py`` has a parity case here; the
routers' decision sequences under one seed, the feedback replay (the
routed path only), ``sct_trace_ms`` and the request-scoped QoS context
across the thread pool are pinned as well.
"""

import asyncio
import concurrent.futures

import numpy as np
import pytest

from seldon_core_tpu import qos as jqos
from seldon_core_tpu.contract import codec as jcodec
from seldon_core_tpu.contract import payload as jpayload
from seldon_core_tpu.executor.generation import GenerativeComponent as JaxGenerativeComponent
from seldon_core_tpu.graph import spec as jspec
from seldon_core_tpu.graph import units as junits
from seldon_core_tpu.graph import walker as jwalker
from seldon_core_tpu_torch import qos as tqos
from seldon_core_tpu_torch.contract import codec as tcodec
from seldon_core_tpu_torch.contract import payload as tpayload
from seldon_core_tpu_torch.executor.generation import GenerativeComponent
from seldon_core_tpu_torch.graph import spec as tspec
from seldon_core_tpu_torch.graph import units as tunits
from seldon_core_tpu_torch.graph import walker as twalker

run = asyncio.run

# package -> (walker module, payload module, codec, spec module, units)
SIDES = {
    "jax": (jwalker, jpayload, jcodec, jspec, junits),
    "torch": (twalker, tpayload, tcodec, tspec, tunits),
}


def _walker(side, graph, comps=None, **kw):
    w, _, _, s, _ = SIDES[side]
    if side == "torch":
        kw["device"] = "cpu"
    return w.GraphWalker(s.PredictiveUnitSpec.from_dict(graph), components=comps or {}, **kw)


def _payload(side, arr, names=None):
    return SIDES[side][1].Payload.from_array(np.asarray(arr, dtype=np.float64), names=names)


def _wire(side, out):
    """A reply as wire JSON without its puid, or the failure's class name."""
    if isinstance(out, Exception):
        return type(out).__name__
    d = SIDES[side][2].payload_to_dict(out)
    d["meta"].pop("puid", None)
    return d


async def _walk(w, p, trace=False):
    try:
        return await w.predict(p, trace=trace)
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return e


def _both(graph, inputs, comps=None):
    """Each input through a JAX walker and a port walker over ``graph``,
    one request after the other; -> (jax wires, torch wires)."""
    outs = {}
    for side in SIDES:
        w = _walker(side, graph, comps(side) if comps else None)
        outs[side] = [_wire(side, run(_walk(w, _payload(side, x)))) for x in inputs]
    return outs["jax"], outs["torch"]


def _rng_inputs(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(n)]


SIMPLE_GRAPH = {"name": "clf", "type": "MODEL", "implementation": "SIMPLE_MODEL"}
ABTEST_GRAPH = {
    "name": "ab", "type": "ROUTER", "implementation": "RANDOM_ABTEST",
    "parameters": [{"name": "ratioA", "value": "1.0", "type": "FLOAT"}],
    "children": [
        {"name": "model-a", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
        {"name": "model-b", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
    ],
}
COMBINER_GRAPH = {
    "name": "ens", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
    "children": [
        {"name": "m0", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
        {"name": "m1", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
    ],
}


def _bandit(impl, n=2, **params):
    types = {"n_branches": "INT", "epsilon": "FLOAT", "seed": "INT", "ratioA": "FLOAT"}
    return {
        "name": "r", "type": "ROUTER", "implementation": impl,
        "parameters": [{"name": k, "value": str(v), "type": types[k]}
                       for k, v in params.items()],
        "children": [{"name": f"m{i}", "type": "MODEL", "implementation": "SIMPLE_MODEL"}
                     for i in range(n)],
    }


# --------------------------------------------------------------------------
# user components shared by both walkers (each walker gets fresh instances)
# --------------------------------------------------------------------------


class Doubler:
    def transform_input(self, X, names):
        return X * 2

    def tags(self):
        return {"doubled": True}


class Halver:
    def transform_output(self, X, names):
        return X / 2


class BadRouter:
    def route(self, X, names):
        return 7


class AsyncModel:
    async def predict(self, X, names):
        await asyncio.sleep(0)
        return X + 1


def _raw_model(side):
    p = SIDES[side][1]

    class RawModel:
        def predict_raw(self, payload):
            return p.Payload.from_array(np.array([[42.0]]), kind=p.DataKind.TENSOR)

    return RawModel()


TRANSFORM_GRAPH = {
    "name": "t-in", "type": "TRANSFORMER",
    "children": [{"name": "t-out", "type": "OUTPUT_TRANSFORMER",
                  "children": [{"name": "m", "type": "MODEL",
                                "implementation": "SIMPLE_MODEL"}]}],
}
OUTLIER_GRAPH = {
    "name": "outlier", "type": "TRANSFORMER", "implementation": "MAHALANOBIS_OUTLIER",
    "children": [{"name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}],
}

# the walker cases of tests/test_graph.py::TestGraphWalker, as parity cases
WALK_CASES = {
    "single_model": (SIMPLE_GRAPH, None, [np.zeros((2, 4))]),
    "router_records_routing": (ABTEST_GRAPH, None, [np.zeros((1, 2))]),
    "router_bad_branch_raises": (ABTEST_GRAPH, lambda side: {"ab": BadRouter()},
                                 [np.zeros((1, 2))]),
    "combiner_fans_out_and_averages": (COMBINER_GRAPH, None, [np.zeros((2, 2))]),
    "multiple_children_without_combiner_raises": (
        {**COMBINER_GRAPH, "type": "MODEL", "implementation": "SIMPLE_MODEL", "name": "root"},
        None, [np.zeros((1, 2))]),
    "transformer_chain_and_tag_merge": (
        TRANSFORM_GRAPH, lambda side: {"t-in": Doubler(), "t-out": Halver()}, [np.ones((1, 2))]),
    "outlier_transformer_tags_scores": (OUTLIER_GRAPH, None, _rng_inputs(5, (4, 3), seed=1)),
    "async_component": ({"name": "am", "type": "MODEL"}, lambda side: {"am": AsyncModel()},
                        [np.zeros((1, 2))]),
    "raw_component_controls_payload": ({"name": "raw", "type": "MODEL"},
                                       lambda side: {"raw": _raw_model(side)},
                                       [np.zeros((1, 2))]),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_walker_parity(case):
    graph, comps, inputs = WALK_CASES[case]
    want, got = _both(graph, inputs, comps)
    assert got == want
    if case.endswith("raises"):
        assert got == ["GraphUnitError"] * len(inputs)
    else:
        assert all(isinstance(g, dict) for g in got)


# the unit cases of tests/test_graph.py::TestBuiltinUnits, as parity cases
def _unit_simple_model(u):
    return u.SimpleModel().predict(np.zeros((3, 4)), []).tolist()


def _unit_average_mean(u):
    return u.AverageCombiner().aggregate([np.array([[1.0, 2.0]]), np.array([[3.0, 4.0]])],
                                         [[], []]).tolist()


def _unit_average_mismatch(u):
    out = []
    for xs in ([np.ones((1, 2)), np.ones((2, 2))], []):
        try:
            u.AverageCombiner().aggregate(xs, [[] for _ in xs])
        except u.GraphUnitError as e:
            out.append(str(e))
    return out


def _unit_random_abtest(u):
    router = u.RandomABTest(ratioA=0.7, seed=1337)
    return [router.route(np.zeros((1, 1)), []) for _ in range(1000)]


def _bandit_seq(router, good, n, m=100):
    picks = []
    for _ in range(n):
        b = router.route(np.zeros((1, 1)), [])
        picks.append(b)
        router.send_feedback(None, [], reward=1.0 if b == good else 0.0, routing=b)
    return picks + [router.route(np.zeros((1, 1)), []) for _ in range(m)]


def _unit_epsilon_greedy(u):
    return _bandit_seq(u.EpsilonGreedy(n_branches=3, epsilon=0.1, seed=7), 2, 200)


def _unit_thompson(u):
    return _bandit_seq(u.ThompsonSampling(n_branches=2, seed=3), 1, 300)


def _unit_mahalanobis(u):
    det = u.MahalanobisOutlier()
    det.score(np.random.default_rng(0).normal(size=(200, 3)))
    scores = det.score(np.array([[50.0, 50.0, 50.0], [0.0, 0.0, 0.0]]))
    return scores.tolist(), det.tags()


UNIT_CASES = {
    "simple_model_constant_row_per_input": _unit_simple_model,
    "average_combiner_mean": _unit_average_mean,
    "average_combiner_shape_mismatch": _unit_average_mismatch,
    "random_abtest_distribution": _unit_random_abtest,
    "epsilon_greedy_learns_best_branch": _unit_epsilon_greedy,
    "thompson_sampling_learns": _unit_thompson,
    "mahalanobis_flags_outlier": _unit_mahalanobis,
}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_builtin_unit_parity(case):
    want, got = UNIT_CASES[case](junits), UNIT_CASES[case](tunits)
    assert got == want
    assert got  # the case did something


# the feedback cases of tests/test_graph.py::TestFeedbackWalk
EG_GRAPH = _bandit("EPSILON_GREEDY", n_branches=2, epsilon=0.0)


class FeedbackModel:
    def __init__(self):
        self.rewards = []

    def predict(self, X, names):
        return X

    def send_feedback(self, X, names, reward, truth=None, routing=None):
        self.rewards.append(reward)


def _feedback_case(name):
    """-> what the feedback walk left behind, per side."""
    out = {}
    for side in SIDES:
        _, pmod, codec, _, _ = SIDES[side]
        seen = []
        if name == "model_send_feedback_called_when_method_listed":
            model = FeedbackModel()
            w = _walker(side, {"name": "m", "type": "MODEL",
                               "methods": ["TRANSFORM_INPUT", "SEND_FEEDBACK"]}, {"m": model})
        else:
            w = _walker(side, EG_GRAPH,
                        feedback_hook=lambda n, fb, seen=seen: seen.append((n, fb.reward)))
        req = _payload(side, np.zeros((1, 2)))
        resp = run(w.predict(req))
        reward = {"feedback_hook_fires": 0.5}.get(name, 2.0 if "model" in name else 1.0)
        run(w.send_feedback(pmod.FeedbackPayload(request=req, response=resp, reward=reward)))
        if name == "model_send_feedback_called_when_method_listed":
            out[side] = model.rewards
        else:
            router = w.root.client.component
            out[side] = (resp.meta.routing, router.pulls.tolist(), router.value.tolist(), seen)
    return out


@pytest.mark.parametrize("case", ["feedback_reaches_router_on_routed_path",
                                  "feedback_hook_fires",
                                  "model_send_feedback_called_when_method_listed"])
def test_feedback_walk_parity(case):
    out = _feedback_case(case)
    assert out["torch"] == out["jax"]
    if case == "model_send_feedback_called_when_method_listed":
        assert out["torch"] == [2.0]
    else:
        routing, pulls, value, seen = out["torch"]
        assert sum(pulls) == 1 and value[routing["r"]] == (0.5 if "hook" in case else 1.0)
        assert seen == [("r", 0.5 if "hook" in case else 1.0)]


# the annotation-lock and inline cases of tests/test_graph.py
class LikeAModelUnit:
    def predict(self, X, names):
        return X


class DuckTags:
    def predict(self, X, names):
        return X

    def tags(self):
        return {"k": 1}


class MetricsOnly:
    def predict(self, X, names):
        return X

    def metrics(self):
        return [{"key": "per_request_value", "value": 1.0}]


def _lock_and_inline(side, case):
    w, _, _, s, u = SIDES[side]
    comps = {
        "jax_component_not_serialized": lambda: type("Unit", (u.SeldonComponent,),
                                                     {"predict": LikeAModelUnit.predict})(),
        "stateful_tags_serialized": u.MahalanobisOutlier,
        "duck_typed_tags_serialized": DuckTags,
        "stateful_metrics_serialized_unless_opted_out": MetricsOnly,
        "builtin_is_inline": u.SimpleModel,
        "user_subclass_falls_back_to_thread_pool": lambda: type(
            "MySlowModel", (u.SimpleModel,), {"predict": LikeAModelUnit.predict})(),
    }
    client = w.LocalClient(s.PredictiveUnitSpec(name="m", type=s.UnitType.MODEL), comps[case]())
    return client._tag_lock is not None, client._inline


@pytest.mark.parametrize("case", ["jax_component_not_serialized", "stateful_tags_serialized",
                                  "duck_typed_tags_serialized",
                                  "stateful_metrics_serialized_unless_opted_out",
                                  "builtin_is_inline", "user_subclass_falls_back_to_thread_pool"])
def test_annotation_lock_and_inline_scope_parity(case):
    want = _lock_and_inline("jax", case)
    assert _lock_and_inline("torch", case) == want
    locked = case in ("stateful_tags_serialized", "duck_typed_tags_serialized",
                      "stateful_metrics_serialized_unless_opted_out")
    assert want == (locked, case == "builtin_is_inline")
    # the generative units opt out of the lock: their gauges tolerate races
    assert GenerativeComponent.SAFE_ANNOTATIONS is JaxGenerativeComponent.SAFE_ANNOTATIONS is True


# --------------------------------------------------------------------------
# beyond tests/test_graph.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,params", [
    ("RANDOM_ABTEST", {"ratioA": 0.4, "seed": 11}),
    ("EPSILON_GREEDY", {"n_branches": 3, "epsilon": 0.3, "seed": 5}),
    ("THOMPSON_SAMPLING", {"n_branches": 3, "seed": 2}),
    ("SIMPLE_ROUTER", {}),
])
def test_router_decisions_under_feedback_equal_over_a_sequence(impl, params):
    """A bandit walked 40 times, each reply fed back (reward 1 on branch 1):
    the same routing sequence, the same replies and metas."""
    n = params.get("n_branches", 2)
    graph = _bandit(impl, n=n, **params)
    seqs = {}
    for side in SIDES:
        pmod = SIDES[side][1]
        w = _walker(side, graph)
        seq = []
        for x in _rng_inputs(40, (1, 3), seed=4):
            req = _payload(side, x)
            resp = run(w.predict(req))
            seq.append(_wire(side, resp))
            reward = 1.0 if resp.meta.routing["r"] == 1 else 0.0
            run(w.send_feedback(pmod.FeedbackPayload(request=req, response=resp, reward=reward)))
        seqs[side] = seq
    assert seqs["torch"] == seqs["jax"]
    branches = {d["meta"]["routing"]["r"] for d in seqs["torch"]}
    assert branches == ({0} if impl == "SIMPLE_ROUTER" else set(range(n)))


def test_feedback_replays_only_the_routed_path():
    """Nested bandits: the outer router's choice names the subtree the
    feedback walk enters; the bandit in the other subtree gets nothing."""
    inner = [_bandit("EPSILON_GREEDY", n_branches=2, epsilon=1.0, seed=i) for i in (1, 2)]
    for i, g in enumerate(inner):
        g["name"] = f"inner{i}"
        for c in g["children"]:
            c["name"] = f"{g['name']}-{c['name']}"
    graph = {**_bandit("RANDOM_ABTEST", ratioA=0.5, seed=3), "children": inner}
    ledgers = {}
    for side in SIDES:
        pmod = SIDES[side][1]
        w = _walker(side, graph)
        comps = dict(w.iter_components())
        routes = []
        for x in _rng_inputs(12, (1, 2), seed=9):
            req = _payload(side, x)
            resp = run(w.predict(req))
            routes.append(dict(resp.meta.routing))
            run(w.send_feedback(pmod.FeedbackPayload(request=req, response=resp, reward=1.0)))
        ledgers[side] = (routes, [comps[f"inner{i}"].pulls.tolist() for i in (0, 1)])
    assert ledgers["torch"] == ledgers["jax"]
    routes, pulls = ledgers["torch"]
    for i in (0, 1):  # each inner bandit learned exactly the requests routed to it
        assert sum(pulls[i]) == sum(r["r"] == i for r in routes) > 0
        assert all(set(r) == {"r", f"inner{r['r']}"} for r in routes)


def test_trace_writes_node_times_for_the_walked_path():
    keys = {}
    for side in SIDES:
        w = _walker(side, ABTEST_GRAPH)
        out = run(w.predict(_payload(side, np.zeros((1, 2))), trace=True))
        trace = out.meta.tags["sct_trace_ms"]
        assert all(isinstance(v, float) and v >= 0 for v in trace.values())
        keys[side] = sorted(trace)
    assert keys["torch"] == keys["jax"] == ["ab", "model-a"]


def test_feedback_codec_matches_the_jax_codec():
    msg = {"request": {"data": {"ndarray": [[1.0, 2.0]]}},
           "response": {"meta": {"puid": "p", "routing": {"r": 1}, "tags": {"t": 1}},
                        "data": {"names": ["a"], "ndarray": [[0.5]]}},
           "reward": 0.75, "truth": {"data": {"tensor": {"shape": [1], "values": [1.0]}}}}
    j, t = jcodec.feedback_from_dict(msg), tcodec.feedback_from_dict(msg)
    assert t.response.meta.routing == j.response.meta.routing == {"r": 1}
    assert tcodec.feedback_to_dict(t) == jcodec.feedback_to_dict(j)
    with pytest.raises(tcodec.CodecError):
        tcodec.feedback_from_dict({"reward": "lots"})


class ReadsPriority:
    """A sync unit that reports the request's QoS priority (1 = batch)."""

    def __init__(self, qos):
        self.qos = qos

    def predict(self, X, names):
        return np.full((1, 1), float(self.qos.get_priority() == "batch"))


class InlineReadsPriority(ReadsPriority):
    INLINE_SYNC = True


def _priority_walk(side):
    """GUARDRAIL (``qos_class=batch``, not inline: it runs on the thread
    pool) -> an inline unit reading the priority; then, in a fresh
    request, a pool unit reading the priority.  One pool thread, so the
    second read lands on the thread the guardrail ran on."""
    qos = jqos if side == "jax" else tqos
    guard = {"name": "guard", "type": "GUARDRAIL", "implementation": "GUARDRAIL",
             "parameters": [{"name": "qos_class", "value": "batch", "type": "STRING"}],
             "children": [{"name": "m", "type": "MODEL"}]}

    async def go():
        asyncio.get_running_loop().set_default_executor(
            concurrent.futures.ThreadPoolExecutor(max_workers=1))
        qos.seed_from_headers(None, None)
        w = _walker(side, guard, {"m": InlineReadsPriority(qos)})
        down = (await w.predict(_payload(side, np.zeros((1, 1))))).array

        async def later():  # a later request, its own context, seeded at ingress
            qos.seed_from_headers(None, None)
            w2 = _walker(side, {"name": "m", "type": "MODEL"}, {"m": ReadsPriority(qos)})
            return (await w2.predict(_payload(side, np.zeros((1, 1))))).array, qos.get_priority()

        return float(down[0, 0]), await asyncio.create_task(later())

    return run(go())


def test_guardrail_priority_across_the_thread_pool():
    """The JAX walker runs a non-inline sync unit through
    ``loop.run_in_executor``, which does not carry the request's context:
    the guardrail's ``qos.set_priority`` lands in the pool thread's own
    context, the unit downstream still reads ``interactive``, and a later
    request's pool unit on that thread reads ``batch`` (a fault of the
    reference, ROADMAP C3).  The port runs the unit in a copy of the
    request's context and writes its changes back: downstream reads
    ``batch``, the later request ``interactive``."""
    down, (later, ingress) = _priority_walk("jax")
    assert (down, float(later[0, 0]), ingress) == (0.0, 1.0, "interactive")
    down, (later, ingress) = _priority_walk("torch")
    assert (down, float(later[0, 0]), ingress) == (1.0, 0.0, "interactive")


def test_cascade_deadline_is_read_inline_and_reset_per_request():
    """The cascade router runs inline, so the deadline seeded at ingress
    gates escalation; a request without the header resets it."""
    from seldon_core_tpu_torch.graphllm import CascadeRouter

    r = CascadeRouter(threshold=2.0, ttft_ms=50.0)
    assert type(r).__dict__.get("INLINE_SYNC") is True

    async def decide(header):
        tqos.seed_from_headers(header, None)
        return r.decide(0.1, 0, 2)

    async def go():
        return [await decide("10"), await decide(None), await decide("5000")]

    assert run(go()) == [(False, "deadline-budget"), (True, "low-confidence"),
                         (True, "low-confidence")]
