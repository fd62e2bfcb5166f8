"""The port's Prometheus registry (``utils/metrics.py``, no
``prometheus_client``) against the JAX package's on the CPU.

* the same 82 families: names, types, help, label names, histogram buckets;
* one scripted sequence of calls into a fresh JAX ``MetricsRegistry`` and a
  fresh port registry gives equal parsed expositions (``_created`` aside,
  which the port does not write), in the text format 0.0.4 and in
  OpenMetrics with trace-id exemplars (``SCT_METRICS_EXEMPLARS``);
* ``record_custom`` with the reference's COUNTER, GAUGE and TIMER,
  ``adapter_label``'s rollup, ``refresh_usage`` from equal meters,
  ``time_server_request``'s status codes;
* the same greedy wave on the JAX engine and the port's engine (``tiny``,
  float32) moves the same families, with equal request, token and
  time-to-first-token counts.

Sample values are compared exactly: both registries hold the same float
for the same call, and both expositions parse to it.
"""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest
from prometheus_client import CollectorRegistry
from prometheus_client.openmetrics.parser import text_string_to_metric_families as om_parse
from prometheus_client.parser import text_string_to_metric_families as text_parse

from seldon_core_tpu.contract.payload import Metric as JaxMetric
from seldon_core_tpu.obs.metering import UsageMeter as JaxMeter
from seldon_core_tpu.utils import metrics as jm
from seldon_core_tpu_torch.contract.payload import Metric
from seldon_core_tpu_torch.obs.metering import UsageMeter
from seldon_core_tpu_torch.utils import metrics as tm

TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"


def _jax():
    return jm.MetricsRegistry(CollectorRegistry())


def _families(text: str, parse) -> dict:
    """{family: (type, help, sorted samples)}, ``_created`` left out."""
    out = {}
    for f in parse(text):
        if f.name.endswith("_created"):
            continue
        samples = []
        for s in f.samples:
            if s.name.endswith("_created"):
                continue
            ex = (s.exemplar.labels, s.exemplar.value) if s.exemplar else None
            samples.append((s.name, tuple(sorted(s.labels.items())), s.value, ex))
        out[f.name] = (f.type, f.documentation, sorted(samples, key=repr))
    return out


def _script(r, observe_exemplar, metric_cls):
    """One sequence of calls, the same on either registry."""
    r.server_requests.labels("dep", "pred", "predictions", "POST", "200").observe(0.003)
    r.server_requests.labels("dep", "pred", "predictions", "POST", "429").observe(12.5)
    r.feedback.labels("dep", "pred", "m").inc()
    r.feedback_reward.labels("dep", "pred", "m").inc(0.5)
    r.batch_size.labels("m").observe(3)
    r.batch_size.labels("m").observe(300)
    r.queue_depth.labels("m").set(4)
    observe_exemplar(r.ttft.labels("m"), 0.02, TRACE)
    observe_exemplar(r.ttft.labels("m"), 3.0, None)
    r.itl.labels("m").observe(0.0004)
    r.generated_tokens.labels("m").inc(7)
    r.qos_admitted.labels("dep", "interactive").inc(2)
    r.qos_shed.labels("dep", "queue-full", "batch").inc()
    r.qos_deadline_miss.labels("m", "decode").inc()
    r.wire_bytes.labels("engine-rest", "dep", "in").inc(123456789)
    r.wire_mb_s.labels("engine-rest", "dep").set(1234567.25)
    r.mfu.labels("m").set(0.25)
    r.kv_blocks.labels("m", "free").set(10)
    r.semcache_entries.set(2)
    r.usage_meter_keys.set(1)
    r.spec_accepted_per_step_by_method.labels("m", "ngram").set(1.5)
    r.lora_tokens.labels("m", r.adapter_label("alpha")).inc(3)
    r.eventloop_lag.labels("engine").set(1e-5)
    r.obs_spans.labels("recorded").set_function(lambda: 5)
    r.record_custom("dep", "pred", "m", [metric_cls("hits", "COUNTER", 2.0),
                                         metric_cls("temp", "GAUGE", 21.5),
                                         metric_cls("lat", "TIMER", 250.0)])


def test_the_same_families_names_types_help_labels_and_buckets():
    j = _jax()
    t = tm.MetricsRegistry()
    jfam = {m._name: m for m in j.registry._collector_to_names}
    assert len(t.families) == len(jfam) == 82
    for fam in t.families:
        m = jfam[fam.name]
        assert m._type == fam.kind, fam.name
        assert m._documentation == fam.documentation, fam.name
        assert tuple(m._labelnames) == fam.labelnames, fam.name
        if fam.kind == "histogram":
            assert tuple(m._upper_bounds) == fam.bounds, fam.name
    assert tm._BUCKETS == jm._BUCKETS


@pytest.mark.parametrize("fmt", ["text-0.0.4", "openmetrics-exemplars"])
def test_a_scripted_sequence_exposes_equal_samples(fmt, monkeypatch):
    om = fmt != "text-0.0.4"
    monkeypatch.setenv("SCT_METRICS_EXEMPLARS", "1" if om else "0")
    j, t = _jax(), tm.MetricsRegistry()
    _script(j, jm.observe_exemplar, JaxMetric)
    _script(t, tm.observe_exemplar, Metric)
    assert t.expose_content_type() == j.expose_content_type()
    parse = om_parse if om else text_parse
    want = _families(j.expose().decode(), parse)
    got = _families(t.expose().decode(), parse)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name
    if om:
        ttft = got["seldon_generative_ttft_seconds"][2]
        assert [s[3] for s in ttft if s[3]] == [({"trace_id": TRACE}, 0.02)]


def test_record_custom_counter_gauge_timer():
    t = tm.MetricsRegistry()
    for _ in range(2):
        t.record_custom("d", "p", "m", [Metric("c", "COUNTER", 1.5), Metric("g", "GAUGE", 3.0),
                                        Metric("t", "TIMER", 20.0)])
    assert t.custom_counter.labels("d", "p", "m", "c").get() == 3.0
    assert t.custom_gauge.labels("d", "p", "m", "g").get() == 3.0
    counts, total, _ = t.custom_timer.labels("d", "p", "m", "t").snapshot()
    assert sum(counts) == 2 and total == pytest.approx(0.04, abs=1e-12)
    with pytest.raises(ValueError):
        t.custom_counter.labels("d", "p", "m", "c").inc(-1)


def test_adapter_label_rolls_up_past_the_cap(monkeypatch):
    monkeypatch.setenv("SCT_METER_ADAPTER_LABELS", "2")
    j, t = _jax(), tm.MetricsRegistry()
    names = ["a", "b", "c", "", "a", "d"]
    assert [t.adapter_label(n) for n in names] == [j.adapter_label(n) for n in names]
    assert t.adapter_rollups == j.adapter_rollups == 2


def test_refresh_usage_from_equal_meters_exposes_equal_samples():
    j, t = _jax(), tm.MetricsRegistry()
    jmeter = JaxMeter(max_keys=3, top_k=2, enabled=True)
    tmeter = UsageMeter(max_keys=3, top_k=2, enabled=True)
    adds = [("a", "", "interactive", {"device_s": 0.5, "tokens_prefill": 10}),
            ("b", "x", "batch", {"device_s": 0.25, "tokens_decode": 4, "grant_s": 1.0}),
            ("c", "", "batch", {"device_s": 2.0, "requests_completed": 1}),
            ("d", "", "", {"requests_shed": 1, "suspend_byte_s": 7.0}),
            ("a", "", "interactive", {"tokens_saved_hbm": 16})]
    for dep, ad, q, f in adds:
        jmeter.add(dep, ad, q, **f)
        tmeter.add(dep, ad, q, **f)
    assert tmeter.export_rows() == jmeter.export_rows()
    j.refresh_usage(jmeter)
    t.refresh_usage(tmeter)
    want = _families(j.expose().decode(), text_parse)
    got = _families(t.expose().decode(), text_parse)
    usage = [n for n in want if n.startswith("seldon_usage")]
    assert usage and all(got[n] == want[n] for n in usage)


def test_time_server_request_observes_the_code_the_caller_sets():
    t = tm.MetricsRegistry()
    with t.time_server_request("d", "p", "predictions", "POST") as h:
        h["code"] = "429"
    with t.time_server_request("d", "p", "predictions", "POST"):
        pass
    for code in ("200", "429"):
        counts, _, _ = t.server_requests.labels("d", "p", "predictions", "POST", code).snapshot()
        assert sum(counts) == 1


def test_concurrent_increments_are_not_lost():
    t = tm.MetricsRegistry()
    c = t.generated_tokens.labels("m")
    h = t.device_step.labels("m")

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.get() == 16000
    assert sum(h.snapshot()[0]) == 16000


# --------------------------------------------------------------- the engines

WAVE = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4], [11, 12, 13, 14, 15, 16]]
UNIT = "metrics-wave"
DEP = "mw"
MODEL = "llama:tiny"  # both packages label a generative unit's model family:preset


def _gen_spec():
    p = lambda n, v, t="STRING": {"name": n, "value": str(v), "type": t}  # noqa: E731
    return {"name": DEP, "graph": {
        "name": UNIT, "type": "MODEL", "implementation": "JAX_GENERATIVE",
        "parameters": [p("preset", "tiny"), p("n_slots", 2, "INT"),
                       p("max_new_tokens", 6, "INT"), p("decode_block", 4, "INT")]}}


def _ours(text: str) -> dict:
    """The wave's series: ``{(sample, labels): value}`` whose labels name
    the wave's deployment, unit or model."""
    out = {}
    for f in text_parse(text):
        for s in f.samples:
            if s.name.endswith("_created"):
                continue
            if {DEP, UNIT, MODEL} & set(s.labels.values()):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _moved(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k)}


def _family(sample: str) -> str:
    for suffix in ("_bucket", "_count", "_sum", "_total"):
        if sample.endswith(suffix):
            return sample[: -len(suffix)]
    return sample


def _jax_wave():
    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.engine.app import EngineApp as JaxEngine
    from seldon_core_tpu.engine.service import PredictionService as JaxService
    from seldon_core_tpu.graph.spec import PredictorSpec as JaxSpec

    async def go():
        client = TestClient(TestServer(JaxEngine(JaxService(JaxSpec.model_validate(
            _gen_spec()))).build()))
        await client.start_server()
        try:
            before = _ours(await (await client.get("/prometheus")).text())
            toks = 0
            for prompt in WAVE:
                r = await client.post("/api/v0.1/predictions",
                                      json={"strData": json.dumps({"tokens": prompt})})
                assert r.status == 200
                toks += len(json.loads(json.loads(await r.read())["strData"])["tokens"])
            after = _ours(await (await client.get("/prometheus")).text())
            return _moved(before, after), toks
        finally:
            await client.close()

    return asyncio.run(go())


def _port_wave():
    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.read().decode()

    def post(port, prompt):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/v0.1/predictions",
            data=json.dumps({"strData": json.dumps({"tokens": prompt})}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return len(json.loads(json.loads(r.read())["strData"])["tokens"])

    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(_gen_spec()), device="cpu"))
        await app.start("127.0.0.1", 0)
        try:
            await app.boot()
            before = _ours(await asyncio.to_thread(get, app.port, "/prometheus"))
            toks = 0
            for prompt in WAVE:
                toks += await asyncio.to_thread(post, app.port, prompt)
            after = _ours(await asyncio.to_thread(get, app.port, "/prometheus"))
            return _moved(before, after), toks
        finally:
            await app.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def waves():
    return _jax_wave(), _port_wave()


def test_the_same_wave_moves_the_same_families(waves):
    (jmoved, _), (tmoved, _) = waves
    # left out, for a reason each: the JAX wave compiles XLA programs
    # mid-traffic (its warmup covers the buckets, not every decode window),
    # which a captured CUDA graph on the card or the CPU's eager body never
    # does; the pool's occupancy gauges are refreshed at the scrape, and
    # whether they moved depends on what the warmup left reserved and on
    # when the last release landed, in both packages
    pool = {"seldon_kv_blocks", "seldon_kv_blocks_high_water"}
    jfam = {_family(k[0]) for k in jmoved} - {"seldon_program_compiles"} - pool
    tfam = {_family(k[0]) for k in tmoved} - pool
    assert tfam == jfam
    assert {"seldon_generative_ttft_seconds", "seldon_executor_host_syncs",
            "seldon_wire_bytes", "seldon_executor_device_step_seconds"} <= tfam


def test_the_same_wave_counts_equal_requests_tokens_and_first_tokens(waves):
    (jmoved, jtoks), (tmoved, ttoks) = waves
    assert jtoks == ttoks > 0

    def pick(moved, sample, **labels):
        return sum(v for (name, lab), v in moved.items()
                   if name == sample and all(dict(lab).get(k) == x for k, x in labels.items()))

    for moved in (jmoved, tmoved):
        assert pick(moved, "seldon_api_engine_server_requests_duration_seconds_count",
                    service="predictions", code="200") == len(WAVE)
        assert pick(moved, "seldon_generative_tokens_total") == jtoks
        assert pick(moved, "seldon_generative_ttft_seconds_count") == len(WAVE)
        assert pick(moved, "seldon_qos_admitted_total") == len(WAVE)
    # the same requests and request bodies cross the front (the replies
    # differ: the first scrape's body lands in the window); host syncs and
    # inter-token samples count decode blocks, whose number each
    # scheduler's pipeline decides
    assert pick(tmoved, "seldon_wire_requests_total") == pick(jmoved, "seldon_wire_requests_total")
    assert (pick(tmoved, "seldon_wire_bytes_total", direction="in")
            == pick(jmoved, "seldon_wire_bytes_total", direction="in") > 0)
    assert pick(tmoved, "seldon_executor_host_syncs_total") > 0


def test_exposition_is_utf8_text_with_one_help_and_type_a_family():
    t = tm.MetricsRegistry()
    body = t.expose().decode("utf-8")
    helps = [ln.split()[2] for ln in body.splitlines() if ln.startswith("# HELP")]
    types = [ln.split()[2] for ln in body.splitlines() if ln.startswith("# TYPE")]
    assert helps == types and len(set(helps)) == 82
    assert np.all([not ln.startswith("#") or ln.startswith(("# HELP", "# TYPE"))
                   for ln in body.splitlines()])


# sct: test-hygiene-ok one short import probe in a fresh interpreter, no server or device
def test_the_telemetry_modules_import_without_prometheus_client_aiohttp_or_cuda():
    """Each module of the plane imports in a fresh interpreter with none of
    the packages the card lacks, and touches no CUDA."""
    import subprocess
    import sys

    modules = ["seldon_core_tpu_torch.utils.metrics", "seldon_core_tpu_torch.utils.roofline",
               "seldon_core_tpu_torch.obs.wire", "seldon_core_tpu_torch.obs.probes",
               "seldon_core_tpu_torch.obs.timeline", "seldon_core_tpu_torch.obs.export",
               "seldon_core_tpu_torch.testing.loadtest", "seldon_core_tpu_torch.engine.app"]
    probe = (
        "import sys, importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('prometheus_client', 'aiohttp', 'jax', 'seldon_core_tpu')"
        " if m in sys.modules]\n"
        "import torch\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
