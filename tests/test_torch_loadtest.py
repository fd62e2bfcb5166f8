"""The port's load harness (``testing/loadtest.py``) and roofline
(``utils/roofline.py``) on the CPU, against the JAX package.

* the log-binned histogram: the same edges and percentiles over the same
  samples; the diurnal trace generator: the same requests for the same
  seed, the same rate curve and series;
* a two-process run (``spawn``) against the port's engine counts the
  requests and request and reply bytes the engine's ``engine-rest`` wire
  edge counted, and every reply's trace id;
* the roofline's FLOPs: the tiny MLP's are the analytic 2 x MACs exactly;
  every zoo family's lie within a stated band of the JAX package's
  ``xla_flops`` of the same model at the same shape; the two kernels'
  formulas equal FlopCounterMode's count of their plain versions, and a
  wrapper counts its formula once on either route;
* the peak table names the H100 and knows no CPU; the CLIs run.
"""

import asyncio
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from seldon_core_tpu.executor import BucketSpec as JaxBucketSpec
from seldon_core_tpu.models import registry as jregistry
from seldon_core_tpu.testing import loadtest as jlt
from seldon_core_tpu.utils.roofline import xla_flops
from seldon_core_tpu_torch.engine.app import EngineApp
from seldon_core_tpu_torch.engine.service import PredictionService
from seldon_core_tpu_torch.graph.spec import PredictorSpec
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.obs import WIRE
from seldon_core_tpu_torch.ops import _flops
from seldon_core_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from seldon_core_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from seldon_core_tpu_torch.testing import loadtest as lt
from seldon_core_tpu_torch.utils import roofline

# ---------------------------------------------------------------- histogram


def test_bins_and_percentiles_equal_the_jax_harness():
    assert np.array_equal(lt._BIN_EDGES, jlt._BIN_EDGES)
    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.lognormal(-5, 1.5, 4000), [0.0, 1e-6, 49.9, 80.0]])
    h, jh = lt._histogram(), jlt._histogram()
    for s in samples:
        lt._record(h, float(s))
        jlt._record(jh, float(s))
    assert np.array_equal(h, jh)
    for q in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert lt._percentile(h, q) == jlt._percentile(jh, q), q
    assert lt._percentile(lt._histogram(), 50) == 0.0
    # merging histograms is adding them
    a, b = lt._histogram(), lt._histogram()
    for s in samples[:2000]:
        lt._record(a, float(s))
    for s in samples[2000:]:
        lt._record(b, float(s))
    assert np.array_equal(a + b, h)


@pytest.mark.parametrize("seed", [0, 7])
def test_the_trace_generator_equals_the_jax_generator(seed):
    kw = dict(duration_s=600.0, base_rps=0.5, peak_rps=4.0, prefix_population=64, seed=seed)
    cfg, jcfg = lt.TraceConfig(**kw), jlt.TraceConfig(**kw)
    trace, jtrace = lt.generate_trace(cfg), jlt.generate_trace(jcfg)
    assert [tuple(vars(r).values()) for r in trace] == [tuple(vars(r).values()) for r in jtrace]
    assert len(trace) > 100
    assert lt.trace_rate_series(cfg, trace, 60.0) == jlt.trace_rate_series(jcfg, jtrace, 60.0)
    for t in (0.0, 100.0, 330.0, 599.0):
        assert lt.diurnal_rate(cfg, t) == jlt.diurnal_rate(jcfg, t)


def test_the_default_payload_equals_the_jax_one():
    assert lt.default_rest_payload(3, 4) == jlt.default_rest_payload(3, 4)


# --------------------------------------------------------------- the harness

SIMPLE = {"name": "loaddep", "graph": {"name": "m", "type": "MODEL",
                                       "implementation": "SIMPLE_MODEL"}}


def test_a_two_process_run_counts_what_the_engine_counted():
    payloads = [json.dumps({"data": {"ndarray": [[float(i)] * (i + 1)]}}).encode()
                for i in range(8)]

    async def go():
        app = EngineApp(PredictionService(PredictorSpec.from_dict(SIMPLE), device="cpu"))
        await app.start("127.0.0.1", 0)
        await app.boot()
        wire = WIRE.counter("engine-rest", "loaddep")
        base = (wire.requests, wire.bytes_in, wire.bytes_out)
        try:
            res = await asyncio.to_thread(
                lt.run_load, f"http://127.0.0.1:{app.port}/api/v0.1/predictions", payloads,
                processes=2, concurrency=2, once=True)
        finally:
            await app.close()
        return res, (wire.requests - base[0], wire.bytes_in - base[1],
                     wire.bytes_out - base[2])

    res, (reqs, b_in, b_out) = asyncio.run(go())
    assert res.requests == 8 and res.failures == 0
    assert (reqs, b_in, b_out) == (8, res.bytes_sent, res.bytes_received)
    assert res.bytes_sent == sum(len(p) for p in payloads)
    assert len(res.trace_ids) == 8 and len(set(res.trace_ids)) == 8
    assert int(res.hist.sum()) == 8 and res.percentile_ms(50) > 0
    # each payload's reply, in payload order: SIMPLE_MODEL scores each row
    assert [len(json.loads(r)["data"]["ndarray"]) for r in res.replies] == [1] * 8
    assert all(json.loads(r)["data"]["ndarray"][0] == [0.1, 0.9, 0.5] for r in res.replies)
    s = res.summary()
    assert s["requests"] == 8 and s["bytes_sent"] == res.bytes_sent


def test_grpc_and_contract_payloads_raise_by_name():
    # the h2 gRPC worker is served since the gRPC slice; the grpcio client is not
    with pytest.raises(NotImplementedError, match="gRPC"):
        lt.run_load("127.0.0.1:5001", [b""], grpc=True, grpc_lib="grpcio")
    with pytest.raises(NotImplementedError, match="gRPC"):
        lt.main(["127.0.0.1:5001", "--grpc", "--grpc-lib", "grpcio"])
    with pytest.raises(NotImplementedError, match="contract"):
        lt.main(["http://127.0.0.1:1/x", "--contract", "c.json"])


# ------------------------------------------------------------------ roofline


def test_the_tiny_mlps_flops_are_twice_its_macs():
    cfg = registry.resolve_family_config("mlp", "tiny")
    out = roofline.model_roofline("mlp", preset="tiny", batch=4, dtype=None, iters=2,
                                  device="cpu")
    widths = [cfg.in_features] + [cfg.hidden] * cfg.n_layers + [cfg.n_classes]
    macs = sum(a * b for a, b in zip(widths, widths[1:]))
    assert out["flops_per_step"] == 2 * macs * 4 and out["flops_per_row"] == 2 * macs
    assert out["mfu"] is None and out["peak_tflops"] is None
    assert out["device_s_per_step"] > 0 and out["kernel_flops"] == {}


# port FLOPs / XLA FLOPs at batch 2, and why they are not 1: XLA's cost
# model also counts every elementwise op (activations, normalization,
# softmax, residual adds), and counts only the convolution taps that land
# inside the image (the SAME padding's zeros are free), while
# FlopCounterMode counts the matmuls and convolutions alone, padding
# included.  Measured on this package's tiny configs: mlp 0.958 (biases and
# relu), cnn 1.948 (5x5 SAME convolutions over 8x8 and 4x4 maps: about half
# of the taps are padding), resnet 1.041, bert 0.778 (layer norms, GELU,
# softmax).
FLOP_BANDS = {"mlp": (0.9, 1.0), "cnn": (1.5, 2.1), "resnet": (0.9, 1.2), "bert": (0.6, 1.0)}


@pytest.mark.parametrize("family", sorted(FLOP_BANDS))
def test_zoo_flops_lie_within_a_band_of_xla(family):
    cfg = jregistry.resolve_config(family, "tiny")
    jm = jregistry.build_compiled(family, preset="tiny", cfg=cfg, dtype=None,
                                  buckets=JaxBucketSpec((2,)))
    ex = jregistry.example_input(family, cfg, 2)
    want = xla_flops(jm._jitted.lower(jm.params, jm._place(ex)).compile())
    tcfg = registry.resolve_family_config(family, "tiny")
    pm = registry.build_compiled(family, preset="tiny", cfg=tcfg, device="cpu")
    x = torch.from_numpy(registry.example_input(family, tcfg, 2))
    got, kernels = roofline.count_flops(lambda: pm._forward(x))
    lo, hi = FLOP_BANDS[family]
    assert lo <= got / want <= hi, (family, got, want)
    assert kernels == {}


def test_the_kernel_formulas_equal_the_plain_versions_counts():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 24, 16, generator=g)
    k = torch.randn(2, 2, 40, 16, generator=g)
    v = torch.randn(2, 2, 40, 16, generator=g)
    with FlopCounterMode(display=False) as c:
        flash_attention_plain(q, k, v, causal=True)
    assert c.get_total_flops() == _flops.attention_flops(2, 4, 24, 40, 16)
    total, by = roofline.count_flops(lambda: flash_attention(q, k, v, causal=True))
    assert total == c.get_total_flops() and by == {"flash_attention": total}

    S, L, H, KV, D, NB, BS, WB = 3, 2, 4, 2, 16, 9, 4, 3
    qd = torch.randn(S, L, H, D, generator=g)
    kp = torch.randn(NB, BS, KV, D, generator=g)
    vp = torch.randn(NB, BS, KV, D, generator=g)
    table = torch.randint(1, NB, (S, WB), generator=g, dtype=torch.int32)
    pos = torch.tensor([3, 7, 10], dtype=torch.int32)
    with FlopCounterMode(display=False) as c:
        paged_decode_attention_plain(qd, kp, vp, table, pos)
    assert c.get_total_flops() == _flops.attention_flops(S, H, L, WB * BS, D)
    total, by = roofline.count_flops(lambda: paged_decode_attention(qd, kp, vp, table, pos))
    assert total == c.get_total_flops() and by == {"paged_decode_attention": total}


def test_the_generative_roofline_counts_the_llama_decode_on_the_cpu():
    out = roofline.generative_roofline("llama", preset="tiny", n_slots=2, decode_block=4,
                                       dtype=None, iters=2, device="cpu")
    assert out["flops_per_token"] == 2 * out["n_params"] and out["window"] >= 16
    assert out["tokens_per_s_device"] > 0 and out["mfu"] is None and out["hbm_frac"] is None
    assert out["hbm_bytes_per_step"] > 0 and out["prefill_ms"] > 0


def test_the_peak_table_names_the_h100_and_no_cpu(monkeypatch):
    assert roofline.chip_peak_flops("cpu") is None
    assert roofline.chip_hbm_bandwidth(torch.device("cpu")) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak, bw in (("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
                           ("NVIDIA H100 PCIe", 756e12, 2.0e12),
                           ("NVIDIA A100-SXM4-80GB", 312e12, 2.039e12),
                           ("Some Other Card", None, None)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None, n=name: n)
        assert roofline.chip_peak_flops("cuda") == peak
        assert roofline.chip_hbm_bandwidth("cuda") == bw


def test_the_roofline_cli_prints_one_json_object(capsys):
    roofline.main(["--family", "mlp", "--preset", "tiny", "--batch", "2", "--device", "cpu",
                   "--dtype", "float32", "--iters", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["family"] == "mlp" and out["flops_per_row"] > 0 and out["device_kind"] == "cpu"
