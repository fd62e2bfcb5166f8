#!/usr/bin/env python3
"""Time the earlier served waves of one or more checkouts on one NVIDIA GPU.

    python3 planes_cost.py [--only PART[,PART...]] [TREE[,NAME=VALUE...] ...]

Each TREE (default: this checkout) is a directory that holds a
``seldon_core_tpu_torch`` package, such as an older commit unpacked with
``git archive``; the ``NAME=VALUE`` pairs after it are set in that run's
environment (``.,SCT_QOS=0`` serves this checkout with admission off).
Each run is a process of its own, one after another in the order given, so
that two commits are compared on one card as ``OLD NEW NEW OLD``.  The
waves and their figures are ``chip_smoke.py``'s: ``serve``'s concurrent
wave of 9 llama3-1b requests (``WAVES`` times on one engine, after one
unmeasured wave), with its wall seconds, tokens/s and TTFT p50, and
``serve_zoo``'s Z2 graphs (ResNet-50, BERT-base, the epsilon-greedy A/B
and the outlier ensemble), with predictions/s and request p50/p99.  These
are the request paths that the response tiers, admission, the stage
recorder and the usage meter sit on.

The parts are ``front``, ``serve`` and ``zoo``, run in that order in each
process, all three unless ``--only`` names some.  ``front`` times the
engine's HTTP front and those planes, with no device work and no card
needed: a unit that answers at once, fed one ResNet-50 request (16 uint8 images as a ``rawTensor``, 3.2 MB of JSON) and
one 1-row request, each ``FRONT_SEQUENTIAL`` times one at a time (request
wall ms), then the ResNet-50 request as ``FRONT_WAVES`` concurrent waves of
24, as ``serve_zoo`` sends them (wave wall ms).

Prints one JSON line per run, then the card's name and power limit.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WAVES = 10
FRONT_SEQUENTIAL = 40
FRONT_WAVES = 5
FRONT_CONCURRENT = 24


def _serve_waves(smoke) -> dict:
    """``serve``'s wave on one engine: one unmeasured, then ``WAVES``."""
    import numpy as np

    spec = smoke._serve_spec(smoke.SERVE_PRESET, 0)
    rng = np.random.default_rng(0)

    async def run() -> dict:
        app, boot_s = await smoke._boot(spec, "cuda")
        try:
            vocab = app.service.walker.component.model.cfg.vocab_size
            sched = app.service.walker.component.scheduler
            prompts = [smoke.VERIFY_PROMPT] + [
                rng.integers(0, vocab, n).tolist()
                for n in smoke.SERVE_LENGTHS if n != len(smoke.VERIFY_PROMPT)]
            prompts.append(prompts[3])
            await smoke._serve_wave(app.port, prompts)
            walls, ttfts = [], []
            for _ in range(WAVES):
                n0 = len(sched.ttft)
                replies, wave_s = await smoke._serve_wave(app.port, prompts)
                if any(code != 200 for code, _ in replies):
                    raise AssertionError(f"a serve request failed: {replies}")
                walls.append(wave_s)
                ttfts.append(statistics.median(t for _, t in list(sched.ttft)[n0:]))
            return {"boot_and_warmup_s": boot_s, "wave_s": walls,
                    "wave_s_median": statistics.median(walls),
                    "wave_tokens_per_s_median": len(prompts) * smoke.MAX_NEW
                    / statistics.median(walls),
                    "ttft_s_p50": ttfts, "ttft_s_p50_median": statistics.median(ttfts)}
        finally:
            await app.close()

    return asyncio.run(run())


class _Echo:
    """A unit that answers at once with each row's first value."""

    async def predict(self, X, names):
        import numpy as np

        return np.asarray(X).reshape(len(X), -1)[:, :1].astype(np.float32)


def _front(smoke) -> dict:
    """The HTTP front and the planes over :class:`_Echo`, on the host."""
    import numpy as np

    from seldon_core_tpu_torch.engine.app import EngineApp
    from seldon_core_tpu_torch.engine.service import PredictionService
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    rng = np.random.default_rng(3)
    images = smoke._raw_body(rng.integers(0, 256, (16, 224, 224, 3), dtype=np.uint8))
    row = smoke._raw_body(rng.random((1, 784), dtype=np.float32))

    async def run() -> dict:
        spec = PredictorSpec.from_dict({"name": "front", "graph": {"name": "m", "type": "MODEL"}})
        app = EngineApp(PredictionService(spec, device="cpu", components={"m": _Echo()}))
        await app.start("127.0.0.1", 0)
        await app.boot()
        try:
            out = {}
            for name, body in (("resnet_request", images), ("row_request", row)):
                raw = json.dumps(body).encode()
                walls = []
                for _ in range(FRONT_SEQUENTIAL + 1):
                    r = await asyncio.to_thread(smoke._req, app.port, raw)
                    if r["status"] != 200:
                        raise AssertionError(f"the front answered {r['status']}")
                    walls.append(1e3 * r["s"])
                out[name] = {"bytes": len(raw), "ms_median": statistics.median(walls[1:]),
                             "ms_min": min(walls[1:])}
            raw = json.dumps(images).encode()
            waves = []
            for _ in range(FRONT_WAVES):
                loop = asyncio.get_running_loop()
                t0 = loop.time()
                replies = await smoke._requests(app.port, [raw] * FRONT_CONCURRENT)
                waves.append(1e3 * (loop.time() - t0))
                if any(r["status"] != 200 for r in replies):
                    raise AssertionError("a request of the front's wave failed")
            out["resnet_wave"] = {"requests": FRONT_CONCURRENT, "ms": waves,
                                  "ms_median": statistics.median(waves)}
            return out
        finally:
            await app.close()

    return asyncio.run(run())


def time_tree(tree: str, parts: list[str]) -> dict:
    """This process's package comes from ``tree``; the waves from the
    ``chip_smoke.py`` beside this file."""
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)  # ahead of this checkout
    app = importlib.import_module("seldon_core_tpu_torch.engine.app")
    if not app.__file__.startswith(tree + os.sep):
        raise RuntimeError(f"{app.__file__} is not under {tree}")
    out: dict = {"tree": tree}
    if "front" in parts:
        out["front"] = _front(smoke)
    if "serve" in parts:
        out["serve"] = _serve_waves(smoke)
    if "zoo" in parts:
        out["zoo"] = [{k: r[k] for k in ("graph", "requests", "rows", "status",
                                         "predictions_per_s", "wave_s", "request_p50_ms",
                                         "request_p99_ms", "steps")}
                      for r in asyncio.run(smoke._zoo_waves("cuda"))]
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_tree(argv[1], argv[2].split(","))), flush=True)
        return 0
    parts = "front,serve,zoo"
    if argv[:1] == ["--only"]:
        parts, argv = argv[1], argv[2:]
    import torch

    if parts != "front" and not torch.cuda.is_available():
        print("planes_cost: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    for arg in argv or [HERE]:
        tree, *pairs = arg.split(",")
        env = dict(os.environ, **dict(p.split("=", 1) for p in pairs))
        print(json.dumps({"run": arg}), flush=True)
        code = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, parts],
                              env=env).returncode
        if code:
            return code
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False,
        )
        print(smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    except FileNotFoundError:
        print("nvidia-smi: not found (no card; host figures only)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
