"""Wire-level load harness: the port's copy of the JAX package's
``testing/loadtest.py``, on the stdlib and numpy (the card has no aiohttp).

``--processes`` client processes, each an asyncio loop with
``--concurrency`` requests in flight over pooled keep-alive connections
(``wire/h1client.py``), merged into one latency histogram on a log grid,
so percentiles merge exactly across processes.  Every request crosses a
real socket and pays the JSON codec.  Processes start by ``spawn``: a
client never forks a parent that holds a CUDA context, and never touches
CUDA itself.

    python -m seldon_core_tpu_torch.testing.loadtest http://host:8000/api/v0.1/predictions \\
        -c 64 -P 4 -d 10
    ... --token-url http://gw:8080/oauth/token --oauth-key k --oauth-secret s

Beside the JAX harness's figures a run counts the request and reply body
bytes it moved (comparable with the engine's ``engine-rest`` wire edge)
and keeps the ``x-sct-trace-id`` of every reply.  ``--once`` sends each
payload exactly once (split over the processes) instead of running for a
duration.  ``--grpc`` drives ``Seldon/Predict`` at a host:port with the
port's own h2 client (``--grpc-lib grpcio`` raises by name; the card has
no grpcio; the token of ``--token-url`` rides the ``oauth_token``
metadata).  ``--contract`` raises by name: the contract's payloads come
with the control plane.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import multiprocessing
import sys
import time
import urllib.parse
from typing import Any

import numpy as np

TRACE_RESPONSE_HEADER = "x-sct-trace-id"  # the engine's echo (obs/spans.py)

# log-spaced latency bins: 50 us .. 50 s, 40 a decade, so a merged
# histogram's percentile is within ~3% of the true value
_BIN_EDGES = np.logspace(np.log10(5e-5), np.log10(50.0), 241)


def _histogram() -> np.ndarray:
    return np.zeros(len(_BIN_EDGES) + 1, np.int64)


def _record(hist: np.ndarray, seconds: float) -> None:
    hist[int(np.searchsorted(_BIN_EDGES, seconds))] += 1


def _percentile(hist: np.ndarray, q: float) -> float:
    total = hist.sum()
    if total == 0:
        return 0.0
    target = q / 100.0 * total
    cum = np.cumsum(hist)
    idx = int(np.searchsorted(cum, target))
    idx = min(idx, len(_BIN_EDGES) - 1)
    return float(_BIN_EDGES[idx])


@dataclasses.dataclass
class WorkerConfig:
    target: str  # the URL
    payloads: list[bytes]  # request bodies, cycled through (or each sent once)
    concurrency: int
    duration_s: float
    headers: dict[str, str]
    warmup_requests: int = 8
    # > 0: open-loop Poisson arrivals at this rate instead of a closed loop
    arrival_rps: float = 0.0
    seed: int = 0
    # send each payload exactly once (no warmup, no duration)
    once: bool = False
    timeout_s: float = 60.0
    # gRPC: ``target`` is host:port and each payload a serialized SeldonMessage
    grpc: bool = False


@dataclasses.dataclass
class LoadResult:
    requests: int
    failures: int
    elapsed_s: float
    hist: np.ndarray
    # open-loop runs only: arrivals dispatched; 0 for closed-loop runs
    offered: int = 0
    # request and reply body bytes of the timed requests
    bytes_sent: int = 0
    bytes_received: int = 0
    # the x-sct-trace-id of every timed reply that carried one
    trace_ids: list[str] = dataclasses.field(default_factory=list)
    # ``once`` runs only: each payload's reply body (None when it failed)
    replies: list[bytes | None] = dataclasses.field(default_factory=list)
    # the timed window, first request sent to last reply, across processes
    # (``elapsed_s`` also holds the processes' start and import)
    window_s: float = 0.0

    @property
    def rps(self) -> float:
        return self.requests / self.elapsed_s if self.elapsed_s > 0 else 0.0

    @property
    def offered_rps(self) -> float:
        return self.offered / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def percentile_ms(self, q: float) -> float:
        return _percentile(self.hist, q) * 1000.0

    def summary(self) -> dict[str, Any]:
        out = {
            "requests": self.requests,
            "failures": self.failures,
            "seconds": round(self.elapsed_s, 2),
            "rps": round(self.rps, 2),
            "p50_ms": round(self.percentile_ms(50), 3),
            "p90_ms": round(self.percentile_ms(90), 3),
            "p95_ms": round(self.percentile_ms(95), 3),
            "p99_ms": round(self.percentile_ms(99), 3),
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "window_s": round(self.window_s, 3),
        }
        if self.offered:
            out["offered"] = self.offered
            out["offered_rps"] = round(self.offered_rps, 2)
            out["achieved_ratio"] = round(self.requests / self.offered, 4)
        return out


def _new_acc() -> dict:
    return {"ok": 0, "fail": 0, "offered": 0, "sent": 0, "received": 0, "traces": [],
            "replies": {}, "first": None, "last": None}


def _note(acc: dict, hist: np.ndarray, cfg: WorkerConfig, i: int, t0: float, ok: bool,
          body: bytes, got: bytes) -> None:
    """Count one timed request: its latency, outcome and bytes."""
    acc["last"] = time.time()
    _record(hist, time.perf_counter() - t0)
    acc["ok" if ok else "fail"] += 1
    acc["sent"] += len(body)
    acc["received"] += len(got)
    if cfg.once:
        acc["replies"][i] = got if ok else None


async def _drive(cfg: WorkerConfig, one, acc: dict) -> None:
    """The request schedule shared by both transports: each payload once,
    or a warmup outside the timed window and then a closed loop of
    ``concurrency`` workers or open-loop Poisson arrivals."""
    if cfg.once:
        order = iter(range(len(cfg.payloads)))

        async def drain_once() -> None:
            for i in order:
                await one(i, True)

        await asyncio.gather(*(drain_once() for _ in range(cfg.concurrency)))
        return
    # connection warmup, outside the timed window
    await asyncio.gather(*(one(i, False) for i in range(cfg.warmup_requests)))
    stop_at = time.perf_counter() + cfg.duration_s
    if cfg.arrival_rps > 0:
        rng = np.random.default_rng(cfg.seed)
        inflight: set[asyncio.Task] = set()
        i = 0
        next_t = time.perf_counter()
        while next_t < stop_at:
            delay = next_t - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            t = asyncio.get_running_loop().create_task(one(i, True))
            inflight.add(t)
            t.add_done_callback(inflight.discard)
            acc["offered"] += 1
            i += 1
            next_t += float(rng.exponential(1.0 / cfg.arrival_rps))
        if inflight:
            # late replies still count; stragglers past the window go
            await asyncio.wait(inflight, timeout=30.0)
            for t in list(inflight):
                t.cancel()
        return

    async def worker(wid: int) -> None:
        i = wid
        while time.perf_counter() < stop_at:
            await one(i, True)
            i += cfg.concurrency

    await asyncio.gather(*(worker(w) for w in range(cfg.concurrency)))


async def _rest_worker_loop(cfg: WorkerConfig) -> dict:
    from seldon_core_tpu_torch.wire.h1client import H1Pool

    url = urllib.parse.urlsplit(cfg.target)
    path = url.path or "/"
    if url.query:
        path += "?" + url.query
    # open loop: in flight is unbounded by design (the server's admission
    # is what is under test)
    limit = 1 << 16 if cfg.arrival_rps > 0 else cfg.concurrency + 8
    pool = H1Pool(url.hostname or "127.0.0.1", url.port or 80, limit=limit, max_conns=limit)
    hist = _histogram()
    acc = _new_acc()
    headers = {k.lower(): v for k, v in cfg.headers.items()}

    async def one(i: int, timed: bool) -> None:
        body = cfg.payloads[i % len(cfg.payloads)]
        if timed and acc["first"] is None:
            acc["first"] = time.time()
        t0 = time.perf_counter()
        ok, got = False, b""
        try:
            resp = await pool.post(path, body, headers, timeout=cfg.timeout_s)
            ok, got = resp.status == 200, resp.body
            tid = resp.headers.get(TRACE_RESPONSE_HEADER)
            if timed and tid:
                acc["traces"].append(tid)
        except (ConnectionError, asyncio.TimeoutError, OSError):
            pass
        if timed:
            _note(acc, hist, cfg, i, t0, ok, body, got)

    try:
        await _drive(cfg, one, acc)
        return acc | {"hist": hist}
    finally:
        await pool.close()


async def _grpc_worker_loop(cfg: WorkerConfig) -> dict:
    """``Seldon/Predict`` calls over one multiplexed h2 channel (the port's
    own client, ``wire/h2grpc.py``); a reply counts as ok when its status
    code is 0 or 200.  The bytes counted are the serialized messages."""
    from seldon_core_tpu_torch.proto import prediction as pb
    from seldon_core_tpu_torch.wire import FastGrpcChannel, GrpcCallError

    hist = _histogram()
    acc = _new_acc()
    path = "/seldon.protos.Seldon/Predict"
    metadata = tuple((k.lower(), v) for k, v in cfg.headers.items())
    channel = FastGrpcChannel(cfg.target)

    async def one(i: int, timed: bool) -> None:
        body = cfg.payloads[i % len(cfg.payloads)]
        if timed and acc["first"] is None:
            acc["first"] = time.time()
        t0 = time.perf_counter()
        ok, got = False, b""
        try:
            got = await channel.call(path, body, timeout=cfg.timeout_s, metadata=metadata)
            status = pb.SeldonMessage.FromString(got).status
            ok = (status.code if status is not None else 0) in (0, 200)
        except (GrpcCallError, ConnectionError, asyncio.TimeoutError, OSError, ValueError):
            pass
        if timed:
            _note(acc, hist, cfg, i, t0, ok, body, got)

    try:
        await _drive(cfg, one, acc)
        return acc | {"hist": hist}
    finally:
        await channel.close()


def _run_worker(cfg: WorkerConfig) -> dict:
    out = asyncio.run(_grpc_worker_loop(cfg) if cfg.grpc else _rest_worker_loop(cfg))
    out["hist"] = out["hist"].tobytes()
    return out


def run_load(target: str, payloads: list[bytes], *, grpc: bool = False, concurrency: int = 32,
             processes: int = 1, duration_s: float = 10.0, headers: dict[str, str] | None = None,
             arrival_rps: float = 0.0, seed: int = 0, once: bool = False,
             timeout_s: float = 60.0, grpc_lib: str = "h2") -> LoadResult:
    """Drive ``target`` for ``duration_s`` (or, with ``once``, until each
    payload was sent once, process ``p`` taking ``payloads[p::processes]``,
    each reply kept in ``replies``); returns the merged results.  ``concurrency`` is per process.
    ``arrival_rps > 0`` selects open-loop Poisson arrivals, split evenly
    over the processes (REST only, as in the JAX harness).  ``grpc``
    drives ``Seldon/Predict`` at ``target`` (host:port) with serialized
    SeldonMessage payloads; ``grpc_lib='grpcio'`` raises by name."""
    if grpc and grpc_lib == "grpcio":
        from seldon_core_tpu_torch.proto.grpc_defs import GRPCIO_REFUSED

        raise NotImplementedError(f"grpc_lib='grpcio': {GRPCIO_REFUSED}")
    if arrival_rps > 0 and grpc:
        raise ValueError("open-loop arrivals are REST-only")
    cfg = WorkerConfig(target=target, payloads=payloads, concurrency=concurrency,
                       duration_s=duration_s, headers=headers or {},
                       arrival_rps=arrival_rps / max(1, processes), seed=seed, once=once,
                       timeout_s=timeout_s, grpc=grpc)
    t0 = time.perf_counter()
    if processes <= 1:
        results = [_run_worker(cfg)]
    else:
        cfgs = [dataclasses.replace(cfg, seed=cfg.seed + p,
                                    payloads=payloads[p::processes] if once else payloads)
                for p in range(processes)]
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            results = pool.map(_run_worker, cfgs)
    elapsed = time.perf_counter() - t0
    hist = _histogram()
    out = LoadResult(requests=0, failures=0, elapsed_s=elapsed, hist=hist)
    if once:
        out.replies = [None] * len(payloads)
        for p, r in enumerate(results):
            for i, body in r["replies"].items():
                out.replies[p + i * max(1, processes)] = body
    firsts = [r["first"] for r in results if r["first"] is not None]
    lasts = [r["last"] for r in results if r["last"] is not None]
    if firsts and lasts:
        out.window_s = max(lasts) - min(firsts)
    for r in results:
        out.requests += r["ok"] + r["fail"]
        out.failures += r["fail"]
        out.offered += r["offered"]
        out.bytes_sent += r["sent"]
        out.bytes_received += r["received"]
        out.trace_ids.extend(r["traces"])
        hist += np.frombuffer(r["hist"], np.int64)
    return out


# ---------------------------------------------------------------------------
# the diurnal trace generator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """The shape of a synthetic production day, scaled to any duration: a
    raised-cosine diurnal arrival rate, lognormal prompt and output
    lengths, and a Zipf-skewed population of shared prefixes."""

    duration_s: float = 86400.0
    base_rps: float = 1.0  # the trough's arrival rate
    peak_rps: float = 10.0  # the midday peak's
    peak_at_frac: float = 0.55  # where in the window the peak sits
    prompt_len_median: int = 200  # tokens
    prompt_len_sigma: float = 0.8  # lognormal shape (ln-space stddev)
    output_len_median: int = 64
    output_len_sigma: float = 0.9
    max_len: int = 4096
    prefix_population: int = 512  # distinct shared system prompts
    prefix_zipf_a: float = 1.2  # the Zipf exponent over that population
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    at_s: float  # arrival offset from the trace's start
    prefix_id: int  # the shared prefix this request reuses
    prompt_len: int
    output_len: int


def diurnal_rate(cfg: TraceConfig, t: float) -> float:
    """The arrival rate at offset ``t``: a raised cosine between
    ``base_rps`` and ``peak_rps``, peaking at ``peak_at_frac``."""
    phase = 2.0 * np.pi * (t / cfg.duration_s - cfg.peak_at_frac)
    return cfg.base_rps + (cfg.peak_rps - cfg.base_rps) * (1.0 + np.cos(phase)) / 2.0


def generate_trace(cfg: TraceConfig) -> list[TraceRequest]:
    """Non-homogeneous Poisson arrivals by thinning (Lewis-Shedler): gaps
    at the peak rate, each kept with probability rate(t)/peak."""
    rng = np.random.default_rng(cfg.seed)
    lam_max = max(cfg.peak_rps, cfg.base_rps, 1e-9)
    # a Zipf pmf over a FINITE rank population; rank 0 is the most shared
    ranks = np.arange(1, cfg.prefix_population + 1, dtype=np.float64)
    pmf = ranks ** -cfg.prefix_zipf_a
    pmf /= pmf.sum()
    out: list[TraceRequest] = []
    t = float(rng.exponential(1.0 / lam_max))
    while t < cfg.duration_s:
        if rng.random() < diurnal_rate(cfg, t) / lam_max:
            out.append(TraceRequest(
                at_s=t,
                prefix_id=int(rng.choice(cfg.prefix_population, p=pmf)),
                prompt_len=_lognormal_len(rng, cfg.prompt_len_median, cfg.prompt_len_sigma,
                                          cfg.max_len),
                output_len=_lognormal_len(rng, cfg.output_len_median, cfg.output_len_sigma,
                                          cfg.max_len),
            ))
        t += float(rng.exponential(1.0 / lam_max))
    return out


def _lognormal_len(rng, median: int, sigma: float, max_len: int) -> int:
    n = int(round(rng.lognormal(np.log(max(1, median)), sigma)))
    return max(1, min(n, max_len))


def trace_rate_series(cfg: TraceConfig, trace: list[TraceRequest],
                      bucket_s: float) -> list[float]:
    """Arrivals a second, bucketed: the shape the generator produced."""
    n = max(1, int(np.ceil(cfg.duration_s / bucket_s)))
    counts = [0] * n
    for req in trace:
        counts[min(n - 1, int(req.at_s / bucket_s))] += 1
    return [c / bucket_s for c in counts]


# ---------------------------------------------------------------------------
# payloads and the CLI
# ---------------------------------------------------------------------------

def default_rest_payload(rows: int = 1, features: int = 3) -> bytes:
    batch = np.random.default_rng(0).normal(size=(rows, features)).round(3)
    return json.dumps({"data": {"ndarray": batch.tolist()}}).encode()


def default_grpc_payload(rows: int = 1, features: int = 3) -> bytes:
    from seldon_core_tpu_torch.contract import Payload, payload_to_proto

    batch = np.random.default_rng(0).normal(size=(rows, features))
    return payload_to_proto(Payload.from_array(batch)).SerializeToString()


def _fetch_token(token_url: str, key: str, secret: str) -> str:
    import urllib.request

    req = urllib.request.Request(
        token_url,
        urllib.parse.urlencode({"grant_type": "client_credentials", "client_id": key,
                                "client_secret": secret}).encode(),
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())["access_token"]


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="wire-level load harness")
    parser.add_argument("target", help="the URL (REST) or host:port (gRPC)")
    parser.add_argument("--grpc", action="store_true")
    parser.add_argument("--grpc-lib", choices=("h2", "grpcio"), default="h2",
                        help="the gRPC client: the port's h2 data plane (grpcio raises)")
    parser.add_argument("-c", "--concurrency", type=int, default=32,
                        help="in-flight requests per process")
    parser.add_argument("-P", "--processes", type=int, default=1)
    parser.add_argument("-d", "--duration", type=float, default=10.0)
    parser.add_argument("-r", "--arrival-rps", type=float, default=0.0,
                        help="open-loop Poisson arrival rate; 0 = closed loop")
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--once", action="store_true",
                        help="send each payload once instead of running for a duration")
    parser.add_argument("--contract", help="not in the port yet: raises")
    parser.add_argument("--data", action="append",
                        help="a literal JSON request body (repeatable)")
    parser.add_argument("--token-url", help="the gateway's /oauth/token URL")
    parser.add_argument("--oauth-key")
    parser.add_argument("--oauth-secret")
    args = parser.parse_args(argv)
    if args.contract:
        raise NotImplementedError("--contract: payloads from a contract file are not in the "
                                  "port yet (testing/contract.py comes with the control plane)")
    if args.data:
        payloads = [d.encode() for d in args.data]
    elif args.grpc:
        payloads = [default_grpc_payload(args.batch_size)]
    else:
        payloads = [default_rest_payload(args.batch_size)]
    headers: dict[str, str] = {}
    if args.token_url:
        token = _fetch_token(args.token_url, args.oauth_key or "", args.oauth_secret or "")
        if args.grpc:
            headers["oauth_token"] = token
        else:
            headers["Authorization"] = f"Bearer {token}"
    result = run_load(args.target, payloads, grpc=args.grpc, concurrency=args.concurrency,
                      processes=args.processes, duration_s=args.duration, headers=headers,
                      arrival_rps=args.arrival_rps, once=args.once, grpc_lib=args.grpc_lib)
    print(json.dumps(result.summary()))
    sys.exit(0 if result.failures == 0 and result.requests > 0 else 1)


if __name__ == "__main__":
    main()
