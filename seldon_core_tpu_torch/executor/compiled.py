"""Compiled model: a zoo module on the device behind a bucket ladder.

The port of the JAX package's ``executor/compiled.py``.  A request's batch
is padded up to a fixed ladder of batch sizes and the result sliced, so the
device runs a bounded set of shapes, all warmable before readiness.  On
``cuda`` each (bucket, row shape, dtype) is ONE CUDA graph, captured at
:meth:`CompiledModel.warmup` (or on first use, counted): the counterpart of
one jitted program per bucket.  A step writes its padded rows into a
pinned staging slot of the graph, then, under the model's lock (the pool
threads of the batching queue dispatch concurrently and share one static
buffer per graph), uploads them into the graph's static input, replays it
and enqueues the download of its output into the slot; :meth:`fetch` waits
for that download outside the lock, the step's one host sync, and hands
the slot back.  No pinned memory is allocated on the hot path.  On the CPU
the forward runs eagerly.

:meth:`CompiledModel.save_checkpoint` writes the module as the JAX
package's flax variables, which its ``load_params`` and
``build_compiled(params=...)`` serve.  Not ported: ``mesh``/``rules``
(sharding, ROADMAP A15), the multi-host driver and ``aot_lower``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch import capture_section, resolve_device
from seldon_core_tpu_torch.models.zoo import cast_floats
from seldon_core_tpu_torch.obs.spans import RECORDER, make_trace_id
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS

# pinned staging slots per graph: the batching queue keeps up to
# SCT_BATCH_PIPELINE (default 8) steps of one model in flight
STAGING_SLOTS = 8

# JAX without x64 canonicalizes 64-bit host arrays to 32 bits at the device
# boundary: a float64 JSON batch runs the float32 program
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Batch-dimension bucket ladder."""

    sizes: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    def fit(self, n: int) -> int:
        for s in self.sizes:
            if s >= n:
                return s
        return self.sizes[-1]

    @property
    def max(self) -> int:
        return self.sizes[-1]


class CompiledModel:
    """A serving-ready forward over ``module`` (``module(batch) -> rows``).

    ``dtype`` casts the floating parameters and weight buffers (bf16 is the
    card's tensor-core type); integer tensors keep theirs.  ``buckets`` is
    the batch ladder.  ``program_compiles`` counts graph captures and
    ``program_hits`` steps that replayed a captured graph (CUDA only);
    ``host_syncs`` counts fetches.
    """

    def __init__(self, module: nn.Module, *, buckets: BucketSpec = BucketSpec(),
                 dtype: torch.dtype | None = None, name: str = "model",
                 device: "str | torch.device" = "cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.buckets = buckets
        module = cast_floats(module, dtype).to(self.device).eval().requires_grad_(False)
        self.module = module.to(memory_format=torch.channels_last)
        self._lock = threading.Lock()  # a graph's static buffers, from upload to download
        self._count_lock = threading.Lock()
        self._graphs: dict[tuple, dict] = {}
        self._pool = None  # the graphs' shared memory pool: replays never overlap
        self._stream = None
        self.program_compiles = 0
        self.program_hits = 0
        self.host_syncs = 0
        self._in_warmup = False

    # ----------------------------------------------------------------- calls
    def check(self, batch: np.ndarray) -> None:
        """Raise ``ValueError`` for rows the module cannot take (on the host:
        a bad index or shape must never reach a captured graph)."""
        check = getattr(self.module, "check_input", None)
        if check is not None:
            check(batch)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.module(x).float()

    def _host_batch(self, batch) -> np.ndarray:
        batch = np.asarray(batch)
        if batch.ndim == 1:
            batch = batch[None, :]
        if batch.dtype in _CANONICAL:
            batch = batch.astype(_CANONICAL[batch.dtype])
        if batch.shape[0] > self.buckets.max:
            raise ValueError(
                f"dispatch batch {batch.shape[0]} exceeds max bucket {self.buckets.max}")
        self.check(batch)
        return batch

    def dispatch(self, batch: np.ndarray) -> tuple[Any, int]:
        """Enqueue one padded device step without waiting for its result;
        returns the handle :meth:`fetch` takes and the row count."""
        batch = self._host_batch(batch)
        n, b = batch.shape[0], self.buckets.fit(batch.shape[0])
        if self.device.type != "cuda":
            padded = np.zeros((b,) + batch.shape[1:], batch.dtype)
            padded[:n] = batch
            return self._forward(torch.from_numpy(padded)), n
        with self._lock:
            entry = self._graph(b, batch.shape[1:], batch.dtype)
        slot = entry["free"].get()  # blocks while every slot's step awaits its fetch
        try:
            host = slot["x"].numpy()  # the slot is ours: fill it outside the lock
            host[:n] = batch
            host[n:] = 0
            with self._lock:
                entry["x"].copy_(slot["x"], non_blocking=True)
                entry["graph"].replay()
                slot["out"].copy_(entry["out"], non_blocking=True)
                slot["done"].record()
        except BaseException:
            entry["free"].put(slot)
            raise
        return (entry, slot), n

    def fetch(self, handle: Any, n: int) -> np.ndarray:
        """Materialize a dispatched step's rows (one host sync on the card)
        and hand its staging slot back."""
        if self.device.type != "cuda":
            return handle[:n].numpy()
        entry, slot = handle
        try:
            slot["done"].synchronize()
            out = slot["out"].numpy()[:n].copy()
        finally:
            entry["free"].put(slot)
        with self._count_lock:
            self.host_syncs += 1
        return out

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """One padded step (chunks above the largest bucket); returns the
        unpadded rows, a 1-D input's row squeezed."""
        batch = np.asarray(batch)
        squeeze = batch.ndim == 1
        if squeeze:
            batch = batch[None, :]
        if batch.shape[0] > self.buckets.max:
            step = self.buckets.max
            return np.concatenate([self(batch[i:i + step])
                                   for i in range(0, batch.shape[0], step)], axis=0)
        out = self.fetch(*self.dispatch(batch))
        return out[0] if squeeze else out

    # ---------------------------------------------------------------- graphs
    def _graph(self, bucket: int, shape: tuple, dtype: np.dtype) -> dict:
        """The CUDA graph of ``(bucket, row shape, dtype)``, captured at
        first use (:meth:`warmup` captures the ladder); the caller holds the
        lock."""
        key = (bucket, tuple(shape), np.dtype(dtype).str)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(bucket, shape, dtype)
            self.program_compiles += 1
            DEFAULT_METRICS.program_compiles.labels(self.name).inc()
            if not self._in_warmup:  # a request paid for this capture
                s = entry["capture_s"]
                RECORDER.record_span("program.compile", trace_id=make_trace_id(),
                                     parent_id=None, start=time.time() - s, duration_s=s,
                                     service=self.name,
                                     attrs={"variant": f"bucket={bucket}", "model": self.name})
        else:
            self.program_hits += 1
        return entry

    def _capture(self, bucket: int, shape: tuple, dtype: np.dtype) -> dict:
        """Capture the forward at ``bucket`` rows.  The forward runs once
        eagerly on the capture stream first, so that kernels are loaded and
        library workspaces exist outside the graph.  Only the capture
        stream is synchronized (other threads may be replaying other
        graphs), and captures take turns process-wide, with the garbage
        collector paused (``capture_section``).  A capture that
        fails raises: nothing falls back to eager."""
        dev = self.device
        t0 = time.perf_counter()
        x = torch.zeros((bucket,) + tuple(shape), dtype=_torch_dtype(dtype), device=dev)
        with capture_section():
            if self._stream is None:
                self._stream = torch.cuda.Stream(dev)
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._forward(x)
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self._forward(x)
            if self._pool is None:
                self._pool = graph.pool()
        # pinned staging slots, one per step in flight: a step's rows go up
        # from its slot and its result comes down into it, and the slot is
        # reused only once that step is fetched
        free: queue.SimpleQueue = queue.SimpleQueue()
        for _ in range(STAGING_SLOTS):
            free.put({"x": torch.empty(x.shape, dtype=x.dtype, pin_memory=True),
                      "out": torch.empty(out.shape, dtype=out.dtype, pin_memory=True),
                      "done": torch.cuda.Event()})
        return {"graph": graph, "x": x, "out": out, "free": free,
                "capture_s": time.perf_counter() - t0}

    def warmup(self, feature_shape: tuple[int, ...], dtype: Any = np.float32) -> int:
        """Run (on the card: capture) every bucket, one after another, in
        ``dtype``; returns the number of buckets."""
        self._in_warmup = True
        try:
            for b in self.buckets.sizes:
                x = np.zeros((b,) + tuple(feature_shape), dtype=dtype)
                self.fetch(*self.dispatch(x))
        finally:
            self._in_warmup = False
        return len(self.buckets.sizes)

    def save_checkpoint(self, path: str) -> int:
        """Write the module's weights to ``path`` as the JAX package's flax
        variables of its family (bf16 kept as bf16); returns the leaf
        count."""
        from seldon_core_tpu_torch.executor.checkpoint import save_params
        from seldon_core_tpu_torch.models.weights import zoo_to_flax

        return save_params(path, zoo_to_flax(self.name.partition(":")[0], self.module))

    def program_snapshot(self) -> dict:
        """Captures, replays of a captured graph, and each graph's key and
        capture seconds."""
        with self._lock:
            graphs = [{"bucket": k[0], "shape": list(k[1]), "dtype": k[2],
                       "capture_s": e["capture_s"]} for k, e in sorted(self._graphs.items())]
            return {"program_compiles": self.program_compiles,
                    "program_hits": self.program_hits, "host_syncs": self.host_syncs,
                    "graphs": graphs}
