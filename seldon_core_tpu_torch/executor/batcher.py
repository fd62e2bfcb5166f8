"""Continuous micro-batching queue with a pipelined device stream: the port
of the JAX package's ``executor/batcher.py``.

Concurrent requests coalesce into one batch a device step, so the card
runs full tiles.  Two latencies matter:

* collection: how long a request waits for batch-mates (``max_delay_ms``,
  one window a step, drained with ``get_nowait``; a full batch dispatches
  at once);
* the device round trip: the queue hands each step to a pool thread that
  dispatches it and fetches its result, with up to ``pipeline_depth``
  steps in flight (``SCT_BATCH_PIPELINE``, default 8), so the round trip
  overlaps the next steps' dispatch.

Rows of one request stay together; items are keyed by row shape and
dtype, and a minority key is held for the next step, not starved.  A
runner may be a plain callable ``batch -> rows`` (run one step at a time)
or expose ``dispatch(batch) -> handle`` / ``fetch(*handle) -> rows``
(:class:`~seldon_core_tpu_torch.executor.compiled.CompiledModel` does); a
group larger than the runner's largest bucket takes the plain call, which
chunks.  ``maxsize`` (``SCT_BATCH_QUEUE_MAX``, default 2048; 0 = no bound)
bounds the waiting requests: beyond it ``submit`` raises ``QueueFull``.  A
request whose deadline (``qos.get_deadline()``, seeded at ingress) has
passed before its step gets ``DeadlineExceeded`` (counted against the
active admission controller), and a cancelled request is skipped: no
device step is spent on either.

Each step records the flight recorder's batch-assembly, queue-wait,
device-step and device-dispatch stages, charges its device seconds (the
step's wall time less the host dispatch) to the queue's deployment in the
usage meter, counts its one host sync (``obs/probes.py``) and feeds the
``seldon_executor_*`` families: queue wait, batch size, queue depth,
device step, the device's share of the step and, with ``flops_per_row``
set and a known card, the MFU.  Left out here: the obs spans.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import os
import time
from typing import Callable

import numpy as np

from seldon_core_tpu_torch.obs.metering import METER
from seldon_core_tpu_torch.obs.probes import record_host_sync
from seldon_core_tpu_torch.obs.spans import (
    RECORDER,
    STAGE_BATCH_ASSEMBLY,
    STAGE_DEVICE_DISPATCH,
    STAGE_DEVICE_STEP,
    STAGE_QUEUE_WAIT,
)
from seldon_core_tpu_torch.qos.admission import DeadlineExceeded, QueueFull, note_deadline_miss
from seldon_core_tpu_torch.qos.context import get_deadline
from seldon_core_tpu_torch.utils.metrics import DEFAULT as DEFAULT_METRICS
from seldon_core_tpu_torch.utils.roofline import chip_peak_flops


class BatchQueue:
    def __init__(
        self,
        runner: Callable[[np.ndarray], np.ndarray],
        *,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        pipeline_depth: int | None = None,
        name: str = "model",
        maxsize: int | None = None,
    ):
        self.runner = runner
        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get("SCT_BATCH_PIPELINE", "8"))
        self.max_batch = int(max_batch)
        self.max_delay = max_delay_ms / 1000.0
        self.name = name
        self.maxsize = (int(maxsize) if maxsize is not None
                        else int(os.environ.get("SCT_BATCH_QUEUE_MAX", "2048")))
        self._dispatch = getattr(runner, "dispatch", None)
        self._fetch = getattr(runner, "fetch", None)
        # only dispatch/fetch runners (CompiledModel) are thread-safe; a plain
        # callable keeps one runner thread and so a pipeline of 1
        self._pipelined = self._dispatch is not None and self._fetch is not None
        depth = max(1, pipeline_depth) if self._pipelined else 1
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=depth, thread_name_prefix=f"batcher-{name}")
        self._sem = asyncio.Semaphore(depth)
        self._inflight: set[asyncio.Task] = set()
        self._task: asyncio.Task | None = None
        self._closed = False
        self.steps = 0  # device steps run
        self.rows = 0  # rows those steps carried
        self.deadline_drops = 0  # requests failed with DeadlineExceeded
        self.last_step: tuple[int, float] | None = None  # (rows, device seconds)
        # FLOPs a row costs (the component sets it from the roofline's
        # count) and the card's peak: the MFU gauge's inputs
        self.flops_per_row: float | None = getattr(runner, "flops_per_row", None)
        device = getattr(runner, "device", None)
        self._peak = chip_peak_flops(device) if device is not None else None
        m = DEFAULT_METRICS
        self._m_queue_wait = m.queue_wait.labels(name)
        self._m_device_step = m.device_step.labels(name)
        self._m_batch_size = m.batch_size.labels(name)
        self._m_queue_depth = m.queue_depth.labels(name)
        self._m_mfu = m.mfu.labels(name)
        self._m_device_frac = m.device_frac.labels(name)

    # ------------------------------------------------------------- lifecycle
    def _ensure_running(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def close(self) -> None:
        """Stop the loop and fail every pending and in-flight request (a hung
        awaiter is worse than an errored one during a drain)."""
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for t in list(self._inflight):
            t.cancel()
        await asyncio.gather(*self._inflight, return_exceptions=True)
        err = RuntimeError(f"BatchQueue {self.name!r} closed")
        while not self._queue.empty():
            _, fut, _, _ = self._queue.get_nowait()
            if not fut.done():
                fut.set_exception(err)
        # a step in flight keeps running in its thread: wait for it, so no
        # device work of a closed queue overlaps what the process does next
        await asyncio.to_thread(self._pool.shutdown)

    # ------------------------------------------------------------- interface
    async def submit(self, x: np.ndarray) -> np.ndarray:
        """Submit one request's rows (they stay together); returns its rows
        (a 1-D input's row squeezed)."""
        if self._closed:
            raise RuntimeError("BatchQueue is closed")
        self._ensure_running()
        x = np.asarray(x)
        if self.maxsize and self._queue.qsize() >= self.maxsize:
            raise QueueFull(f"batch queue {self.name!r} is full "
                            f"({self._queue.qsize()} waiting, cap {self.maxsize})")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # the deadline rides the item: the step loop runs in its own context
        await self._queue.put((x, fut, time.perf_counter(), get_deadline()))
        self._m_queue_depth.set(self._queue.qsize())
        return await fut

    # ------------------------------------------------------------- internals
    @staticmethod
    def _key(x: np.ndarray) -> tuple:
        return (x.shape[1:] if x.ndim > 1 else x.shape, x.dtype.str)

    @staticmethod
    def _rows(x: np.ndarray) -> int:
        return x.shape[0] if x.ndim > 1 else 1

    def _viable(self, item) -> bool:
        """Skip a request whose client is gone (a cancelled future) and fail
        one whose deadline has passed: no step for work nobody can use."""
        _x, fut, t_enq, deadline = item
        if fut.done():
            return False
        if deadline is not None and time.monotonic() >= deadline:
            fut.set_exception(DeadlineExceeded(
                f"deadline expired after {time.perf_counter() - t_enq:.3f}s waiting in "
                f"batch queue {self.name!r}"))
            self.deadline_drops += 1
            note_deadline_miss("batch-queue")
            DEFAULT_METRICS.qos_deadline_miss.labels(self.name, "batch-queue").inc()
            return False
        return True

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        pending: collections.deque = collections.deque()  # misfits, served first
        group: list = []
        try:
            while True:
                first = pending.popleft() if pending else await self._queue.get()
                if not self._viable(first):
                    continue
                t_collect0 = loop.time()  # the batch-assembly stage starts here
                group = [first]
                key = self._key(first[0])
                rows = self._rows(first[0])
                # absorb compatible held-over items before waiting on the queue
                for item in list(pending):
                    if rows >= self.max_batch:
                        break
                    if self._key(item[0]) == key:
                        pending.remove(item)
                        if not self._viable(item):
                            continue
                        group.append(item)
                        rows += self._rows(item[0])

                def drain(total: int) -> int:
                    # what is already queued, without a timer per item
                    while total < self.max_batch:
                        try:
                            item = self._queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if self._key(item[0]) != key:
                            pending.append(item)  # the next group's seed
                            continue
                        if not self._viable(item):
                            continue
                        group.append(item)
                        total += self._rows(item[0])
                    return total

                rows = drain(rows)
                # the collection window, cut short by a full batch
                deadline = loop.time() + self.max_delay
                while rows < self.max_batch:
                    remaining = deadline - loop.time()
                    if remaining <= 0:
                        break
                    try:
                        item = await asyncio.wait_for(self._queue.get(), remaining)
                    except asyncio.TimeoutError:
                        break
                    if self._key(item[0]) != key:
                        pending.append(item)
                        continue
                    if not self._viable(item):
                        continue
                    group.append(item)
                    rows += self._rows(item[0])
                    rows = drain(rows)

                RECORDER.record_stage(STAGE_BATCH_ASSEMBLY, loop.time() - t_collect0)
                await self._sem.acquire()  # bound the in-flight pipeline
                task = loop.create_task(self._step(loop, group))
                self._inflight.add(task)
                task.add_done_callback(self._inflight.discard)
                group = []
        except asyncio.CancelledError:
            err = RuntimeError(f"BatchQueue {self.name!r} closed")
            for _, fut, _, _ in list(group) + list(pending):
                if not fut.done():
                    fut.set_exception(err)
            raise

    async def _step(self, loop, group) -> None:
        # a last sweep at the device boundary: the window may have outlived
        # a deadline
        group = [item for item in group if self._viable(item)]
        if not group:
            self._sem.release()
            return
        xs = [np.atleast_2d(x) for x, _, _, _ in group]
        batch = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        t_step0 = time.perf_counter()
        for _, _, t_enq, _ in group:
            RECORDER.record_stage(STAGE_QUEUE_WAIT, t_step0 - t_enq)
            self._m_queue_wait.observe(t_step0 - t_enq)
        self._m_batch_size.observe(batch.shape[0])
        split = [0.0]  # the host dispatch's seconds, from the pool thread
        try:
            try:
                cap = getattr(getattr(self.runner, "buckets", None), "max", None)
                if self._pipelined and (cap is None or batch.shape[0] <= cap):
                    def run_step(b=batch):
                        t_d0 = time.perf_counter()
                        handle = self._dispatch(b)
                        split[0] = time.perf_counter() - t_d0
                        return self._fetch(*handle)

                    out = await loop.run_in_executor(self._pool, run_step)
                else:
                    # an oversized group: the plain call chunks it
                    out = await loop.run_in_executor(self._pool, self.runner, batch)
            except asyncio.CancelledError:
                err: BaseException = RuntimeError(f"BatchQueue {self.name!r} closed")
                for _, fut, _, _ in group:
                    if not fut.done():
                        fut.set_exception(err)
                raise
            except Exception as exc:  # noqa: BLE001 - every waiter gets the step's error
                for _, fut, _, _ in group:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            step_s = time.perf_counter() - t_step0
            RECORDER.record_stage(STAGE_DEVICE_STEP, step_s)
            self._m_device_step.observe(step_s)
            record_host_sync(self.name)  # the step's one fetch
            dispatch_s = split[0]
            device_s = step_s - dispatch_s if 0 < dispatch_s < step_s else step_s
            METER.add(self.name, device_s=device_s)
            if dispatch_s > 0:
                RECORDER.record_stage(STAGE_DEVICE_DISPATCH, dispatch_s)
                self._m_device_frac.set(device_s / step_s if step_s > 0 else 0.0)
            self.last_step = (batch.shape[0], device_s)
            if self.flops_per_row and device_s > 0 and self._peak is not None:
                # the MFU against the step's device time (less the host's
                # dispatch), on the host's timestamps around the one fetch
                self._m_mfu.set(batch.shape[0] * self.flops_per_row / device_s / self._peak)
            self.steps += 1
            self.rows += batch.shape[0]
            out = np.asarray(out)
            offset = 0
            for (x, fut, _, _), rows in zip(group, (x.shape[0] for x in xs)):
                if not fut.done():
                    res = out[offset:offset + rows]
                    fut.set_result(res if x.ndim > 1 else res[0])
                offset += rows
        finally:
            self._sem.release()
