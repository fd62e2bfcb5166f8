"""Graph-unit adapter for a compiled zoo model: the port of the JAX
package's ``executor/component.py`` (``JaxModelComponent``).

Makes a :class:`CompiledModel`, behind a :class:`BatchQueue` or called
directly, obey the component contract (``predict(X, names)``), so a
``JAX_MODEL`` unit sits in an inference graph beside routers, combiners
and transformers.
"""

from __future__ import annotations

import asyncio
from typing import Any

import numpy as np
import torch

from seldon_core_tpu_torch.executor.batcher import BatchQueue
from seldon_core_tpu_torch.executor.compiled import CompiledModel
from seldon_core_tpu_torch.graph.units import GraphUnitError, SeldonComponent


class ModelComponent(SeldonComponent):
    # metrics() reads cumulative counters, safe to read concurrently; without
    # this the walker's annotation lock would serialize the batching pipeline
    SAFE_ANNOTATIONS = True
    # a forward is a pure function of its rows
    DETERMINISTIC = True

    def __init__(
        self,
        model: CompiledModel,
        *,
        class_names: list[str] | None = None,
        batching: bool = True,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        max_queue: int | None = None,
        warmup_example: np.ndarray | None = None,
    ):
        self.model = model
        self.warmup_example = warmup_example
        if class_names is not None:
            self.class_names = class_names
        self.queue = (
            BatchQueue(model, max_batch=max_batch, max_delay_ms=max_delay_ms,
                       name=model.name, maxsize=max_queue)
            if batching else None
        )

    def warmup(self) -> int:
        """Capture (on the card) every batch bucket in the warm-up example's
        row shape and dtype; returns the bucket count (0 without an
        example).  Readiness waits for it, so no request pays a capture."""
        if self.warmup_example is None:
            return 0
        ex = np.asarray(self.warmup_example)
        if self.queue is not None and self.queue.flops_per_row is None:
            # the MFU gauge's FLOPs: the roofline's count of one row's forward
            # in the warm-up example's shape
            from seldon_core_tpu_torch.utils.roofline import count_flops

            x = torch.from_numpy(np.ascontiguousarray(self.model._host_batch(ex[:1])))
            x = x.to(self.model.device)
            self.queue.flops_per_row = float(count_flops(lambda: self.model._forward(x))[0])
        return self.model.warmup(ex.shape[1:], ex.dtype)

    def warmup_variants(self) -> list[str]:
        """The programs warmup made: one a batch bucket."""
        return [f"bucket:{b}" for b in self.model.buckets.sizes]

    async def predict(self, X: np.ndarray, names: list[str]) -> np.ndarray:
        X = np.asarray(X)
        try:
            # checked alone: a bad request must not fail its batch-mates' step
            self.model.check(np.atleast_2d(X))
        except ValueError as e:
            raise GraphUnitError(f"{self.model.name}: {e}") from e
        if self.queue is not None:
            return await self.queue.submit(X)
        return await asyncio.to_thread(self.model, X)

    def metrics(self) -> list[dict[str, Any]]:
        if self.queue is None:
            return []
        # cumulative totals as GAUGEs (a COUNTER is added per request)
        return [
            {"key": f"{self.model.name}_device_steps", "type": "GAUGE", "value": self.queue.steps},
            {"key": f"{self.model.name}_device_rows", "type": "GAUGE", "value": self.queue.rows},
        ]

    async def close(self) -> None:
        if self.queue is not None:
            await self.queue.close()
