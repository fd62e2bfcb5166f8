"""Observability: the span recorder, the per-stage flight recorder
(``obs/spans.py``) and the usage meter (``obs/metering.py``).  ``RECORDER``
and ``METER`` are the process-wide instances."""

from __future__ import annotations

from seldon_core_tpu_torch.obs.metering import METER, UsageMeter, get_meter  # noqa: F401
from seldon_core_tpu_torch.obs.spans import (  # noqa: F401
    RECORDER,
    STAGE_BATCH_ASSEMBLY,
    STAGE_DEVICE_DISPATCH,
    STAGE_DEVICE_STEP,
    STAGE_ENGINE_ROUTE,
    STAGE_GATEWAY_RELAY,
    STAGE_NODE,
    STAGE_QUEUE_WAIT,
    STAGE_STREAM_FLUSH,
    STAGE_TTFT,
    STAGES,
    Span,
    SpanRecorder,
    current_span,
)
