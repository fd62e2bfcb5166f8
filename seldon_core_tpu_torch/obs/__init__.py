"""Observability: the span recorder and flight recorder (``obs/spans.py``),
the usage meter (``obs/metering.py``), wire accounting (``obs/wire.py``),
the always-on probes (``obs/probes.py``), per-request timelines
(``obs/timeline.py``) and the span exporters (``obs/export.py``).
``RECORDER``, ``METER``, ``WIRE``, ``LOOP_LAG`` and ``TIMELINE`` are the
process-wide instances."""

from __future__ import annotations

from seldon_core_tpu_torch.obs.metering import METER, UsageMeter, get_meter  # noqa: F401
from seldon_core_tpu_torch.obs.probes import (  # noqa: F401
    LOOP_LAG,
    EventLoopLagProbe,
    host_sync_snapshot,
    install_obs_gauges,
    record_host_sync,
)
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
    current_engine_role,
    current_span,
    set_engine_role,
    set_process_role,
)
from seldon_core_tpu_torch.obs.timeline import TIMELINE, Timeline, TimelineLedger  # noqa: F401
from seldon_core_tpu_torch.obs.wire import (  # noqa: F401
    WIRE,
    WIRE_ENGINE_GRPC,
    WIRE_ENGINE_NODE,
    WIRE_ENGINE_REST,
    WIRE_GATEWAY_GRPC,
    WIRE_GATEWAY_H1,
    WIRE_GATEWAY_REST,
    WIRE_STAGES,
    WireCounter,
    WireRecorder,
)


_exporter_users = 0  # the engines of this process that configured exporters


def configure_exporters_from_env(recorder: SpanRecorder | None = None) -> list:
    """Attach the exporters the environment selects (once: a recorder that
    has exporters keeps them) and bind the span ring's and exporters'
    gauges.  Called at an engine's boot; each call counts a user that
    :func:`close_exporters` releases."""
    from seldon_core_tpu_torch.obs.export import exporters_from_env

    global _exporter_users
    rec = recorder or RECORDER
    if not rec.exporters:
        rec.exporters = exporters_from_env()
    _exporter_users += 1
    install_obs_gauges()
    return rec.exporters


async def close_exporters(recorder: SpanRecorder | None = None) -> None:
    """Release one user; the last one flushes briefly, closes and detaches
    the exporters (an engine's close)."""
    global _exporter_users
    _exporter_users = max(0, _exporter_users - 1)
    if _exporter_users:
        return
    rec = recorder or RECORDER
    exporters, rec.exporters = rec.exporters, []
    for exp in exporters:
        await exp.close()


def wire_stats_payload() -> dict:
    """The ``GET /stats/wire`` body: each edge's bytes and MB/s, the event
    loop's lag and the host syncs by model."""
    return {
        "wire": WIRE.snapshot(),
        "loop_lag": LOOP_LAG.snapshot(),
        "host_syncs": host_sync_snapshot(),
    }
