"""The QoS plane: the deadline and priority a request carries through the
graph (``qos/context.py``) and admission control with SLO-aware shedding
(``qos/admission.py``)."""

from seldon_core_tpu_torch.qos.admission import (  # noqa: F401
    AdmissionController,
    BrownoutShed,
    DeadlineExceeded,
    PredictedSloMiss,
    QosRejection,
    QueueFull,
    RateLimited,
    TokenBucket,
    active_controller,
    clamp_max_new_tokens,
    note_deadline_miss,
    set_active_controller,
)
from seldon_core_tpu_torch.qos.context import (  # noqa: F401
    DEADLINE_HEADER,
    PRIO_BATCH,
    PRIO_INTERACTIVE,
    PRIORITY_HEADER,
    expired,
    get_deadline,
    get_priority,
    get_retry_after,
    outgoing_qos_headers,
    pack_slo_ms,
    parse_deadline_ms,
    parse_priority,
    priority_rank,
    remaining_s,
    seed_from_headers,
    set_budget_ms,
    set_deadline,
    set_priority,
    set_retry_after,
)
