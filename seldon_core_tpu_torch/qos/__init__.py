"""Request-scoped QoS context: the deadline and priority a request carries
through the graph (``qos/context.py``), and the shed decisions a request
can meet before its device step (``qos/admission.py``)."""

from seldon_core_tpu_torch.qos.admission import DeadlineExceeded, QueueFull  # noqa: F401

from seldon_core_tpu_torch.qos.context import (  # noqa: F401
    DEADLINE_HEADER,
    PRIO_BATCH,
    PRIO_INTERACTIVE,
    PRIORITY_HEADER,
    expired,
    get_deadline,
    get_priority,
    outgoing_qos_headers,
    parse_deadline_ms,
    parse_priority,
    remaining_s,
    seed_from_headers,
    set_budget_ms,
    set_deadline,
    set_priority,
)
