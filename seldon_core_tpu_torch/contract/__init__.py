"""The data-plane contract: payloads and their JSON wire codec."""

from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    feedback_from_dict,
    feedback_to_dict,
    payload_from_dict,
    payload_from_json,
    payload_to_dict,
)
from seldon_core_tpu_torch.contract.payload import (
    DataKind,
    FeedbackPayload,
    Meta,
    Metric,
    Payload,
)

__all__ = [
    "CodecError", "DataKind", "FeedbackPayload", "Meta", "Metric", "Payload",
    "failure_status_dict", "feedback_from_dict", "feedback_to_dict", "payload_from_dict",
    "payload_from_json", "payload_to_dict",
]
