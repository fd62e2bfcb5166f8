"""The data-plane contract: payloads and their JSON and protobuf wire codecs."""

from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    feedback_from_dict,
    feedback_from_proto,
    feedback_to_dict,
    feedback_to_proto,
    payload_from_dict,
    payload_from_json,
    payload_from_proto,
    payload_to_dict,
    payload_to_proto,
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
    "failure_status_dict", "feedback_from_dict", "feedback_from_proto", "feedback_to_dict",
    "feedback_to_proto", "payload_from_dict", "payload_from_json", "payload_from_proto",
    "payload_to_dict", "payload_to_proto",
]
