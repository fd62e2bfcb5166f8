"""The data-plane contract: payloads and their JSON wire codec."""

from seldon_core_tpu_torch.contract.codec import (
    CodecError,
    failure_status_dict,
    payload_from_dict,
    payload_from_json,
    payload_to_dict,
)
from seldon_core_tpu_torch.contract.payload import DataKind, Meta, Metric, Payload

__all__ = [
    "CodecError", "DataKind", "Meta", "Metric", "Payload", "failure_status_dict",
    "payload_from_dict", "payload_from_json", "payload_to_dict",
]
