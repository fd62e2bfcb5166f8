"""The prediction wire contract on the stdlib: the proto3 messages
(``proto/prediction.py``) and the gRPC service table (``proto/grpc_defs.py``)."""

from seldon_core_tpu_torch.proto import prediction

__all__ = ["prediction"]
