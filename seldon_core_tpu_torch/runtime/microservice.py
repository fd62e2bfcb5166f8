"""The microservice entry point: the port's copy of the JAX package's
``runtime/microservice.py``, with the reference wrapper's command line:

    python -m seldon_core_tpu_torch.runtime.microservice <module or module.Class> REST \
        --service-type MODEL --parameters '[{"name": ..., "value": ..., "type": ...}]' \
        --port 9000 --persistence 0|1

The user's module is imported from the Python path (the working directory
first, under ``python -m``).  The environment contract is the operator's:
``PREDICTIVE_UNIT_SERVICE_PORT`` (the port), ``PREDICTIVE_UNIT_PARAMETERS``
(the parameters) and ``PREDICTIVE_UNIT_ID`` (the unit's name), with
``PREDICTOR_ID`` and ``SELDON_DEPLOYMENT_ID`` in the persistence key.
``--persistence 1`` restores the component's saved state at boot and
snapshots it every ``PERSISTENCE_FREQUENCY`` seconds and at exit
(``runtime/persistence.py``).  ``GRPC`` serves the component on the h2
gRPC data plane (``runtime/grpc_service.py``); ``SCT_GRPC_IMPL=grpcio``
raises by name.
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
from typing import Any

from seldon_core_tpu_torch.contract.parameters import parse_parameters

log = logging.getLogger(__name__)

SERVICE_TYPES = ("MODEL", "ROUTER", "TRANSFORMER", "COMBINER", "OUTLIER_DETECTOR")


def load_component(interface_name: str, parameters: dict[str, Any]) -> Any:
    """Import ``module`` or ``module.Class`` (a bare module name names a class
    of the same name in it) and build it with the typed parameters."""
    if "." in interface_name:
        module_name, class_name = interface_name.rsplit(".", 1)
    else:
        module_name = class_name = interface_name
    cls = getattr(importlib.import_module(module_name), class_name)
    return cls(**parameters)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-core-tpu model microservice on PyTorch")
    parser.add_argument("interface_name", help="user module or module.Class")
    parser.add_argument("api_type", nargs="?", default="REST", choices=["REST", "GRPC"])
    parser.add_argument("--service-type", default="MODEL", choices=SERVICE_TYPES)
    parser.add_argument("--parameters", default=os.environ.get("PREDICTIVE_UNIT_PARAMETERS", "[]"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", "9000")))
    parser.add_argument("--persistence", type=int, default=0)
    args = parser.parse_args(argv)
    if args.api_type == "GRPC":
        from seldon_core_tpu_torch.proto.grpc_defs import use_grpcio

        use_grpcio()  # raises by name before the user's module loads

    logging.basicConfig(level=logging.INFO)
    component = load_component(args.interface_name,
                               parse_parameters(json.loads(args.parameters)))
    name = os.environ.get("PREDICTIVE_UNIT_ID", args.interface_name)
    if args.service_type == "OUTLIER_DETECTOR":
        from seldon_core_tpu_torch.runtime.outlier import OutlierDetectorAdapter

        component = OutlierDetectorAdapter(component)
    if args.persistence:
        from seldon_core_tpu_torch.runtime.persistence import start_persistence

        component = start_persistence(component, name)

    if args.api_type == "GRPC":
        from seldon_core_tpu_torch.runtime.grpc_service import serve_grpc

        serve_grpc(component, args.port, name=name, service_type=args.service_type)
        return
    from seldon_core_tpu_torch.runtime.server import serve

    serve(component, args.port, name=name, service_type=args.service_type)


if __name__ == "__main__":
    main()
