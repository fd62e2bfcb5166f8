"""External API gateway ("apife"): the port's copy of the JAX package's
``gateway/`` on the stdlib alone.

* :mod:`store`     deployment registry + change listeners (a JSON file, the
                   environment, or records put in-process); a record's
                   ``endpoints`` are its engine replicas
* :mod:`auth`      client-credentials token service (in-process TTL store, or
                   a shared one over ``runtime/persistence.py``)
* :mod:`app`       :class:`GatewayApp`'s transport-independent cores: token
                   issuance, ingress (auth, QoS, cache, forward with retry
                   budget and replica pick), tap, reward counters, the
                   ``/stats/*`` snapshots, and ``main()``
* :mod:`h1gateway` the h1 splice front: the REST data plane
* :mod:`tap`       request/response firehose (taplog broker or JSONL)

The replica router is ``disagg/router.py``; the fleet collector
``obs/fleet.py``.  The gRPC gateway and the CR watch are not ported yet.
"""

from seldon_core_tpu_torch.gateway.auth import AuthError, TokenStore
from seldon_core_tpu_torch.gateway.store import DeploymentRecord, DeploymentStore, Endpoint

__all__ = ["DeploymentRecord", "DeploymentStore", "Endpoint", "AuthError", "TokenStore"]
