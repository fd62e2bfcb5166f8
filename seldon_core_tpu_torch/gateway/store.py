"""Deployment registry: the port's copy of the JAX package's
``gateway/store.py``.

oauth_key -> deployment record, with add/update/remove listeners — the
reference's DeploymentStore + DeploymentWatcher pair (reference:
api-frontend/.../deployments/DeploymentStore.java:33-84,
k8s/DeploymentWatcher.java:80-93).  Sources: programmatic (a caller puts
records in-process), a JSON file (``--deployments``), or the environment
(``GATEWAY_DEPLOYMENTS``, ``TEST_CLIENT_KEY``).  A record's ``endpoints``
list is its replica set (``disagg/router.py`` picks among them).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Any, Callable

log = logging.getLogger(__name__)

DEFAULT_ENGINE_REST_PORT = 8000
DEFAULT_ENGINE_GRPC_PORT = 5001


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One engine replica a deployment can be reached at."""

    host: str
    rest_port: int = DEFAULT_ENGINE_REST_PORT
    grpc_port: int = DEFAULT_ENGINE_GRPC_PORT

    @property
    def key(self) -> str:
        """Stable replica identity for pools/router state."""
        return f"{self.host}:{self.rest_port}"

    @classmethod
    def parse(cls, v: Any) -> "Endpoint":
        """Accept ``{"host": ..., "rest_port": ..., "grpc_port": ...}`` or
        the compact ``"host:rest[:grpc]"`` string form."""
        if isinstance(v, Endpoint):
            return v
        if isinstance(v, str):
            parts = v.split(":")
            if not parts[0]:
                raise ValueError(f"endpoint {v!r} has no host")
            rest = int(parts[1]) if len(parts) > 1 else DEFAULT_ENGINE_REST_PORT
            grpc = int(parts[2]) if len(parts) > 2 else DEFAULT_ENGINE_GRPC_PORT
            return cls(parts[0], rest, grpc)
        return cls(
            host=v["host"],
            rest_port=int(v.get("rest_port", DEFAULT_ENGINE_REST_PORT)),
            grpc_port=int(v.get("grpc_port", DEFAULT_ENGINE_GRPC_PORT)),
        )


@dataclasses.dataclass
class DeploymentRecord:
    """What the gateway needs to route to one SeldonDeployment."""

    name: str
    oauth_key: str
    oauth_secret: str
    engine_host: str = ""  # defaults to the deployment's service name
    engine_rest_port: int = DEFAULT_ENGINE_REST_PORT
    engine_grpc_port: int = DEFAULT_ENGINE_GRPC_PORT
    # the FULL replica set for multi-upstream routing (disagg/router.py);
    # empty means the single engine_host/port upstream — every single-
    # endpoint producer keeps working unchanged.  When set, the first
    # endpoint is the primary (rest_base/grpc_target compatibility).
    endpoints: tuple = ()
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    # identity of the deployment's SPEC, folded into every response-cache
    # key (docs/CACHING.md): a rolling update changes the hash, so stale
    # entries become unhittable even before the "updated" event flushes
    # them.  The CR watch stamps a hash over the full spec; records built
    # directly derive one from their own fields.
    spec_hash: str = ""

    def __post_init__(self) -> None:
        self.endpoints = tuple(Endpoint.parse(e) for e in self.endpoints)
        if self.endpoints and not self.engine_host:
            # primary mirrors the first replica so pre-multi-upstream call
            # sites (rest_base, grpc_target, _pool) stay coherent
            self.engine_host = self.endpoints[0].host
            self.engine_rest_port = self.endpoints[0].rest_port
            self.engine_grpc_port = self.endpoints[0].grpc_port
        if not self.spec_hash:
            from seldon_core_tpu_torch.cache.content import spec_hash as _spec_hash

            self.spec_hash = _spec_hash(
                {
                    "name": self.name,
                    "oauth_key": self.oauth_key,
                    "oauth_secret": self.oauth_secret,
                    "engine_host": self.engine_host,
                    "engine_rest_port": self.engine_rest_port,
                    "engine_grpc_port": self.engine_grpc_port,
                    "endpoints": [
                        [e.host, e.rest_port, e.grpc_port] for e in self.endpoints
                    ],
                    "annotations": self.annotations,
                }
            )

    @property
    def replica_endpoints(self) -> tuple:
        """The replica set to route across: the explicit endpoints list, or
        the single primary upstream wrapped as one Endpoint."""
        if self.endpoints:
            return self.endpoints
        return (
            Endpoint(
                self.engine_host or self.name,
                self.engine_rest_port,
                self.engine_grpc_port,
            ),
        )

    @property
    def rest_base(self) -> str:
        host = self.engine_host or self.name
        return f"http://{host}:{self.engine_rest_port}"

    @property
    def grpc_target(self) -> str:
        host = self.engine_host or self.name
        return f"{host}:{self.engine_grpc_port}"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DeploymentRecord":
        """Single-endpoint form (``engine_host``/ports) and multi-upstream
        form (``endpoints`` list of dicts or ``host:rest[:grpc]`` strings)
        both parse; given both, ``endpoints`` is the replica set and the
        scalar fields name the primary."""
        return cls(
            name=d["name"],
            oauth_key=d.get("oauth_key", d["name"]),
            oauth_secret=d.get("oauth_secret", ""),
            engine_host=d.get("engine_host", ""),
            engine_rest_port=int(d.get("engine_rest_port", DEFAULT_ENGINE_REST_PORT)),
            engine_grpc_port=int(d.get("engine_grpc_port", DEFAULT_ENGINE_GRPC_PORT)),
            endpoints=tuple(
                Endpoint.parse(e) for e in d.get("endpoints", ())
            ),
            annotations=dict(d.get("annotations", {})),
            spec_hash=str(d.get("spec_hash", "")),
        )


Listener = Callable[[str, DeploymentRecord], None]  # event, record


class DeploymentStore:
    """Thread-safe oauth_key -> record map with change listeners."""

    def __init__(self):
        self._by_key: dict[str, DeploymentRecord] = {}
        self._lock = threading.Lock()
        self._listeners: list[Listener] = []

    def add_listener(self, fn: Listener) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn: Listener) -> None:
        """Deregister (no-op when absent) — a closed gRPC handler must not
        keep receiving events and scheduling work on a dead loop."""
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _emit(self, event: str, rec: DeploymentRecord) -> None:
        for fn in self._listeners:
            try:
                fn(event, rec)
            except Exception:  # listeners must not break the control path
                log.exception("deployment listener failed")

    def put(self, rec: DeploymentRecord) -> None:
        with self._lock:
            existing = self._by_key.get(rec.oauth_key)
            self._by_key[rec.oauth_key] = rec
        self._emit("updated" if existing else "added", rec)

    def remove(self, oauth_key: str) -> None:
        with self._lock:
            rec = self._by_key.pop(oauth_key, None)
        if rec is not None:
            self._emit("removed", rec)

    def get(self, oauth_key: str) -> DeploymentRecord | None:
        with self._lock:
            return self._by_key.get(oauth_key)

    def list(self) -> list[DeploymentRecord]:
        with self._lock:
            return list(self._by_key.values())

    # -- file source -------------------------------------------------------

    def load_file(self, path: str) -> int:
        """Replace contents from a JSON file ``[{name, oauth_key, ...}]``.
        Returns the number of deployments loaded; removes absent ones."""
        with open(path) as f:
            raw = json.load(f)
        records = [DeploymentRecord.from_dict(d) for d in raw]
        new_keys = {r.oauth_key for r in records}
        for rec in self.list():
            if rec.oauth_key not in new_keys:
                self.remove(rec.oauth_key)
        for rec in records:
            existing = self.get(rec.oauth_key)
            if existing != rec:
                self.put(rec)
        return len(records)


class EndpointDiff:
    """Old-vs-new replica-set diff for store listeners.

    Listeners only receive the NEW record, so a front that holds
    per-replica state (warm H1 pools, gRPC channels, router digests and
    breaker windows) tracks the last-seen endpoint keys here and evicts
    ONLY the replicas that actually left.  Survivors keep their warm
    state across an autoscale event — a 7-replica pool shrinking to 6
    must not cold-start the other 6 connections.
    """

    def __init__(self) -> None:
        self._keys: dict[str, set[str]] = {}
        self._spec_hash: dict[str, str] = {}

    def seed(self, records) -> None:
        """Prime the tracker with records that predate the listener —
        a front constructed against a populated store must still diff
        that first update instead of seeing an empty prior set."""
        for rec in records:
            self.removed("added", rec)
            self.spec_changed("added", rec)

    def removed(self, event: str, rec: DeploymentRecord) -> set[str]:
        """Replica keys present last time that are gone now (all of them
        on a ``removed`` event).  Also refreshes the tracked set."""
        old = self._keys.get(rec.oauth_key, set())
        if event == "removed":
            self._keys.pop(rec.oauth_key, None)
            return old
        new = {ep.key for ep in rec.replica_endpoints}
        self._keys[rec.oauth_key] = new
        return old - new

    def spec_changed(self, event: str, rec: DeploymentRecord) -> bool:
        """True when the record's spec hash rolled (or on removal).
        Drives the response-cache namespace flush: endpoint-only churn
        keeps the hash (the CR watch excludes the replica-set annotation
        from it), so scaling never dumps a deployment's cache."""
        if event == "removed":
            self._spec_hash.pop(rec.oauth_key, None)
            return True
        prev = self._spec_hash.get(rec.oauth_key)
        self._spec_hash[rec.oauth_key] = rec.spec_hash
        # unknown prior state flushes too — missing a flush serves stale
        # responses; an extra one costs a few cache misses
        return prev is None or prev != rec.spec_hash


def load_store_from_env(store: DeploymentStore, environ: dict | None = None) -> None:
    """Standalone bootstrap: ``GATEWAY_DEPLOYMENTS`` (JSON or path) and/or
    ``TEST_CLIENT_KEY``/``TEST_CLIENT_SECRET`` creating a localhost
    deployment (reference: AuthorizationServerConfiguration.java:80-95's
    TEST_CLIENT_KEY fake deployment)."""
    env = environ if environ is not None else os.environ
    raw = env.get("GATEWAY_DEPLOYMENTS", "")
    if raw:
        if os.path.exists(raw):
            store.load_file(raw)
        else:
            for d in json.loads(raw):
                store.put(DeploymentRecord.from_dict(d))
    test_key = env.get("TEST_CLIENT_KEY", "")
    if test_key:
        store.put(
            DeploymentRecord(
                name="test-deployment",
                oauth_key=test_key,
                oauth_secret=env.get("TEST_CLIENT_SECRET", "secret"),
                engine_host="127.0.0.1",
            )
        )
