"""Stateful-component persistence, periodic snapshot and restore at boot:
the port's copy of the JAX package's ``runtime/persistence.py``.

Stateful graph units (bandit routers, online outlier detectors) gather
state across requests; without persistence a restart resets them.  The
reference wrapper pickles the whole user object to Redis on a timer
thread and restores it at boot.  Here the same contract is
store-agnostic:

- ``FileStateStore`` (default): atomic pickle files on a mounted volume;
- ``MemoryStateStore``: process-global, for tests and embedded use;
- ``RedisStateStore``: the reference's Redis layout, gated on the
  ``redis`` package being installed (it raises by name without it).

Components may opt into *partial* snapshots by defining ``get_state() ->
picklable`` / ``set_state(state)``; otherwise the whole object is pickled,
as the reference does.  The snapshot key is
``persistence_{deployment}_{predictor}_{unit}`` from the operator's
environment contract.
"""

from __future__ import annotations

import atexit
import logging
import os
import pickle
import tempfile
import threading
from typing import Any, Callable, Protocol

log = logging.getLogger(__name__)

DEFAULT_PUSH_FREQUENCY = 60.0  # seconds, as the reference wrapper


def state_key(name: str | None = None) -> str:
    """``persistence_{deployment}_{predictor}_{unit}`` (the reference's key
    layout); ``name`` overrides the unit id for standalone runs."""
    unit = name or os.environ.get("PREDICTIVE_UNIT_ID", "0")
    predictor = os.environ.get("PREDICTOR_ID", "0")
    deployment = os.environ.get("SELDON_DEPLOYMENT_ID", "0")
    return f"persistence_{deployment}_{predictor}_{unit}"


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------

class StateStore(Protocol):
    def get(self, key: str) -> bytes | None: ...

    def set(self, key: str, data: bytes) -> None: ...

    def delete(self, key: str) -> None: ...

    def close(self) -> None: ...


class MemoryStateStore:
    """Process-global store; instances with the same ``namespace`` share
    contents."""

    _spaces: dict[str, dict[str, bytes]] = {}
    _lock = threading.Lock()

    def __init__(self, namespace: str = "default"):
        with MemoryStateStore._lock:
            self._data = MemoryStateStore._spaces.setdefault(namespace, {})

    def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    def set(self, key: str, data: bytes) -> None:
        self._data[key] = data

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def close(self) -> None:
        pass


class FileStateStore:
    """One file per key under ``root``; writes are atomic (tmp + rename) so a
    crash mid-snapshot can never corrupt the last good state."""

    def __init__(self, root: str):
        self.root = root
        # 0700: snapshots are unpickled on restore — other local users must
        # not be able to plant files here
        os.makedirs(root, mode=0o700, exist_ok=True)
        # makedirs(exist_ok=True) is a no-op on a pre-existing directory, so
        # an attacker who pre-created it (e.g. under the predictable /tmp
        # default) could own it or leave it group/world-writable and plant
        # snapshots that restore() unpickles.  Refuse such a directory.
        st = os.stat(root)
        if st.st_uid != os.getuid():
            raise PermissionError(
                f"state dir {root!r} is owned by uid {st.st_uid}, not us "
                f"({os.getuid()}); refusing to unpickle snapshots from it"
            )
        if st.st_mode & 0o022:
            os.chmod(root, st.st_mode & ~0o022)

    def _path(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        return os.path.join(self.root, safe + ".pkl")

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def set(self, key: str, data: bytes) -> None:
        path = self._path(key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass

    def close(self) -> None:
        pass


class RedisStateStore:
    """Reference-compatible Redis store (same keys, pickled values).  Only
    importable when the ``redis`` package is installed in the image."""

    def __init__(
        self,
        host: str | None = None,
        port: int | None = None,
        password: str | None = None,
    ):
        try:
            import redis  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - env without redis
            raise RuntimeError(
                "RedisStateStore requires the 'redis' package; use "
                "PERSISTENCE_STORE=file:<dir> on images without it"
            ) from e
        host = host or os.environ.get("REDIS_SERVICE_HOST", "localhost")
        port = int(port or os.environ.get("REDIS_SERVICE_PORT", 6379))
        password = password or os.environ.get("REDIS_PASSWORD") or None
        self._client = redis.StrictRedis(host=host, port=port, password=password)

    def get(self, key: str) -> bytes | None:
        return self._client.get(key)

    def set(self, key: str, data: bytes) -> None:
        self._client.set(key, data)

    def delete(self, key: str) -> None:
        self._client.delete(key)

    def close(self) -> None:
        self._client.close()


def store_from_env(environ: dict | None = None) -> StateStore:
    """``PERSISTENCE_STORE``: ``memory``, ``redis://[host[:port]]``,
    ``file:<dir>`` or a bare directory path.  Default: file store under
    ``PERSISTENCE_DIR`` (falls back to a per-uid 0700 tmp dir — snapshots
    are unpickled on restore, so the directory must not be writable by other
    local users; in k8s, mount a volume there)."""
    env = environ if environ is not None else os.environ
    raw = env.get("PERSISTENCE_STORE", "")
    if raw == "memory":
        return MemoryStateStore()
    if raw.startswith("redis://"):
        # redis://[:password@]host[:port] — auth'd stores keep tokens off
        # the open cluster network (deploy/redis.yaml pairs this with
        # --requirepass).  urlsplit separates username/password properly:
        # 'redis://user:@host' must not smuggle 'user:' in as the password,
        # and a username is rejected loudly (Redis AUTH here is
        # password-only) instead of silently dropped.
        from urllib.parse import urlsplit

        parts = urlsplit(raw)
        if parts.username:
            raise ValueError(
                "PERSISTENCE_STORE redis:// URLs take ':password@' only "
                f"(got username {parts.username!r}; Redis AUTH is "
                "password-based)"
            )
        return RedisStateStore(
            parts.hostname or None,
            parts.port,
            password=parts.password or None,
        )
    if raw.startswith("file:"):
        return FileStateStore(raw[len("file:"):])
    if raw:
        return FileStateStore(raw)
    default_dir = env.get(
        "PERSISTENCE_DIR",
        os.path.join(
            tempfile.gettempdir(), f"seldon-core-tpu-state-{os.getuid()}"
        ),
    )
    return FileStateStore(default_dir)


# ---------------------------------------------------------------------------
# Snapshot / restore
# ---------------------------------------------------------------------------

_STATE_MARKER = "__sct_component_state__"


def dump_component(component: Any) -> bytes:
    """Pickle a component.  ``get_state()`` (when defined) narrows the
    snapshot to explicit state — safer for components holding unpicklable
    resources (device buffers, sessions)."""
    if hasattr(component, "get_state"):
        return pickle.dumps({_STATE_MARKER: component.get_state()})
    return pickle.dumps(component)


def load_component(data: bytes, fallback: Any = None) -> Any:
    """Inverse of :func:`dump_component`.  Partial snapshots are applied to
    ``fallback`` via ``set_state``; whole-object snapshots replace it."""
    obj = pickle.loads(data)
    if isinstance(obj, dict) and _STATE_MARKER in obj:
        if fallback is None or not hasattr(fallback, "set_state"):
            raise ValueError(
                "snapshot holds partial state but component has no set_state()"
            )
        fallback.set_state(obj[_STATE_MARKER])
        return fallback
    return obj


def restore(
    factory: Callable[[], Any],
    name: str | None = None,
    store: StateStore | None = None,
) -> Any:
    """Build the component, restoring saved state when present (no saved
    state means plain construction)."""
    store = store or store_from_env()
    data = store.get(state_key(name))
    component = factory()
    if data is None:
        return component
    try:
        return load_component(data, fallback=component)
    except Exception:
        log.exception("state restore failed; starting fresh")
        return component


class PersistenceThread(threading.Thread):
    """Daemon timer thread snapshotting the component every
    ``push_frequency`` seconds, plus a final flush on stop so that a
    SIGTERM never loses the last interval."""

    def __init__(
        self,
        component: Any,
        key: str,
        store: StateStore,
        push_frequency: float = DEFAULT_PUSH_FREQUENCY,
    ):
        super().__init__(daemon=True, name=f"persistence-{key}")
        self.component = component
        self.key = key
        self.store = store
        self.push_frequency = push_frequency
        self._stop_event = threading.Event()

    def flush(self) -> None:
        try:
            self.store.set(self.key, dump_component(self.component))
        except Exception:
            log.exception("state snapshot failed for %s", self.key)

    def stop(self) -> None:
        self._stop_event.set()
        self.flush()

    def run(self) -> None:
        while not self._stop_event.wait(self.push_frequency):
            self.flush()


def start_persistence(
    component: Any,
    name: str | None = None,
    *,
    store: StateStore | None = None,
    push_frequency: float | None = None,
) -> Any:
    """Restore ``component``'s saved state (if any), start the snapshot
    thread, and register a shutdown flush.  Returns the (possibly replaced)
    component — the microservice entry point serves this object."""
    store = store or store_from_env()
    if push_frequency is None:
        push_frequency = float(
            os.environ.get("PERSISTENCE_FREQUENCY", DEFAULT_PUSH_FREQUENCY)
        )
    key = state_key(name)
    data = store.get(key)
    if data is not None:
        try:
            component = load_component(data, fallback=component)
            log.info("restored component state from %s", key)
        except Exception:
            log.exception("state restore failed; starting fresh")
    thread = PersistenceThread(component, key, store, push_frequency)
    thread.start()
    atexit.register(thread.stop)
    return component
