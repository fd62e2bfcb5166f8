"""Client-credentials token service: the port's copy of the JAX package's
``gateway/auth.py``.

The reference runs a full Spring Security OAuth2 stack with a Redis token
store (reference: api-frontend/.../config/AuthorizationServerConfiguration.
java:64-67, api/oauth/*).  The contract that matters to clients is small:

    POST /oauth/token  grant_type=client_credentials  (HTTP basic or form
    key/secret)  ->  {"access_token": ..., "expires_in": ...}

and every data request carries ``Authorization: Bearer <token>``.  This
module implements that contract with an in-process TTL store; a shared
(multi-replica) store can replace it behind the same interface.
"""

from __future__ import annotations

import hmac
import secrets
import threading
import time


class AuthError(Exception):
    def __init__(self, reason: str, status: int = 401):
        super().__init__(reason)
        self.status = status


class TokenStore:
    def __init__(self, ttl_s: float = 43200.0, clock=time.monotonic):
        self.ttl_s = ttl_s
        self._clock = clock
        self._tokens: dict[str, tuple[str, float]] = {}  # token -> (key, expiry)
        self._lock = threading.Lock()

    def issue(self, oauth_key: str) -> tuple[str, float]:
        """-> (token, expires_in_seconds).  Caller has already verified the
        client secret against the deployment record."""
        self.purge_expired()  # issuance is the natural purge point: clients
        # that fetch a token per job would otherwise grow the store forever
        token = secrets.token_urlsafe(32)
        expiry = self._clock() + self.ttl_s
        with self._lock:
            self._tokens[token] = (oauth_key, expiry)
        return token, self.ttl_s

    def principal(self, token: str) -> str:
        """-> oauth_key for a live token; raises AuthError otherwise."""
        with self._lock:
            entry = self._tokens.get(token)
            if entry is None:
                raise AuthError("invalid access token")
            key, expiry = entry
            if self._clock() >= expiry:
                del self._tokens[token]
                raise AuthError("token expired")
            return key

    def revoke_for_key(self, oauth_key: str) -> None:
        """Drop every token of a removed deployment."""
        with self._lock:
            self._tokens = {
                t: (k, e) for t, (k, e) in self._tokens.items() if k != oauth_key
            }

    def purge_expired(self) -> int:
        now = self._clock()
        with self._lock:
            dead = [t for t, (_, e) in self._tokens.items() if now >= e]
            for t in dead:
                del self._tokens[t]
        return len(dead)


class SharedTokenStore:
    """Token store backed by a shared :class:`~seldon_core_tpu_torch.runtime.
    persistence.StateStore`, so N gateway replicas accept each other's
    tokens — the role Redis plays for the reference's apife (reference:
    AuthorizationServerConfiguration.java:64-67 RedisTokenStore).

    Record layout: ``token_<token>`` -> JSON ``{key, expiry, issued}``
    (wall-clock epoch seconds — replicas don't share a monotonic clock).
    Revocation is O(1) without key scans: ``revoked_<oauth_key>`` holds an
    epoch; tokens issued at or before it are dead.
    """

    def __init__(self, store, ttl_s: float = 43200.0, clock=time.time):
        self.store = store
        self.ttl_s = ttl_s
        self._clock = clock

    def issue(self, oauth_key: str) -> tuple[str, float]:
        import json

        token = secrets.token_urlsafe(32)
        now = self._clock()
        self.store.set(
            f"token_{token}",
            json.dumps(
                {"key": oauth_key, "expiry": now + self.ttl_s, "issued": now}
            ).encode(),
        )
        return token, self.ttl_s

    def principal(self, token: str) -> str:
        import json

        raw = self.store.get(f"token_{token}")
        if raw is None:
            raise AuthError("invalid access token")
        try:
            rec = json.loads(raw)
        except json.JSONDecodeError:
            raise AuthError("invalid access token") from None
        now = self._clock()
        if now >= rec["expiry"]:
            self.store.delete(f"token_{token}")
            raise AuthError("token expired")
        revoked = self.store.get(f"revoked_{rec['key']}")
        if revoked is not None and rec["issued"] <= float(revoked):
            raise AuthError("invalid access token")
        return rec["key"]

    def revoke_for_key(self, oauth_key: str) -> None:
        self.store.set(f"revoked_{oauth_key}", str(self._clock()).encode())

    def purge_expired(self) -> int:
        return 0  # shared stores expire by read; Redis would use TTLs


def token_store_from_env(environ: dict | None = None):
    """``GATEWAY_TOKEN_STORE``: unset = in-process :class:`TokenStore`;
    otherwise a ``PERSISTENCE_STORE``-style spec (``memory``,
    ``redis://host``, ``file:<dir>``) for a :class:`SharedTokenStore`."""
    import os

    env = environ if environ is not None else os.environ
    raw = env.get("GATEWAY_TOKEN_STORE", "")
    if not raw:
        return TokenStore()
    from seldon_core_tpu_torch.runtime.persistence import store_from_env

    return SharedTokenStore(store_from_env({"PERSISTENCE_STORE": raw}))


def verify_secret(expected: str, provided: str) -> bool:
    """Constant-time secret comparison."""
    return hmac.compare_digest(expected.encode(), provided.encode())
