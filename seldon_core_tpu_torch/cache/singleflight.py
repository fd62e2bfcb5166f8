"""Request collapsing: identical requests in flight at once share one
computation.  The port's copy of the JAX package's ``cache/singleflight.py``.

A herd of N identical requests on a cold cache would cost N graph walks;
with single-flight the first is the leader and computes, the other N-1
are followers that await its future.  The response cache answers "computed
recently", this answers "being computed now".
"""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable


class SingleFlight:
    """Collapser of one event loop: ``do(key, fn)`` runs ``fn`` once a key at
    a time; callers with the same key meanwhile share its result.

    A leader's exception reaches every follower.  A CANCELLED leader (its
    client left) fails its followers too: they retry, rather than one of
    them taking over a computation admitted under another request's
    ticket."""

    def __init__(self):
        self._inflight: dict[Any, asyncio.Future] = {}
        self.leaders = 0
        self.collapsed = 0
        self.collapsed_errors = 0

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    async def do(self, key: Any, fn: Callable[[], Awaitable[Any]]) -> Any:
        existing = self._inflight.get(key)
        if existing is not None:
            self.collapsed += 1
            try:
                # shielded: one follower leaving must not cancel the others'
                return await asyncio.shield(existing)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.collapsed_errors += 1
                raise
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # retrieve the exception even when no follower awaited it
        fut.add_done_callback(lambda f: f.exception() if not f.cancelled() else None)
        self._inflight[key] = fut
        self.leaders += 1
        try:
            result = await fn()
        except BaseException as e:
            if not fut.done():
                fut.set_exception(asyncio.CancelledError("single-flight leader cancelled")
                                  if isinstance(e, asyncio.CancelledError) else e)
            raise
        else:
            if not fut.done():
                fut.set_result(result)
            return result
        finally:
            self._inflight.pop(key, None)

    def snapshot(self) -> dict:
        return {
            "inflight": len(self._inflight),
            "leaders": self.leaders,
            "collapsed": self.collapsed,
            "collapsed_errors": self.collapsed_errors,
        }
