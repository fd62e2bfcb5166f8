"""Per-loop-iteration write coalescing: the port's copy of the JAX
package's ``wire/iobuf.py``.

An asyncio ``call_soon`` scheduled from inside a protocol callback runs in
the same loop iteration, before the next poll, so queueing writes and
flushing once per iteration adds no latency while every frame made by one
batch of events leaves in a single syscall.

Ordering rule: once a connection uses ``queue_write``, every write on that
transport must go through it (a direct ``transport.write`` would overtake
queued bytes), and ``flush_now`` must run before ``transport.close()``.
"""

from __future__ import annotations


class WriteCoalescer:
    """Mixin for asyncio protocols with a ``self.transport`` attribute."""

    def _init_coalescer(self, loop) -> None:
        self._wbuf: list[bytes] = []
        self._wflush_scheduled = False
        self._wloop = loop

    def queue_write(self, data: bytes) -> None:
        self._wbuf.append(data)
        if not self._wflush_scheduled:
            self._wflush_scheduled = True
            self._wloop.call_soon(self._wflush)

    def _wflush(self) -> None:
        self._wflush_scheduled = False
        wbuf = self._wbuf
        if not wbuf:
            return
        data = b"".join(wbuf) if len(wbuf) > 1 else wbuf[0]
        self._wbuf = []
        transport = self.transport
        if transport is not None and not transport.is_closing():
            transport.write(data)

    def flush_now(self) -> None:
        """Synchronous flush, required before ``transport.close()``."""
        self._wflush()

    def drop_writes(self) -> None:
        """Forget queued bytes (connection lost)."""
        self._wbuf = []
