"""Event-loop tuning shared by the server processes (the engine and the
gateway): the port's copy of the JAX package's ``utils/loops.py``."""

from __future__ import annotations

import asyncio
import gc


def tune_server_loop() -> None:
    """Steady-state serving tuning, called once at startup inside the loop:

    - relax the collector: the data plane allocates per request; the
      default gen-0 threshold triggers collections hundreds of times a
      second under load, and startup objects (modules, compiled code,
      weights' Python wrappers) are frozen out of every later scan;
    - eager tasks (3.12+): a handler that completes without suspending
      never round-trips the ready queue.
    """
    gc.collect()
    gc.freeze()
    gc.set_threshold(50000, 25, 25)
    eager = getattr(asyncio, "eager_task_factory", None)
    if eager is not None:
        asyncio.get_running_loop().set_task_factory(eager)
