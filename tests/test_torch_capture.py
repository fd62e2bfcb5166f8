"""The capture section on the CPU (ROADMAP C9): a generative model's
decode-graph capture holds the process-wide capture lock from the eager
warm-up run to the last sync (the syncs and the emptied allocator cache
around one capture would invalidate another thread's), as a compiled
model's capture does, with Python's cyclic garbage collector paused (a
collection inside a capture destroyed a closed engine's graphs on the
capturing thread, which invalidated the capture on the card).  The CUDA
calls are stand-ins that record what was held; the block body itself
runs on the CPU.  And a closed unit waits for the device call its
scheduler left in flight."""

import asyncio
import contextlib
import gc
import threading
import time

import numpy as np
import torch

from seldon_core_tpu_torch import CAPTURE_LOCK, capture_section
from seldon_core_tpu_torch.executor import compiled
from seldon_core_tpu_torch.executor.generation import GenerativeComponent, GenerativeModel
from seldon_core_tpu_torch.models import llama
from seldon_core_tpu_torch.models.weights import init_params
from seldon_core_tpu_torch.ops import paged_attention


class _FakeStream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


class _FakeGraph:
    def register_generator_state(self, gen):
        pass

    def pool(self):
        return "pool"


def _record_cuda(monkeypatch, held: list):
    """Stand-ins for the CUDA calls around a capture; each records whether
    the capture lock was held when it ran."""
    def note(what):
        held.append((what, CAPTURE_LOCK.locked() and not gc.isenabled()))

    @contextlib.contextmanager
    def graph(*args, **kwargs):
        note("capture")
        yield

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: note("synchronize"))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: note("empty_cache"))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(paged_attention, "reserve_counters",
                        lambda *a: note("reserve_counters"))


def _tiny_model() -> GenerativeModel:
    cfg = llama.Config.tiny(max_seq=64)
    return GenerativeModel(cfg, init_params(cfg, torch.Generator().manual_seed(0)), n_slots=2,
                           device="cpu", decode_block=2)


def test_generative_capture_holds_the_process_wide_lock(monkeypatch):
    model = _tiny_model()
    held: list = []
    _record_cuda(monkeypatch, held)
    entry = model._capture(2, 64)
    assert entry["graph"] is not None and not CAPTURE_LOCK.locked() and gc.isenabled()
    whats = [w for w, _ in held]
    assert whats == ["synchronize", "reserve_counters", "synchronize", "empty_cache",
                     "capture", "synchronize"]
    assert all(locked for _, locked in held), held


def test_captures_of_two_models_take_turns(monkeypatch):
    """While one thread holds the lock, another model's capture waits: it
    enters its capture only after the first thread lets go."""
    model = _tiny_model()
    held: list = []
    _record_cuda(monkeypatch, held)
    order = []
    CAPTURE_LOCK.acquire()
    try:
        t = threading.Thread(target=lambda: order.append(("captured", model._capture(2, 64))))
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive() and not order  # blocked on the lock
        order.append(("released", None))
    finally:
        CAPTURE_LOCK.release()
    t.join(timeout=60)
    assert not t.is_alive()
    assert [o for o, _ in order] == ["released", "captured"]
    assert compiled.capture_section is capture_section  # the compiled model's captures too
    assert np.all([locked for _, locked in held])


def test_capture_section_restores_the_collector_and_the_lock_on_failure():
    try:
        with capture_section():
            assert CAPTURE_LOCK.locked() and not gc.isenabled()
            raise RuntimeError("capture failed")
    except RuntimeError:
        pass
    assert not CAPTURE_LOCK.locked() and gc.isenabled()
    gc.disable()  # a process that runs without the collector keeps it off
    try:
        with capture_section():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_a_closed_unit_waits_for_the_device_call_in_flight():
    """A scheduler closed while a device call runs in a thread (its task was
    cancelled at that await) leaves the call running: the unit's close
    returns only once it ends, so no closed engine's device work overlaps
    the next engine's captures."""
    comp = GenerativeComponent(_tiny_model())
    ended = []

    def device_call():  # as a model call in flight holds the model's lock
        with comp.model._lock:
            time.sleep(0.3)
            ended.append(time.monotonic())

    async def go():
        t = threading.Thread(target=device_call)
        t.start()
        await asyncio.sleep(0.05)
        await comp.close()
        closed = time.monotonic()
        t.join(timeout=10)
        return closed

    closed = asyncio.run(go())
    assert ended and closed >= ended[0]
