"""The QoS shed decisions a request can meet before its device step: the
port's copies of the JAX package's ``QueueFull`` (429) and
``DeadlineExceeded`` (504) from ``qos/admission.py``."""

from __future__ import annotations


class QueueFull(Exception):
    """A bounded intake is full (the engine answers 429)."""


class DeadlineExceeded(Exception):
    """The request's deadline passed while it waited for a device step (the
    engine answers 504, and no step is spent on it)."""
