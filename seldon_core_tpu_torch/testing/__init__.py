"""Test and load tools of the port: the wire-level load harness (``loadtest.py``)."""
