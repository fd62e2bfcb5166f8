"""Inference graphs: the spec, the built-in units and the walker."""
