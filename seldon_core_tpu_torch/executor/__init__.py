"""Generative serving: the paged-KV model, the scheduler and the graph
component."""
