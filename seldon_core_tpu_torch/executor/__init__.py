"""Generative serving: the paged-KV model, the scheduler and the graph
component; and the parameter checkpoints (``save_params``,
``load_params``) every unit loads its weights through."""

from seldon_core_tpu_torch.executor.checkpoint import load_params, save_params

__all__ = ["load_params", "save_params"]
