"""MNIST-scale MLP classifier: the port of the JAX package's
``models/mlp.py`` (dense + relu layers, a softmax head).  Flat rows, or
any row shape that flattens to ``in_features``."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from seldon_core_tpu_torch.models import zoo


@dataclasses.dataclass(frozen=True)
class Config:
    in_features: int = 784
    hidden: int = 512
    n_layers: int = 2
    n_classes: int = 10


class MLP(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_layers):
            width = cfg.in_features if i == 0 else cfg.hidden
            self.add_module(f"dense_{i}", nn.Linear(width, cfg.hidden))
        self.head = nn.Linear(cfg.hidden if cfg.n_layers else cfg.in_features, cfg.n_classes)

    def check_input(self, x) -> None:
        zoo.check_features(x, self.cfg.in_features, "mlp")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(zoo.compute_dtype(self))
        for i in range(self.cfg.n_layers):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return torch.softmax(self.head(x), dim=-1)


def init_params(cfg: Config = Config(), generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None, device="cpu") -> MLP:
    return zoo.build(MLP, cfg, generator, dtype, device)


def apply(module: MLP, batch: torch.Tensor) -> torch.Tensor:
    return module(batch)
