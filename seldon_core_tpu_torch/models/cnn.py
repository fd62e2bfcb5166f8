"""deep_mnist-style convnet: the port of the JAX package's
``models/cnn.py`` (two 5x5 conv + 2x2 max-pool blocks, one dense layer, a
softmax head).  Takes flat ``image_size**2 * channels`` rows (the
reference example's wire format) or NHWC images; the convolutions run on
an NCHW view of channels-last memory, and the flatten before ``fc1``
keeps flax's (h, w, c) order."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.models import zoo


@dataclasses.dataclass(frozen=True)
class Config:
    image_size: int = 28
    channels: int = 1
    n_classes: int = 10
    hidden: int = 1024


class CNN(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv2d(cfg.channels, 32, 5)
        self.conv2 = nn.Conv2d(32, 64, 5)
        side = cfg.image_size // 2 // 2
        self.fc1 = nn.Linear(side * side * 64, cfg.hidden)
        self.head = nn.Linear(cfg.hidden, cfg.n_classes)

    def check_input(self, x) -> None:
        c = self.cfg
        zoo.check_features(x, c.image_size * c.image_size * c.channels, "cnn")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if x.ndim == 2:  # flat rows off the wire
            x = x.reshape(-1, c.image_size, c.image_size, c.channels)
        # NHWC as an NCHW view: the memory stays channels-last
        x = x.to(zoo.compute_dtype(self)).permute(0, 3, 1, 2)
        x = F.max_pool2d(torch.relu(zoo.conv_same(self.conv1, x)), 2, 2)
        x = F.max_pool2d(torch.relu(zoo.conv_same(self.conv2, x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (h, w, c) order
        x = torch.relu(self.fc1(x))
        return torch.softmax(self.head(x), dim=-1)


def init_params(cfg: Config = Config(), generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None, device="cpu") -> CNN:
    return zoo.build(CNN, cfg, generator, dtype, device)


def apply(module: CNN, batch: torch.Tensor) -> torch.Tensor:
    return module(batch)
