"""ResNet-50 image classifier: the port of the JAX package's
``models/resnet.py``.

Serving-mode BatchNorm: the running statistics are weights (flax's
``batch_stats``), used as they are.  The model takes NHWC images or flat
rows, as the JAX model does, and runs its convolutions on an NCHW view of
channels-last memory.  flax's ``padding="SAME"`` at stride 2 (the
bottleneck's 3x3 ``conv2`` and the stem's 3x3 max pool) pads one pixel
after and none before on an even input, so those are padded explicitly
(the pool with -inf); the stem's 7x7/2 has flax's explicit (3, 3).

A uint8 batch (raw pixels off the wire, 4x smaller than bf16) is
normalized inside the forward: divided by 255 in float32, normalized by
the ImageNet statistics and cast to the weights' dtype, as the JAX
package's ``apply`` does.  A float batch is cast to the weights' dtype.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from seldon_core_tpu_torch.models import zoo


@dataclasses.dataclass(frozen=True)
class Config:
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    n_classes: int = 1000
    image_size: int = 224
    channels: int = 3


# ImageNet channel statistics (RGB), for the on-device uint8 ingest
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = zoo.BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride, bias=False)
        self.bn2 = zoo.BatchNorm(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = zoo.BatchNorm(features * 4)
        # flax projects the residual when its shape differs from the branch's
        if in_features != features * 4 or stride != 1:
            self.proj = nn.Conv2d(in_features, features * 4, 1, stride, bias=False)
            self.bn_proj = zoo.BatchNorm(features * 4)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(zoo.conv_same(self.conv2, y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.proj is None else self.bn_proj(zoo.conv_same(self.proj, x))
        return torch.relu(residual + y)


class ResNet(nn.Module):
    def __init__(self, cfg: Config = Config()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(cfg.channels, cfg.width, 7, 2, padding=3, bias=False)
        self.bn_stem = zoo.BatchNorm(cfg.width)
        self.blocks = []
        width = cfg.width
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                name = f"stage{i}_block{j}"
                block = Bottleneck(width, cfg.width * 2 ** i, 2 if i > 0 and j == 0 else 1)
                self.add_module(name, block)
                self.blocks.append(name)
                width = cfg.width * 2 ** i * 4
        self.head = nn.Linear(width, cfg.n_classes)
        # constants of the uint8 ingest, float32 whatever the weights' dtype
        self.register_buffer("ingest", torch.tensor([IMAGENET_MEAN, IMAGENET_STD]),
                             persistent=False)

    def check_input(self, x) -> None:
        c = self.cfg
        if x.ndim == 4:
            if x.shape[3] != c.channels:
                raise ValueError(f"resnet takes NHWC images of {c.channels} channels, "
                                 f"got shape {tuple(x.shape)}")
        else:
            zoo.check_features(x, c.image_size * c.image_size * c.channels, "resnet")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        if x.ndim == 2:  # flat rows off the wire, NHWC before the channel stats
            x = x.reshape(-1, c.image_size, c.image_size, c.channels)
        dtype = zoo.compute_dtype(self)
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self.ingest[0]) / self.ingest[1]
        x = x.to(dtype).permute(0, 3, 1, 2)  # an NCHW view of channels-last memory
        x = torch.relu(self.bn_stem(self.stem(x)))
        x = zoo.max_pool_same(x, 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return torch.softmax(self.head(x), dim=-1)


def init_params(cfg: Config = Config(), generator: torch.Generator | None = None,
                dtype: torch.dtype | None = None, device="cpu") -> ResNet:
    """flax's initial weights (``zoo.init_flax``); each bottleneck's
    ``bn3`` starts at scale 0, as in the JAX model, so at init a residual
    branch adds nothing."""
    module = zoo.build(ResNet, cfg, generator, dtype, device)
    for name in module.blocks:
        getattr(module, name).bn3.scale.zero_()
    return module


def apply(module: ResNet, batch: torch.Tensor) -> torch.Tensor:
    return module(batch)
