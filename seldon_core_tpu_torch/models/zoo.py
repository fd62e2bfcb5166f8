"""What the four zoo families (``mlp``, ``cnn``, ``resnet``, ``bert``)
share: flax's initial distributions drawn from a ``torch.Generator``,
flax's ``"SAME"`` padding, its inference-mode BatchNorm, and the cast of
a module's floating weights.

The families keep the JAX package's flax module names as attribute names
(``dense_0``, ``stage1_block0.conv2``, ``layer_3.attention.query``), so a
flax variables tree maps onto a port module path by path
(``models/weights.py::zoo_from_flax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's truncated-normal variance scaling divides the stddev by the std of
# a standard normal truncated to [-2, 2] (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)`` over the channel axis
    of an NCHW tensor: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, in
    flax's order and in the activation's dtype.  ``scale``/``bias`` are
    parameters (flax ``params``), ``mean``/``var`` buffers (flax
    ``batch_stats``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return (x - self.mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one axis: ``(before, after)``, the
    odd pixel after (a 3x3/2 window over an even input pads 0 and 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with ``padding=0``) with flax's ``"SAME"`` padding."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = same_padding(x.shape[2], kh, sh)
    left, right = same_padding(x.shape[3], kw, sw)
    if top == bottom and left == right:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, (top, left))
    return conv(F.pad(x, (left, right, top, bottom)))


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``nn.max_pool(..., padding="SAME")``: pads with -inf."""
    top, bottom = same_padding(x.shape[2], kernel, stride)
    left, right = same_padding(x.shape[3], kernel, stride)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The dtype a family computes in: its weights'."""
    return next(module.parameters()).dtype


def check_features(x, expected: int, what: str) -> None:
    """A request's rows must flatten to ``expected`` features."""
    got = math.prod(x.shape[1:]) if x.ndim > 1 else x.shape[0]
    if got != expected:
        raise ValueError(f"{what} takes rows of {expected} features, got shape {tuple(x.shape)}")


@torch.no_grad()
def cast_floats(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Cast the floating parameters and weight buffers (BatchNorm
    statistics) to ``dtype``; integer tensors and non-persistent buffers
    (constants such as ResNet's ImageNet statistics) keep theirs."""
    if dtype is None:
        return module
    for mod in module.modules():
        for key, p in mod._parameters.items():
            if p is not None and p.is_floating_point():
                mod._parameters[key] = nn.Parameter(p.to(dtype), requires_grad=False)
        for key, b in mod._buffers.items():
            if (b is not None and b.is_floating_point()
                    and key not in mod._non_persistent_buffers_set):
                mod._buffers[key] = b.to(dtype)
    return module


@torch.no_grad()
def init_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Overwrite ``module``'s weights with flax's initial distributions:
    Dense and Conv kernels lecun-normal (truncated normal, variance 1 /
    fan_in) with zero biases, Embed tables normal with std 1 / sqrt(features),
    LayerNorm and BatchNorm at scale 1 and bias 0, BatchNorm statistics at
    mean 0 and variance 1.  The numbers differ from flax's, since the
    generators do."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim), generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)


def build(cls, cfg, generator: torch.Generator, dtype, device) -> nn.Module:
    """``cls(cfg)`` made on ``device`` with flax's initial distributions,
    cast to ``dtype``, in inference mode."""
    with torch.device(device):
        module = cls(cfg)
    init_flax(module, generator)
    return cast_floats(module, dtype).eval().requires_grad_(False)
