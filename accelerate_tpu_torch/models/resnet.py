"""ResNet for image classification in PyTorch.

Counterpart of ``accelerate_tpu/models/resnet.py`` (the model of
``examples/cv_example.py``; ``ResNetConfig.resnet50()``). What it keeps of
the reference, and how:

* **NHWC input.** The model takes ``[B, H, W, C]`` images, as the JAX model
  does; ``x.permute(0, 3, 1, 2)`` is then an NCHW view with
  ``torch.channels_last`` strides, which the convolutions keep on the card.
* **Weights.** Flax conv kernels are HWIO; here they are torch's OIHW
  (``utils/convert.py`` permutes ``(3, 2, 0, 1)``).
* **"SAME" padding is flax's, which is asymmetric at stride 2**: the low
  side gets ``total // 2``, the high side the rest. On an even side the
  7x7/2 stem pads (2, 3) and a 3x3/2 conv or max pool (0, 1); torch's
  symmetric ``padding=`` would give the same output size over shifted
  windows. Asymmetric pads go through ``F.pad`` (with -inf before the max
  pool, which flax pads with -inf).
* **BatchNorm is flax's** (:class:`BatchNorm`): momentum 0.99 (torch's
  0.01), eps 1e-5, batch statistics in f32 with the *biased* variance
  ``E[x^2] - E[x]^2`` (clipped at 0), which also goes into the running
  average (``nn.BatchNorm2d`` keeps the unbiased one). ``scale``/``bias``
  are parameters, ``mean``/``var`` buffers: the names of flax's
  ``params`` and ``batch_stats``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


@dataclasses.dataclass
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)   # ResNet-50
    num_filters: int = 64
    num_classes: int = 1000
    bottleneck: bool = True

    @classmethod
    def resnet50(cls, num_classes=1000):
        return cls(stage_sizes=(3, 4, 6, 3), num_classes=num_classes)

    @classmethod
    def resnet18(cls, num_classes=1000):
        return cls(stage_sizes=(2, 2, 2, 2), bottleneck=False, num_classes=num_classes)

    @classmethod
    def tiny(cls, num_classes=10):
        return cls(stage_sizes=(1, 1), num_filters=8, bottleneck=False, num_classes=num_classes)


def _same_pads(size: int, kernel: int, stride: int) -> tuple:
    """Flax/XLA "SAME" padding of one spatial side: ``(low, high)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """A bias-free convolution with flax's "SAME" padding; ``weight`` OIHW.
    The input is cast to the weight's dtype, so images in f32 enter a
    model whose parameters the accelerator cast to bf16."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels, kernel, kernel),
                                               device=device, dtype=dtype))

    def forward(self, x):
        x = x.to(self.weight.dtype)
        (top, bottom), (left, right) = (_same_pads(n, self.kernel, self.stride)
                                        for n in x.shape[2:])
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight, stride=self.stride)


def max_pool_same(x, kernel: int = 3, stride: int = 2):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: the pads
    hold -inf."""
    (top, bottom), (left, right) = (_same_pads(n, kernel, stride) for n in x.shape[2:])
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """Flax's default kernel init, in place: a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in (fan_in: every dim
    but the output's), from ``generator``."""
    std = math.prod(weight.shape[1:]) ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the channels of an NCHW tensor (see the
    module docstring). ``train=True`` normalizes with the batch's
    statistics and folds them into ``mean``/``var`` (``momentum`` of the old
    value kept); ``train=False`` uses ``mean``/``var``."""

    def __init__(self, num_features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(num_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device, dtype=dtype))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))

    def forward(self, x, train: bool = True):
        x32 = x.float()
        if train:
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, strides: int = 1, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1, self.bn1 = Conv(in_channels, filters, 1, **kw), BatchNorm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, strides, **kw)
        self.bn2 = BatchNorm(filters, **kw)
        self.conv3 = Conv(filters, filters * 4, 1, **kw)
        self.bn3 = BatchNorm(filters * 4, **kw)
        if strides != 1 or in_channels != filters * 4:
            self.proj = Conv(in_channels, filters * 4, 1, strides, **kw)
            self.bn_proj = BatchNorm(filters * 4, **kw)

    def forward(self, x, train: bool = True):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.bn_proj(self.proj(x), train) if hasattr(self, "proj") else x
        return F.relu(y + residual)


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, filters: int, strides: int = 1, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = Conv(in_channels, filters, 3, strides, **kw)
        self.bn1 = BatchNorm(filters, **kw)
        self.conv2, self.bn2 = Conv(filters, filters, 3, **kw), BatchNorm(filters, **kw)
        if strides != 1 or in_channels != filters:
            self.proj = Conv(in_channels, filters, 1, strides, **kw)
            self.bn_proj = BatchNorm(filters, **kw)

    def forward(self, x, train: bool = True):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = self.bn_proj(self.proj(x), train) if hasattr(self, "proj") else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``). ``forward(x, train=True)`` takes NHWC images and
    gives the logits; ``train=True`` normalizes with batch statistics and
    updates the running ones, as the JAX model's mutable ``batch_stats``.
    ``generator`` draws the weights in the law of flax's default init
    (:func:`lecun_normal_`), biases zero, BatchNorm scales one."""

    def __init__(self, config: ResNetConfig, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        kw = dict(device=device, dtype=dtype)
        self.conv_stem = Conv(3, cfg.num_filters, 7, 2, **kw)
        self.bn_stem = BatchNorm(cfg.num_filters, **kw)
        block, width = (BottleneckBlock, 4) if cfg.bottleneck else (BasicBlock, 1)
        channels = cfg.num_filters
        self.block_names = []
        for i, size in enumerate(cfg.stage_sizes):
            for j in range(size):
                filters = cfg.num_filters * 2 ** i
                name = f"stage{i}_block{j}"
                setattr(self, name, block(channels, filters, 2 if i > 0 and j == 0 else 1, **kw))
                self.block_names.append(name)
                channels = filters * width
        self.classifier = nn.Linear(channels, cfg.num_classes, **kw)
        if generator is not None:
            with torch.no_grad():
                for name, p in self.named_parameters():
                    leaf = name.rsplit(".", 1)[-1]
                    if leaf == "scale":
                        p.fill_(1.0)
                    elif leaf == "bias":
                        p.zero_()
                    else:
                        lecun_normal_(p, generator)

    def forward(self, x, train: bool = True):
        x = x.permute(0, 3, 1, 2)  # NHWC -> an NCHW view in channels_last strides
        x = F.relu(self.bn_stem(self.conv_stem(x), train))
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.classifier(x.mean(dim=(2, 3)))
