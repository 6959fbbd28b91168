"""ResNet-50 backbone returning logits + the C2..C5 pyramid
(counterpart of meshrcnn_tpu/models/resnet.py; reference: shapenet_model.py:104-150).

Takes NHWC images and returns NHWC feature maps (views of the NCHW conv
outputs) with 256/512/1024/2048 channels at strides 4/8/16/32. BatchNorm
matches flax's (``BatchNorm``): eps 1e-5, flax momentum 0.9 is torch momentum
0.1, eval uses the running statistics, train mode the batch's. Module names
follow the flax scopes (``layer1_0`` ...) so ``utils/jax_params.py`` maps
parameters by path.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running variance as flax does.

    flax folds the *biased* batch variance, E[x^2] - E[x]^2 clamped at 0, into
    ``ra_var``; torch folds the unbiased one, which differs by n/(n-1) (1.3% at
    ResNet-50's c5 with B=3 at 137x137, n = 75). Normalisation uses the biased
    batch variance in both.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """torchvision-style bottleneck (1x1 -> 3x3(stride) -> 1x1 x4) with BN."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 expansion: int = 4):
        super().__init__()
        out = features * expansion
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=strides, padding=1,
                               bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.has_downsample = in_features != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_features, out, 1, stride=strides,
                                             bias=False)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


class ResNet50(nn.Module):
    """images [B,H,W,3] -> (logits [B, num_classes], [c2, c3, c4, c5] NHWC)."""

    def __init__(self, num_classes: int = 13, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        in_f = 64
        for i, (blocks, feats) in enumerate(zip(self.stage_sizes, (64, 128, 256, 512))):
            for j in range(blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"layer{i + 1}_{j}", Bottleneck(in_f, feats, strides))
                in_f = feats * 4
        self.fc = nn.Linear(in_f, num_classes)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2)
        x = self.pool(torch.relu(self.bn1(self.conv1(x))))
        feature_maps = []
        for i, blocks in enumerate(self.stage_sizes):
            for j in range(blocks):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            feature_maps.append(x.permute(0, 2, 3, 1))
        logits = self.fc(x.mean(dim=(2, 3)))
        return logits, feature_maps
