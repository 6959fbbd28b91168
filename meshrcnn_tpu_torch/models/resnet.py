"""ResNet-50 backbone returning logits + the C2..C5 pyramid
(counterpart of meshrcnn_tpu/models/resnet.py; reference: shapenet_model.py:104-150).

Takes NHWC images and returns NHWC feature maps (views of the NCHW conv
outputs) with 256/512/1024/2048 channels at strides 4/8/16/32. BatchNorm
matches flax's (``BatchNorm``): eps 1e-5, flax momentum 0.9 is torch momentum
0.1, eval uses the running statistics, train mode the batch's. Module names
follow the flax scopes (``layer1_0`` ...) so ``utils/jax_params.py`` maps
parameters by path.

``dtype`` is the convolutions' compute dtype, as in flax: each conv casts its
input and weight to it and returns it, and BatchNorm computes in its own
parameters' dtype (float32), so every block's output is float32
(``models/cast.py``). None computes in the parameters' dtype throughout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from meshrcnn_tpu_torch.models.cast import Conv2d, Linear


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running variance as flax does.

    flax folds the *biased* batch variance, E[x^2] - E[x]^2 clamped at 0, into
    ``ra_var``; torch folds the unbiased one, which differs by n/(n-1) (1.3% at
    ResNet-50's c5 with B=3 at 137x137, n = 75). Normalisation uses the biased
    batch variance in both. The input is cast to the parameters' dtype first,
    as flax's ``BatchNorm(dtype=float32)`` promotes a bfloat16 conv output.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
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
                 expansion: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        out = features * expansion
        self.conv1 = Conv2d(in_features, features, 1, bias=False, compute_dtype=dtype)
        self.bn1 = _bn(features)
        self.conv2 = Conv2d(features, features, 3, stride=strides, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn2 = _bn(features)
        self.conv3 = Conv2d(features, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = _bn(out)
        self.has_downsample = in_features != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_features, out, 1, stride=strides,
                                          bias=False, compute_dtype=dtype)
            self.downsample_bn = _bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


class ResNetBody(nn.Module):
    """ResNet-50's stem and bottleneck stages, the trunk that ``ResNet50`` and the
    Pix3D ``ResNetFPN`` share; ``stages`` maps NCHW images to [c2, c3, c4, c5]."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = _bn(64)
        self.pool = nn.MaxPool2d(3, stride=2, padding=1)
        in_f = 64
        for i, (blocks, feats) in enumerate(zip(self.stage_sizes, (64, 128, 256, 512))):
            for j in range(blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                setattr(self, f"layer{i + 1}_{j}", Bottleneck(in_f, feats, strides, dtype=dtype))
                in_f = feats * 4

    def stages(self, x: torch.Tensor):
        x = self.pool(torch.relu(self.bn1(self.conv1(x))))
        outs = []
        for i, blocks in enumerate(self.stage_sizes):
            for j in range(blocks):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            outs.append(x)
        return outs


class ResNet50(ResNetBody):
    """images [B,H,W,3] -> (logits [B, num_classes], [c2, c3, c4, c5] NHWC float32)."""

    def __init__(self, num_classes: int = 13, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(stage_sizes, dtype)
        self.fc = Linear(2048, num_classes)

    def forward(self, images: torch.Tensor):
        maps = self.stages(images.permute(0, 3, 1, 2))
        logits = self.fc(maps[-1].mean(dim=(2, 3)))
        return logits, [c.permute(0, 2, 3, 1) for c in maps]
