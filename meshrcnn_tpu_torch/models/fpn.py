"""ResNet-50 FPN backbone, the Pix3D detection trunk
(counterpart of meshrcnn_tpu/models/fpn.py; reference: pix3d_model.py:122).

Takes NHWC images and returns NCHW [p2, p3, p4, p5, p6]: 256 channels at
strides 4/8/16/32, plus the RPN-only P6 (a 1x1 max pool with stride 2, which
is every other cell of P5). Convolutions compute in ``dtype`` and BatchNorm in
float32, as the flax module; the pyramid comes out in ``dtype``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from meshrcnn_tpu_torch.models.cast import Conv2d
from meshrcnn_tpu_torch.models.resnet import ResNetBody


def upsample_nearest(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest upsample of NCHW x to (th, tw) with source rows (arange(th) * H) // th,
    in integers: ``F.interpolate(mode="nearest")`` computes its source index in
    floating point and may pick another row at sizes that do not divide. Rows
    and columns are taken by ``index_select``, whose backward is an
    ``index_add_``; advanced indexing would take PyTorch's sort-based backward."""
    H, W = x.shape[2], x.shape[3]
    rows = torch.div(torch.arange(th, device=x.device) * H, th, rounding_mode="floor")
    cols = torch.div(torch.arange(tw, device=x.device) * W, tw, rounding_mode="floor")
    return x.index_select(2, rows).index_select(3, cols)


class ResNetFPN(ResNetBody):
    def __init__(self, out_channels: int = 256, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(stage_sizes, dtype)
        for level, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            setattr(self, f"lateral{level}", Conv2d(c, out_channels, 1, compute_dtype=dtype))
            setattr(self, f"out{level}", Conv2d(out_channels, out_channels, 3, padding=1,
                                                compute_dtype=dtype))

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        c2, c3, c4, c5 = self.stages(images.permute(0, 3, 1, 2))
        p5 = self.lateral5(c5)
        p4 = self.lateral4(c4) + upsample_nearest(p5, *c4.shape[2:])
        p3 = self.lateral3(c3) + upsample_nearest(p4, *c3.shape[2:])
        p2 = self.lateral2(c2) + upsample_nearest(p3, *c2.shape[2:])
        p2, p3, p4, p5 = self.out2(p2), self.out3(p3), self.out4(p4), self.out5(p5)
        return [p2, p3, p4, p5, p5[:, :, ::2, ::2]]
