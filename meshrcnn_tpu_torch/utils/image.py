"""Image resizing helpers matching torch interpolate semantics
(counterpart of meshrcnn_tpu/utils/image.py)."""
from __future__ import annotations

import torch


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True of NHWC x, as explicit gathers
    (reference: meshRCNN/shapenet_model.py:51-52, 5x5 -> 24x24 on C5)."""
    B, H, W, C = x.shape
    out_h, out_w = out_hw

    def grid(in_size: int, out_size: int) -> torch.Tensor:
        if out_size == 1:
            return torch.zeros(1, dtype=torch.float32, device=x.device)
        scale = (in_size - 1) / (out_size - 1)
        return torch.arange(out_size, dtype=torch.float32, device=x.device) * scale

    rows = grid(H, out_h)
    cols = grid(W, out_w)
    r0 = torch.floor(rows).long()
    c0 = torch.floor(cols).long()
    r1 = (r0 + 1).clamp(max=H - 1)
    c1 = (c0 + 1).clamp(max=W - 1)
    fr = (rows - r0.float())[None, :, None, None]
    fc = (cols - c0.float())[None, None, :, None]
    top = x[:, r0][:, :, c0] * (1 - fc) + x[:, r0][:, :, c1] * fc
    bot = x[:, r1][:, :, c0] * (1 - fc) + x[:, r1][:, :, c1] * fc
    return top * (1 - fr) + bot * fr


def scaled_size(in_size: int, scale_factor: float) -> int:
    """torch interpolate output-size rule: floor(in * scale)."""
    return int(in_size * scale_factor)
