"""Box math: IoU, clipping, small-box masks, encode/decode
(counterpart of meshrcnn_tpu/ops/boxes.py; reference: meshRCNN/layers.py:638-666).

Boxes are xyxy in the last axis. Filtering returns boolean masks, never
compacted tensors, so every shape stays fixed.
"""
from __future__ import annotations

import torch

# torchvision BoxCoder: the clamp of the log-size deltas, log(1000/16), and the
# box head's regression weights (faster_rcnn.py)
BBOX_XFORM_CLIP = 4.135166556742356
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of a [..., N, 4] and b [..., M, 4] -> [..., N, M]."""
    area_a = box_area(a)
    area_b = box_area(b)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def clip_boxes_to_image(boxes: torch.Tensor, image_size: tuple[int, int]) -> torch.Tensor:
    """Clamp xyxy boxes into [0, W] x [0, H]."""
    h, w = image_size
    return torch.stack([boxes[..., 0].clamp(0.0, w), boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w), boxes[..., 3].clamp(0.0, h)], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float = 1e-2) -> torch.Tensor:
    """True where both sides are at least ``min_size`` (remove_small_boxes as a mask)."""
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & (
        (boxes[..., 3] - boxes[..., 1]) >= min_size)


def encode_boxes(reference: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Regression targets (dx, dy, dw, dh) from proposals to reference boxes."""
    wx, wy, ww, wh = weights
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    gx = (reference[..., 0] + reference[..., 2]) * 0.5
    gy = (reference[..., 1] + reference[..., 3]) * 0.5
    gw = (reference[..., 2] - reference[..., 0]).clamp(min=1e-6)
    gh = (reference[..., 3] - reference[..., 1]).clamp(min=1e-6)
    return torch.stack([wx * (gx - px) / pw, wy * (gy - py) / ph,
                        ww * torch.log(gw / pw), wh * torch.log(gh / ph)], dim=-1)


def decode_boxes(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to anchor or proposal boxes (xyxy)."""
    wx, wy, ww, wh = weights
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    cx = dx * pw + px
    cy = dy * ph + py
    nw = torch.exp(dw) * pw
    nh = torch.exp(dh) * ph
    return torch.stack([cx - 0.5 * nw, cy - 0.5 * nh, cx + 0.5 * nw, cy + 0.5 * nh], dim=-1)
