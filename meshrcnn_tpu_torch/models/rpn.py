"""Region proposal network: anchors, the RPN head and proposal selection
(counterpart of meshrcnn_tpu/models/rpn.py; reference: pix3d_model.py:147).

Every step has a fixed shape: per-level top-k objectness, greedy NMS of all
levels in one batched call (``ops/nms.py``), and a final top-k to a fixed
proposal count. Top-k is a stable descending sort cut to k, so equal scores
keep the lower index first, as ``jax.lax.top_k`` does; ``torch.topk``
promises no order among ties.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from meshrcnn_tpu_torch.models.cast import Conv2d
from meshrcnn_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes, small_box_mask
from meshrcnn_tpu_torch.ops.nms import nms_mask

ANCHOR_SIZES = (32, 64, 128, 256, 512)          # one per P2..P6 level
ASPECT_RATIOS = (0.5, 1.0, 2.0)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def generate_anchors(feature_shapes: Sequence[tuple[int, int]], image_size: tuple[int, int],
                     device: torch.device | str = "cpu") -> List[torch.Tensor]:
    """Per-level anchors [H*W*A, 4] xyxy centred on the feature cells, in (h, w, a) order."""
    H, W = image_size
    out = []
    for lvl, (fh, fw) in enumerate(feature_shapes):
        size = ANCHOR_SIZES[lvl]
        base = torch.tensor([[-size / ar ** 0.5 / 2, -size * ar ** 0.5 / 2,
                              size / ar ** 0.5 / 2, size * ar ** 0.5 / 2]
                             for ar in ASPECT_RATIOS], dtype=torch.float32, device=device)
        ys = (torch.arange(fh, dtype=torch.float32, device=device) + 0.5) * (H / fh)
        xs = (torch.arange(fw, dtype=torch.float32, device=device) + 0.5) * (W / fw)
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        centers = torch.stack([cx, cy, cx, cy], dim=-1).reshape(-1, 1, 4)
        out.append((centers + base[None]).reshape(-1, 4))
    return out


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / box-delta 1x1 heads (torchvision RPNHead).

    Convs compute in ``dtype``; logits and deltas come back float32, flattened
    in the JAX package's NHWC (h, w, a) order: [B, H*W*A] and [B, H*W*A, 4].
    """

    def __init__(self, in_channels: int = 256, num_anchors: int = len(ASPECT_RATIOS),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_channels, 256, 3, padding=1, compute_dtype=dtype)
        self.cls_logits = Conv2d(256, num_anchors, 1, compute_dtype=dtype)
        self.bbox_pred = Conv2d(256, num_anchors * 4, 1, compute_dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            B = t.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(B, -1).float())
            deltas.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(B, -1, 4).float())
        return logits, deltas


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, 4], idx [B, K] -> [B, K, 4]."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + (4,)))


def select_proposals(logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
                     anchors: Sequence[torch.Tensor], image_size: tuple[int, int],
                     pre_nms_top_n: int, post_nms_top_n: int, nms_thresh: float = 0.7,
                     min_size: float = 1e-3):
    """Decode + per-level top-k + per-level NMS + global top-k, fixed shapes.

    Returns (proposals [B, post_nms_top_n, 4], scores, valid). The levels are
    padded to the largest k with invalid rows and go through NMS as one batch
    of B * levels sets; level l keeps its first min(k_l, post_nms_top_n) slots.
    """
    B = logits[0].shape[0]
    ks = [min(pre_nms_top_n, a.shape[0]) for a in anchors]
    K = max(ks)
    boxes, scores, valid = [], [], []
    for lg, dl, anc, k in zip(logits, deltas, anchors, ks):
        top_s, top_i = stable_topk(lg.detach(), k)
        bx = decode_boxes(_take_rows(dl.detach(), top_i), anc[top_i])
        bx = clip_boxes_to_image(bx, image_size)
        pad = K - k
        boxes.append(F.pad(bx, (0, 0, 0, pad)))
        scores.append(F.pad(top_s, (0, pad), value=float("-inf")))
        valid.append(F.pad(small_box_mask(bx, min_size), (0, pad), value=False))
    L = len(ks)
    bx, sc, vd = (torch.stack(x, 1).reshape((B * L,) + x[0].shape[1:])
                  for x in (boxes, scores, valid))
    m_keep = [min(k, post_nms_top_n) for k in ks]
    order, keep = nms_mask(bx, sc, vd, nms_thresh, max_keep=max(m_keep))
    safe = torch.where(order >= 0, order, 0)
    kept_boxes = _take_rows(bx, safe).reshape(B, L, -1, 4)
    kept_scores = torch.where(keep, torch.gather(sc, 1, safe), float("-inf")).reshape(B, L, -1)
    keep = keep.reshape(B, L, -1)
    boxes = torch.cat([kept_boxes[:, i, :m] for i, m in enumerate(m_keep)], 1)
    scores = torch.cat([kept_scores[:, i, :m] for i, m in enumerate(m_keep)], 1)
    valid = torch.cat([keep[:, i, :m] for i, m in enumerate(m_keep)], 1)
    top_s, top_i = stable_topk(scores, min(post_nms_top_n, boxes.shape[1]))
    return (_take_rows(boxes, top_i), top_s,
            torch.gather(valid, 1, top_i) & (top_s > float("-inf")))
