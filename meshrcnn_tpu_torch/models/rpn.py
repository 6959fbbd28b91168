"""Region proposal network: anchors, the RPN head, proposal selection and
the RPN loss (counterpart of meshrcnn_tpu/models/rpn.py; reference:
pix3d_model.py:147).

Every step has a fixed shape: per-level top-k objectness, greedy NMS of all
levels in one batched call (``ops/nms.py``), and a final top-k to a fixed
proposal count. Top-k is ``ops/matcher.stable_topk``, a stable descending
sort cut to k, so equal scores keep the lower index first, as
``jax.lax.top_k`` does. The loss matches every anchor to the GT boxes and
samples a fixed number of them (``ops/matcher.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from meshrcnn_tpu_torch.models.cast import Conv2d, float32_out
from meshrcnn_tpu_torch.ops.boxes import (box_iou, clip_boxes_to_image, decode_boxes,
                                          encode_boxes, small_box_mask)
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.matcher import (BELOW_LOW, balanced_sample, match_boxes,
                                            sigmoid_bce, smooth_l1, stable_topk)
from meshrcnn_tpu_torch.ops.nms import nms_mask
from meshrcnn_tpu_torch.ops.sampling import Uniform

ANCHOR_SIZES = (32, 64, 128, 256, 512)          # one per P2..P6 level
ASPECT_RATIOS = (0.5, 1.0, 2.0)
# The RPN loss's sampling recipe (torchvision's RPN defaults).
RPN_BATCH_PER_IMAGE = 256
RPN_POSITIVE_FRACTION = 0.5
RPN_FG_IOU = 0.7
RPN_BG_IOU = 0.3


def generate_anchors(feature_shapes: Sequence[tuple[int, int]], image_size: tuple[int, int],
                     device: torch.device | str) -> List[torch.Tensor]:
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
            logits.append(float32_out(self.cls_logits(t).permute(0, 2, 3, 1).reshape(B, -1)))
            deltas.append(float32_out(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(B, -1, 4)))
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


def rpn_loss(uniform: Uniform, logits: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
             anchors: Sequence[torch.Tensor], gt_boxes: torch.Tensor):
    """Objectness BCE and box smooth-L1 of the sampled anchors (torchvision's
    RPN loss): each image's anchors of all levels are matched to its GT boxes
    [B, G, 4] at ``RPN_FG_IOU`` / ``RPN_BG_IOU`` with low-quality matches, and
    ``balanced_sample`` takes ``RPN_BATCH_PER_IMAGE`` of them (two uniforms
    [B, N] from ``uniform``, N anchors). Both losses are per image over the
    sampled count, then averaged over images. Returns (loss_objectness,
    loss_rpn_box_reg)."""
    lg = torch.cat(list(logits), 1)                                  # [B, N]
    dl = torch.cat(list(deltas), 1)                                  # [B, N, 4]
    anc = torch.cat(list(anchors), 0)                                # [N, 4]
    G = gt_boxes.shape[1]
    gt_valid = torch.ones(G, dtype=torch.bool, device=lg.device)
    matches = match_boxes(box_iou(anc, gt_boxes), gt_valid, RPN_FG_IOU, RPN_BG_IOU,
                          allow_low_quality=True)                    # [B, N]
    positive = matches >= 0
    idx, is_pos, valid = balanced_sample(uniform, positive, matches == BELOW_LOW,
                                         RPN_BATCH_PER_IMAGE, RPN_POSITIVE_FRACTION)
    sampled_gt = batched_gather_rows(gt_boxes, torch.gather(matches, 1, idx).clamp(0, G - 1))
    targets = encode_boxes(sampled_gt, anc[idx])
    sv = valid.float()
    bce = sigmoid_bce(torch.gather(lg, 1, idx), torch.gather(positive.float(), 1, idx)) * sv
    n_sampled = sv.sum(1).clamp(min=1.0)
    box = smooth_l1(batched_gather_rows(dl, idx), targets).sum(-1) * is_pos.float()
    return (bce.sum(1) / n_sampled).mean(), (box.sum(1) / n_sampled).mean()
