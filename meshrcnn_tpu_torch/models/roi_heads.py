"""RoI heads with RoI-feature passthrough, eval mode
(counterpart of meshrcnn_tpu/models/roi_heads.py; reference: meshRCNN/layers.py:616-811).

The box branch pools 12x12 features of every proposal, classifies and
regresses them, and ``_postprocess`` keeps ``detections_per_img`` boxes an
image after a per-class score prefilter and class-aware greedy NMS; the pooled
features of the kept boxes ride along as ``Detections.roi_features``, the input
of the voxel and mesh branches. The mask branch pools 14x14 features of each
detection and predicts 28x28 mask probabilities at the detected class. Pooled
features stay channels-last [B, R, 12, 12, C], so ``fc6`` reads them in the
flax (h, w, c) flatten order and its weight needs no permutation.
The training branch (sampling, box and mask losses) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from meshrcnn_tpu_torch.models.cast import Conv2d, ConvTranspose2d, Linear
from meshrcnn_tpu_torch.models.rpn import stable_topk
from meshrcnn_tpu_torch.ops.boxes import (BOX_REG_WEIGHTS, clip_boxes_to_image, decode_boxes,
                                          small_box_mask)
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.nms import batched_nms_mask
from meshrcnn_tpu_torch.ops.roi_align import flatten_levels, multiscale_roi_align


@dataclasses.dataclass
class Detections:
    """Fixed-capacity detections of each image (capacity D = detections_per_img)."""
    boxes: torch.Tensor         # [B, D, 4]
    labels: torch.Tensor        # [B, D] int64 (1-based classes, 0 = invalid)
    scores: torch.Tensor        # [B, D]
    valid: torch.Tensor         # [B, D] bool
    roi_features: torch.Tensor  # [B, D, pool, pool, C] float32, the mesh branch's input


class TwoMLPHead(nn.Module):
    """flatten -> fc 1024 -> relu -> fc 1024 -> relu in ``dtype``, float32 out."""

    def __init__(self, in_features: int, representation_size: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc6 = Linear(in_features, representation_size, compute_dtype=dtype)
        self.fc7 = Linear(representation_size, representation_size, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], x.shape[1], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x)))).float()


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """4x (conv 3x3 + relu) -> deconv x2 + relu -> 1x1 logits, in ``dtype``.

    Takes channels-last pooled features [B, R, 14, 14, C]; returns float32
    logits [B, R, num_classes, 28, 28].
    """

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}", Conv2d(in_channels if i == 0 else hidden, hidden,
                                                     3, padding=1, compute_dtype=dtype))
        self.conv5_mask = ConvTranspose2d(hidden, hidden, 2, stride=2, compute_dtype=dtype)
        self.mask_fcn_logits = Conv2d(hidden, num_classes, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, R = x.shape[:2]
        x = x.reshape((B * R,) + x.shape[2:]).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = self.mask_fcn_logits(F.relu(self.conv5_mask(x))).float()
        return x.reshape((B, R) + x.shape[1:])


class RoIHeads(nn.Module):
    """Box + mask heads with RoI-feature passthrough, fixed shapes, eval mode."""

    def __init__(self, num_classes: int = 10, in_channels: int = 256, box_pool_size: int = 12,
                 box_sampling_ratio: int = 1, mask_pool_size: int = 14,
                 mask_sampling_ratio: int = 2, detections_per_img: int = 3,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5,
                 post_nms_prefilter: int = 576, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.box_pool_size = box_pool_size
        self.box_sampling_ratio = box_sampling_ratio
        self.mask_pool_size = mask_pool_size
        self.mask_sampling_ratio = mask_sampling_ratio
        self.detections_per_img = detections_per_img
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        # the pre-NMS candidate budget, split per class: K_c = 576 // (C-1) = 64
        self.post_nms_prefilter = post_nms_prefilter
        self.box_head = TwoMLPHead(box_pool_size * box_pool_size * in_channels, dtype=dtype)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)
        self.mask_head = MaskHead(in_channels, num_classes, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor], proposals: torch.Tensor,
                proposals_valid: torch.Tensor, image_size: tuple[int, int]):
        """features: NCHW [p2..p6]; proposals [B, R, 4]. Returns (Detections,
        mask_probs [B, D, 28, 28] at each detection's class)."""
        B = proposals.shape[0]
        levels = flatten_levels(features[:4])
        box_feats = multiscale_roi_align(levels, proposals, image_size,
                                         self.box_pool_size, self.box_sampling_ratio)
        class_logits, box_deltas = self.box_predictor(self.box_head(box_feats))
        box_deltas = box_deltas.reshape(B, -1, self.num_classes, 4)
        detections = self._postprocess(box_feats, class_logits, box_deltas, proposals,
                                       proposals_valid, image_size)

        det_feats = multiscale_roi_align(levels, detections.boxes, image_size,
                                         self.mask_pool_size, self.mask_sampling_ratio)
        mask_logits = self.mask_head(det_feats)                       # [B, D, C, 28, 28]
        cls = detections.labels.clamp(0, self.num_classes - 1)
        sel = torch.gather(mask_logits, 2, cls[:, :, None, None, None].expand(
            (B, cls.shape[1], 1) + mask_logits.shape[3:]))[:, :, 0]
        return detections, torch.sigmoid(sel)

    def _postprocess(self, box_feats, class_logits, box_deltas, proposals, proposals_valid,
                     image_size) -> Detections:
        """Fixed-shape postprocess_detections (reference: layers.py:621-685).

        Before NMS each class keeps its K_c best (proposal, class) candidates:
        a bounded approximation that loses a weaker same-class object only
        behind >= K_c higher-scored candidates of that class, ported as the
        JAX package has it. Empty slots repeat candidate 0 with valid False.
        """
        B, R = class_logits.shape[:2]
        C = self.num_classes
        dev = class_logits.device
        scores = torch.softmax(class_logits, dim=-1)
        boxes = decode_boxes(box_deltas, proposals[:, :, None, :], BOX_REG_WEIGHTS)
        boxes = clip_boxes_to_image(boxes, image_size)

        fg_boxes = boxes[:, :, 1:].reshape(B, R * (C - 1), 4)
        fg_scores = scores[:, :, 1:].reshape(B, R * (C - 1))
        labels = torch.arange(1, C, device=dev).expand(B, R, C - 1).reshape(B, R * (C - 1))
        valid = proposals_valid[:, :, None].expand(B, R, C - 1).reshape(B, R * (C - 1))
        valid = valid & (fg_scores > self.score_thresh) & small_box_mask(fg_boxes)

        Kc = min(R, max(self.detections_per_img, self.post_nms_prefilter // (C - 1)))
        sc3 = torch.where(valid, fg_scores, float("-inf")).reshape(B, R, C - 1)
        pre_sc, pre_r = stable_topk(sc3.transpose(1, 2), Kc)          # [B, C-1, Kc]
        pre_idx = (pre_r * (C - 1) + torch.arange(C - 1, device=dev)[None, :, None]
                   ).reshape(B, (C - 1) * Kc)
        pre_sc = pre_sc.reshape(B, (C - 1) * Kc)
        pre_boxes = batched_gather_rows(fg_boxes, pre_idx)
        pre_labels = torch.gather(labels, 1, pre_idx)
        pre_valid = torch.gather(valid, 1, pre_idx) & torch.isfinite(pre_sc)

        order, keep = batched_nms_mask(pre_boxes, pre_sc, pre_labels, pre_valid,
                                       self.nms_thresh, self.detections_per_img)
        safe_pre = torch.where(order >= 0, order, 0)
        safe = torch.gather(pre_idx, 1, safe_pre)        # flat (proposal, class) index
        feats = batched_gather_rows(box_feats, torch.div(safe, C - 1, rounding_mode="floor"))
        return Detections(boxes=batched_gather_rows(pre_boxes, safe_pre),
                          labels=torch.where(keep, torch.gather(pre_labels, 1, safe_pre), 0),
                          scores=torch.where(keep, torch.gather(pre_sc, 1, safe_pre), 0.0),
                          valid=keep, roi_features=feats.float())
