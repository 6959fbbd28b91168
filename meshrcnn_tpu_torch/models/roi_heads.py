"""RoI heads with RoI-feature passthrough
(counterpart of meshrcnn_tpu/models/roi_heads.py; reference: meshRCNN/layers.py:616-811).

The box branch pools 12x12 features of every proposal, classifies and
regresses them, and ``_postprocess`` keeps ``detections_per_img`` boxes an
image after a per-class score prefilter and class-aware greedy NMS; the pooled
features of the kept boxes ride along as ``Detections.roi_features``, the input
of the voxel and mesh branches. In eval the mask branch pools 14x14 features
of each detection and predicts 28x28 mask probabilities at the detected
class. Pooled features stay channels-last [B, R, 12, 12, C], so ``fc6`` reads
them in the flax (h, w, c) flatten order and its weight needs no permutation.

In training the GT boxes join the proposals, ``_select_training_samples``
samples ``batch_size_per_image`` of them, the box branch runs on those (its
classification and class-specific box losses, then ``_postprocess``, as the
JAX package does), and ``_mask_loss`` scores the mask head on up to
``mask_rois`` positives against the GT mask cropped to each. The uniforms
come from a ``Uniform`` source in a fixed order: the sampler's two [B, R+G]
draws, then the mask loss's [B, batch_size_per_image].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function

from meshrcnn_tpu_torch.models.cast import Conv2d, ConvTranspose2d, Linear, float32_out
from meshrcnn_tpu_torch.ops.boxes import (BOX_REG_WEIGHTS, box_iou, clip_boxes_to_image,
                                          decode_boxes, encode_boxes, small_box_mask)
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.matcher import (BELOW_LOW, balanced_sample, match_boxes,
                                            sigmoid_bce, smooth_l1, stable_topk)
from meshrcnn_tpu_torch.ops.nms import batched_nms_mask
from meshrcnn_tpu_torch.ops.roi_align import (FeatureLevels, flatten_levels,
                                              multiscale_roi_align, roi_align)
from meshrcnn_tpu_torch.ops.sampling import Uniform


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
        return float32_out(F.relu(self.fc7(F.relu(self.fc6(x)))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, num_classes * 4)

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
        x = float32_out(self.mask_fcn_logits(F.relu(self.conv5_mask(x))))
        return x.reshape((B, R) + x.shape[1:])


class RoIHeads(nn.Module):
    """Box + mask heads with RoI-feature passthrough, fixed shapes."""

    def __init__(self, num_classes: int = 10, in_channels: int = 256, box_pool_size: int = 12,
                 box_sampling_ratio: int = 1, mask_pool_size: int = 14,
                 mask_sampling_ratio: int = 2, detections_per_img: int = 3,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5,
                 batch_size_per_image: int = 512, positive_fraction: float = 0.25,
                 fg_iou: float = 0.5, bg_iou: float = 0.5, mask_rois: int = 64,
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
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.fg_iou = fg_iou
        self.bg_iou = bg_iou
        self.mask_rois = mask_rois        # cap on the positives fed to the mask head
        # the pre-NMS candidate budget, split per class: K_c = 576 // (C-1) = 64
        self.post_nms_prefilter = post_nms_prefilter
        self.box_head = TwoMLPHead(box_pool_size * box_pool_size * in_channels, dtype=dtype)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)
        self.mask_head = MaskHead(in_channels, num_classes, dtype=dtype)

    def forward(self, features: Sequence[torch.Tensor], proposals: torch.Tensor,
                proposals_valid: torch.Tensor, image_size: tuple[int, int], train: bool = False,
                gt_boxes: Optional[torch.Tensor] = None, gt_labels: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None, uniform: Optional[Uniform] = None):
        """features: NCHW [p2..p6]; proposals [B, R, 4]. Returns (Detections,
        losses, mask_probs): in eval no losses and mask_probs [B, D, 28, 28] at
        each detection's class; in training (gt_boxes [B, G, 4], gt_labels [B]
        1-based, gt_masks [B, H, W] or None to skip the mask loss) the losses
        and no mask_probs."""
        B = proposals.shape[0]
        levels = flatten_levels(features[:4])
        losses = {}
        if train:
            with record_function("losses/roi heads"):
                proposals, proposals_valid, labels, reg_targets, is_pos = (
                    self._select_training_samples(uniform, proposals, proposals_valid,
                                                  gt_boxes, gt_labels))
        box_feats = multiscale_roi_align(levels, proposals, image_size,
                                         self.box_pool_size, self.box_sampling_ratio)
        class_logits, box_deltas = self.box_predictor(self.box_head(box_feats))
        box_deltas = box_deltas.reshape(B, -1, self.num_classes, 4)
        if train:
            with record_function("losses/roi heads"):
                losses.update(self._box_losses(class_logits, box_deltas, labels, reg_targets,
                                               is_pos, proposals_valid))
        detections = self._postprocess(box_feats, class_logits, box_deltas, proposals,
                                       proposals_valid, image_size)
        if train:
            if gt_masks is not None:
                with record_function("losses/mask"):
                    losses["loss_mask"] = self._mask_loss(
                        uniform, levels, proposals, is_pos & proposals_valid, gt_labels,
                        gt_masks, image_size)
            return detections, losses, None

        det_feats = multiscale_roi_align(levels, detections.boxes, image_size,
                                         self.mask_pool_size, self.mask_sampling_ratio)
        mask_logits = self.mask_head(det_feats)                       # [B, D, C, 28, 28]
        return detections, losses, torch.sigmoid(
            _at_class(mask_logits, detections.labels.clamp(0, self.num_classes - 1)))

    def _select_training_samples(self, uniform: Uniform, proposals, proposals_valid,
                                 gt_boxes, gt_labels):
        """Append the GT boxes to the proposals, match at ``fg_iou`` / ``bg_iou``
        and sample ``batch_size_per_image`` at ``positive_fraction`` positives
        (reference: layers.py:702-704 via torchvision's select_training_samples).
        Returns the sampled (proposals [B, S, 4], valid, labels (0 for
        background), box targets at ``BOX_REG_WEIGHTS``, is_pos), all without
        gradient."""
        B, G = gt_boxes.shape[:2]
        dev = proposals.device
        proposals = torch.cat([proposals, gt_boxes], 1)
        pvalid = torch.cat([proposals_valid, torch.ones((B, G), dtype=torch.bool, device=dev)], 1)
        iou = torch.where(pvalid[..., None], box_iou(proposals, gt_boxes), -1.0)
        matches = match_boxes(iou, torch.ones(G, dtype=torch.bool, device=dev),
                              self.fg_iou, self.bg_iou)
        idx, is_pos, valid = balanced_sample(uniform, (matches >= 0) & pvalid,
                                             (matches == BELOW_LOW) & pvalid,
                                             self.batch_size_per_image, self.positive_fraction)
        sampled = batched_gather_rows(proposals, idx)
        matched = torch.gather(matches, 1, idx).clamp(0, G - 1)
        labels = torch.where(is_pos, gt_labels.long()[:, None], 0)
        targets = encode_boxes(batched_gather_rows(gt_boxes, matched), sampled, BOX_REG_WEIGHTS)
        return sampled, valid, labels, targets, is_pos

    def _box_losses(self, class_logits, box_deltas, labels, reg_targets, is_pos, valid) -> dict:
        """Softmax cross-entropy of every valid sample, and smooth-L1 of the
        positives' deltas at their GT class; both over the valid count of the batch."""
        v = valid.float()
        n = v.sum().clamp(min=1.0)
        logp = torch.log_softmax(class_logits, dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0] * v
        sel = _at_class(box_deltas, labels.clamp(0, self.num_classes - 1))        # [B, S, 4]
        box = smooth_l1(sel, reg_targets).sum(-1) * (is_pos & valid).float()
        return {"loss_classifier": ce.sum() / n, "loss_box_reg": box.sum() / n}

    def _mask_loss(self, uniform: Uniform, levels: FeatureLevels, proposals, pos_mask,
                   gt_labels, gt_masks, image_size):
        """Mean BCE of the GT-class mask logits of up to ``mask_rois`` positive
        samples an image (a randomized top-k, one uniform [B, S]) against the GT
        mask cropped to each proposal at 28x28 (RoIAlign with sampling ratio 2,
        then >= 0.5), without gradient into the masks (torchvision's
        maskrcnn_loss; reference: layers.py:766-769)."""
        B = proposals.shape[0]
        score = torch.where(pos_mask, uniform(tuple(pos_mask.shape)).to(pos_mask.device),
                            float("-inf"))
        _, idx = stable_topk(score, self.mask_rois)
        sel_valid = torch.gather(pos_mask, 1, idx)
        sel_props = batched_gather_rows(proposals, idx)
        pooled = multiscale_roi_align(levels, sel_props, image_size, self.mask_pool_size,
                                      self.mask_sampling_ratio)
        logits = self.mask_head(pooled)                               # [B, M, C, 28, 28]
        cls = gt_labels.long().clamp(0, self.num_classes - 1)[:, None].expand(B, idx.shape[1])
        sel_logits = _at_class(logits, cls)                           # [B, M, 28, 28]
        out = logits.shape[-1]
        with torch.no_grad():
            targets = roi_align(gt_masks.float()[..., None], sel_props, 1.0, out,
                                sampling_ratio=2)[..., 0]
            targets = (targets >= 0.5).float()
        w = sel_valid.float()[..., None, None]
        bce = sigmoid_bce(sel_logits, targets) * w
        return bce.sum() / (w.sum() * out * out).clamp(min=1.0)

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
                          valid=keep, roi_features=float32_out(feats))


def _at_class(x: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """x [B, R, C, ...] at class cls [B, R] -> [B, R, ...], by ``torch.gather``."""
    B, R = cls.shape
    idx = cls.reshape((B, R, 1) + (1,) * (x.dim() - 3)).expand((B, R, 1) + x.shape[3:])
    return torch.gather(x, 2, idx)[:, :, 0]
