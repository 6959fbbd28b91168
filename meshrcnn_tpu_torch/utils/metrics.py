"""Evaluation metrics (counterpart of meshrcnn_tpu/utils/metrics.py; reference:
utils/metrics.py).

The port keeps its own copies of the JAX package's numpy metrics: the
confusion F-beta, box IoU, ranked AP and the AUC that scores AP_mesh (with the
trapezoid rule written out; the card's machine has no scikit-learn), and a
batched torch form of the device-side mask paste. The single-sample helpers
for the API's and the demo's users are here too: ``point_cloud_f1`` (one K2
launch for clouds on the card), ``paste_mask_in_image`` (Pillow's bilinear
filter, by ``data/image_io``), ``calc_precision_box`` and ``calc_precision_mask``.
"""
from __future__ import annotations

import numpy as np
import torch

from meshrcnn_tpu_torch.ops.chamfer_cuda import nn_bidir_single


def f_score(confusion_matrix: np.ndarray, beta: float = 1.0) -> np.ndarray:
    """Per-class F-beta x100 from a confusion matrix (reference: metrics.py:7-28)."""
    cm = np.asarray(confusion_matrix, dtype=np.float64)
    tp = np.diag(cm)
    precision = tp / np.maximum(cm.sum(axis=0), 1e-12)
    recall = tp / np.maximum(cm.sum(axis=1), 1e-12)
    b2 = beta * beta
    denom = np.maximum(b2 * precision + recall, 1e-12)
    return 100.0 * (1 + b2) * precision * recall / denom


def point_cloud_f1(pred_points, gt_points, tau: float = 0.1):
    """F1@tau between two sampled clouds [N,3], [M,3] (the Mesh R-CNN paper's
    metric): precision is the share of predicted points whose squared distance
    to the nearest GT point is below tau^2, recall the same the other way, F1
    their harmonic mean. Returns (f1, precision, recall) as floats. Both
    directions come from one ``nn_bidir_single`` call: one K2 launch for
    clouds on the card, its plain twin for clouds on the CPU (numpy input is
    read as a CPU tensor)."""
    p = torch.as_tensor(pred_points, dtype=torch.float32).contiguous()
    g = torch.as_tensor(gt_points, dtype=torch.float32, device=p.device).contiguous()
    d_p, _, d_g, _ = nn_bidir_single(p, g)
    thresh = tau * tau
    # counts divided on the host: the same float on every device
    precision = int((d_p < thresh).sum()) / d_p.numel()
    recall = int((d_g < thresh).sum()) / d_g.numel()
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return f1, precision, recall


def paste_mask_in_image(mask: np.ndarray, box, height: int, width: int,
                        threshold: float = 0.5) -> np.ndarray:
    """Paste a K x K RoI mask of probabilities into a [height, width] binary
    int32 image at its rounded, clamped box, resized by Pillow's bilinear
    filter on float32 (torchvision's paste semantics, used before AP_mask)."""
    from meshrcnn_tpu_torch.data.image_io import resize_bilinear
    x1, y1, x2, y2 = [int(round(float(v))) for v in np.asarray(box).reshape(4)]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(max(x2, x1 + 1), width), min(max(y2, y1 + 1), height)
    w, h = x2 - x1, y2 - y1
    resized = resize_bilinear(np.asarray(mask, dtype=np.float32), (w, h))
    out = np.zeros((height, width), dtype=np.int32)
    out[y1:y2, x1:x2] = (resized > threshold).astype(np.int32)
    return out


def calc_precision_box(pred_boxes, gt_boxes, iou_thresh: float = 0.5) -> float:
    """The share of (GT box, its prediction) pairs with IoU above the threshold
    (reference: metrics.py:31-38, one matched prediction a sample)."""
    pred_boxes = np.asarray(pred_boxes).reshape(-1, 4)
    gt_boxes = np.asarray(gt_boxes).reshape(-1, 4)
    if pred_boxes.size == 0:
        return 0.0
    count = int(sum(box_iou(gt[None], pred[None])[0, 0] > iou_thresh
                    for gt, pred in zip(gt_boxes, pred_boxes)))
    return count / len(pred_boxes)


def calc_precision_mask(pred_masks, gt_masks, iou_thresh: float = 0.5) -> float:
    """The share of predicted masks whose pixel IoU with their own image's GT
    mask is above the threshold (reference: metrics.py:43-53)."""
    pred_masks = [np.asarray(m).astype(bool) for m in pred_masks]
    gt = np.asarray(gt_masks).astype(bool)
    if len(gt) != len(pred_masks):
        raise ValueError(f"{len(pred_masks)} predicted masks for {len(gt)} GT masks")
    hits = 0
    for mb, g in zip(pred_masks, gt):
        inter = np.logical_and(mb, g).sum()
        union = np.logical_or(mb, g).sum()
        if union > 0 and inter / union > iou_thresh:
            hits += 1
    return hits / max(len(pred_masks), 1)


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int, width: int,
                threshold: float = 0.5) -> torch.Tensor:
    """Paste K x K RoI masks [..., K, K] into [..., height, width] binary int32
    images at boxes [..., 4] (``paste_mask_in_image_jax`` over any batch shape):
    the box is rounded half to even and clamped, each pixel centre is mapped
    back into the mask, sampled bilinearly with edge clamping, thresholded, and
    kept inside the box."""
    masks = masks.float()
    kh, kw = masks.shape[-2:]
    dev = masks.device
    b = torch.round(boxes.float())
    x1 = b[..., 0].clamp(min=0.0)
    y1 = b[..., 1].clamp(min=0.0)
    x2 = torch.minimum(torch.maximum(b[..., 2], x1 + 1.0), torch.tensor(float(width), device=dev))
    y2 = torch.minimum(torch.maximum(b[..., 3], y1 + 1.0), torch.tensor(float(height), device=dev))
    # a tensor divisor keeps true division on the card (a Python number would
    # make it multiply by the reciprocal)
    sx = torch.tensor(float(kw), device=dev) / (x2 - x1)
    sy = torch.tensor(float(kh), device=dev) / (y2 - y1)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    u = ((xs - x1[..., None] + 0.5) * sx[..., None] - 0.5).clamp(0.0, kw - 1.0)
    v = ((ys - y1[..., None] + 0.5) * sy[..., None] - 0.5).clamp(0.0, kh - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    uf = u - u0.float()
    vf = v - v0.float()
    u1 = (u0 + 1).clamp(max=kw - 1)
    v1 = (v0 + 1).clamp(max=kh - 1)

    def at(vi, ui):                     # masks[..., vi[:, None], ui[None, :]]
        rows = torch.gather(masks, -2, vi[..., :, None].expand(vi.shape + (kw,)))
        return torch.gather(rows, -1, ui[..., None, :].expand(vi.shape + ui.shape[-1:]))

    ufr = uf[..., None, :]
    top = at(v0, u0) * (1 - ufr) + at(v0, u1) * ufr
    bot = at(v1, u0) * (1 - ufr) + at(v1, u1) * ufr
    val = top * (1 - vf)[..., :, None] + bot * vf[..., :, None]
    inside = (((xs >= x1[..., None]) & (xs < x2[..., None]))[..., None, :]
              & ((ys >= y1[..., None]) & (ys < y2[..., None]))[..., :, None])
    return (inside & (val > threshold)).to(torch.int32)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes a [N,4] x b [M,4] (pure numpy)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def ranked_average_precision(scores, is_match, image_ids, num_gt) -> float:
    """All-point interpolated AP of a score-ranked detection list, with one
    ground-truth object an image: the highest-scored match of an image is the
    TP, later matches on it are FPs (VOC 2010+ / COCO without 101-point
    quantization)."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    is_match = np.asarray(is_match, dtype=bool).reshape(-1)
    image_ids = np.asarray(image_ids).reshape(-1)
    if num_gt <= 0:
        return float("nan")
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    seen: set = set()
    tp = np.zeros(order.size, dtype=np.float64)
    for r, i in enumerate(order):
        img = image_ids[i]
        if is_match[i] and img not in seen:
            seen.add(img)
            tp[r] = 1.0
    ctp = np.cumsum(tp)
    recall = ctp / num_gt
    precision = ctp / np.arange(1, order.size + 1)
    for k in range(precision.size - 2, -1, -1):      # precision envelope
        precision[k] = max(precision[k], precision[k + 1])
    prev_r = 0.0
    ap = 0.0
    for k in range(order.size):
        if tp[k]:
            ap += (recall[k] - prev_r) * precision[k]
            prev_r = recall[k]
    return float(ap)


def detection_map(scores, pred_labels, image_ids, criterion,
                  gt_labels_by_image, thresh: float = 0.5) -> dict:
    """Class-mean ranked AP over a whole eval run from flat per-detection
    arrays. A detection matches when ``criterion`` (box IoU, mask IoU or mesh
    F1@0.3) exceeds ``thresh`` and its class is its image's GT class; classes
    without GT are left out of the mean. Returns {"mAP", "per_class"}."""
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    pred_labels = np.asarray(pred_labels).reshape(-1)
    image_ids = np.asarray(image_ids).reshape(-1)
    criterion = np.asarray(criterion, dtype=np.float64).reshape(-1)
    gt_labels_by_image = dict(gt_labels_by_image)

    per_class = {}
    classes = sorted({int(v) for v in gt_labels_by_image.values()})
    for c in classes:
        num_gt = sum(1 for v in gt_labels_by_image.values() if int(v) == c)
        sel = pred_labels == c
        match = (criterion[sel] > thresh) & np.asarray(
            [int(gt_labels_by_image[i]) == c for i in image_ids[sel]], dtype=bool
        ) if sel.any() else np.zeros(0, bool)
        per_class[c] = ranked_average_precision(scores[sel], match, image_ids[sel], num_gt)
    valid = [v for v in per_class.values() if not np.isnan(v)]
    return {"mAP": float(np.mean(valid)) if valid else 0.0, "per_class": per_class}


def mesh_precision_recall(confusion, f1_scores, f1_thresh: float = 0.5) -> float:
    """AUC of per-class precision against recall with TPs zeroed where the
    confusion f-score <= thresh (reference: metrics.py:56-62), the recall axis
    sorted; the trapezoid sum is sklearn's ``auc`` (numpy's trapz) written out."""
    cm = np.asarray(confusion, dtype=np.float64)
    tp = np.diag(cm).copy()
    f = np.asarray(f1_scores, dtype=np.float64)
    tp[f <= f1_thresh] = 0.0
    precision = 100.0 * tp / (1e-8 + cm.sum(axis=1))
    recall = 100.0 * tp / (1e-8 + cm.sum(axis=0))
    order = np.argsort(recall)
    r, p = recall[order], precision[order]
    if len(r) < 2 or r[0] == r[-1]:
        return float(p.mean())
    return float(np.add.reduce(np.diff(r) * (p[1:] + p[:-1]) / 2.0))
