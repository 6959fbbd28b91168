"""Greedy non-maximum suppression over fixed-size candidate sets
(counterpart of meshrcnn_tpu/ops/nms.py; reference: meshRCNN/layers.py:672).

Greedy NMS over the score-sorted list is the unique solution of

    keep[i] = valid[i] and not any(keep[j] and iou[i, j] > t for j < i),

and iterating ``keep -> f(keep)`` from all-valid reaches it after as many
sweeps as the longest chain of suppressions, plus one that sees no change.
Each sweep is one reduction over a [..., N, N] mask for every set of the
batch at once (images, and the RPN's levels padded to one size), and the
host reads one flag a sweep to stop. Ties in score keep the lower index
first. ``nms_mask.sweeps`` and ``nms_mask.calls`` count sweeps and calls.
The JAX package's module is plain ``jnp`` too: no Pallas kernel lies here.
"""
from __future__ import annotations

import torch

from meshrcnn_tpu_torch.ops.boxes import box_iou


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, max_keep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each set of a batch.

    boxes [..., N, 4] xyxy, scores [..., N], valid [..., N] (padded rows False).
    Returns (order [..., max_keep] int64, keep [..., max_keep] bool): the
    indices of the first ``max_keep`` kept boxes in descending score order,
    -1 in the slots left over.
    """
    n = boxes.shape[-2]
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    sort_idx = torch.sort(-s, dim=-1, stable=True).indices
    sv = torch.gather(s, -1, sort_idx) > float("-inf")
    sb = torch.gather(boxes, -2, sort_idx[..., None].expand(sort_idx.shape + (4,)))
    lower = torch.ones((n, n), dtype=torch.bool, device=boxes.device).tril(-1)
    sup = (box_iou(sb, sb) > iou_threshold) & lower      # a higher-scored j overlaps i
    keep = sv
    nms_mask.calls += 1
    for _ in range(n):
        nms_mask.sweeps += 1
        new_keep = sv & ~(sup & keep[..., None, :]).any(-1)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    slot = torch.where(keep, torch.cumsum(keep, -1) - 1, max_keep).clamp(max=max_keep)
    order = torch.full(keep.shape[:-1] + (max_keep + 1,), -1, dtype=torch.int64,
                       device=boxes.device)
    order.scatter_(-1, slot, torch.where(keep, sort_idx, -1))
    order = order[..., :max_keep]
    return order, order >= 0


nms_mask.calls = 0
nms_mask.sweeps = 0


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, iou_threshold: float,
                     max_keep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS of each set by the coordinate-offset trick: boxes of
    class c move by c * (the set's largest valid coordinate + 1)."""
    if boxes.shape[-2] == 0:
        shape = boxes.shape[:-2] + (max_keep,)
        return (torch.full(shape, -1, dtype=torch.int64, device=boxes.device),
                torch.zeros(shape, dtype=torch.bool, device=boxes.device))
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(-2, -1), keepdim=True) + 1.0
    return nms_mask(boxes + labels.to(boxes.dtype)[..., None] * max_coord, scores, valid,
                    iou_threshold, max_keep)
