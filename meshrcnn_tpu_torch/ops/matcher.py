"""Box-to-GT matching and balanced sampling with fixed shapes
(counterpart of meshrcnn_tpu/ops/matcher.py; reference: torchvision's Matcher
and BalancedPositiveNegativeSampler, as pix3d_model.py:147 and
layers.py:702-704 use them).

Matching is an argmax over a fixed [..., N, G] IoU matrix whose padded GT
columns are masked; sampling returns index sets of a fixed size, chosen by a
randomized top-k over uniforms drawn from a ``Uniform`` source, so nothing has
a data-dependent shape. Every tie goes to the lower index, as ``jnp.argmax``
and ``jax.lax.top_k`` break it.
"""
from __future__ import annotations

import torch

from meshrcnn_tpu_torch.ops.sampling import Uniform

BELOW_LOW = -1
BETWEEN = -2


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, lower index first among equal values
    (``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (``jnp.argmax`` of a bool array)."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device)
    first = torch.where(mask, pos, n).amin(-1)
    return torch.where(first == n, 0, first)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` over the last axis: the first index of the maximum."""
    return first_true(x == x.amax(-1, keepdim=True))


def match_boxes(iou: torch.Tensor, gt_valid: torch.Tensor, high: float, low: float,
                allow_low_quality: bool = False) -> torch.Tensor:
    """For each row (anchor or proposal) of iou [..., N, G], the index of its
    matched GT, or the BELOW_LOW / BETWEEN sentinels; gt_valid [G] masks padded
    GT columns. With ``allow_low_quality`` each GT's best rows are forced to it."""
    masked = torch.where(gt_valid, iou, torch.full_like(iou, -1.0))
    best_val = masked.amax(-1)
    best_gt = first_argmax(masked)
    matches = torch.where(best_val >= high, best_gt,
                          torch.where(best_val < low, BELOW_LOW, BETWEEN))
    if allow_low_quality:
        gt_best = masked.amax(-2, keepdim=True)                      # [..., 1, G]
        is_best = (masked == gt_best) & gt_valid & (masked > 0)
        matches = torch.where(is_best.any(-1), first_true(is_best), matches)
    return matches


def balanced_sample(uniform: Uniform, positive: torch.Tensor, negative: torch.Tensor,
                    num_samples: int, positive_fraction: float):
    """Up to ``num_samples`` rows of each batch row, about ``positive_fraction``
    of them positive: positive / negative [B, N] bool -> (idx, is_pos, valid),
    each [B, num_samples].

    The quota rule is torchvision's: num_pos = min(positives, num_samples *
    fraction), and negatives refill whatever the positives left open. Eligible
    rows score a uniform, the others -inf, and the best scores win. Draws two
    uniforms [B, N] from ``uniform``: the positives' scores, then the negatives'.
    """
    B, n = positive.shape
    dev = positive.device
    pos_quota = min(int(num_samples * positive_fraction), n)
    pos_take = max(pos_quota, 1)           # the gather below never reads an empty axis
    neg_take = min(num_samples, n)
    ninf = torch.tensor(float("-inf"), device=dev)
    pos_val, pos_idx = stable_topk(torch.where(positive, uniform((B, n)).to(dev), ninf), pos_take)
    neg_val, neg_idx = stable_topk(torch.where(negative, uniform((B, n)).to(dev), ninf), neg_take)
    num_pos = (pos_val > ninf).sum(-1, keepdim=True).clamp(max=pos_quota)
    num_neg = torch.minimum((neg_val > ninf).sum(-1, keepdim=True), num_samples - num_pos)
    slots = torch.arange(num_samples, device=dev).expand(B, num_samples)
    take_pos = slots < num_pos
    idx = torch.where(take_pos, torch.gather(pos_idx, 1, slots.clamp(max=pos_take - 1)),
                      torch.gather(neg_idx, 1, (slots - num_pos).clamp(0, neg_take - 1)))
    valid = slots < num_pos + num_neg
    return torch.where(valid, idx, 0), take_pos & valid, valid


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Elementwise smooth-L1 with torchvision detection's beta of 1/9."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid binary cross-entropy."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
