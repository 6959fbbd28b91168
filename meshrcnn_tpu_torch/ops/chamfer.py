"""Nearest neighbour, chamfer and normal terms for point clouds
(counterpart of meshrcnn_tpu/ops/chamfer.py).

``nearest_neighbor`` and ``chamfer_distance`` are the plain, single-sample forms;
the eval path goes through the K1 wrapper in ``ops/chamfer_cuda.py`` instead.
Only the given-normals path of ``batched_normal_distance`` is ported: the
kNN + PCA estimator is a later slice.
"""
from __future__ import annotations

import torch

from meshrcnn_tpu_torch.ops.chamfer_cuda import nn_one_way


def nearest_neighbor(p: torch.Tensor, q: torch.Tensor):
    """For each point of p [N,3], the min squared distance to q [M,3] and its index."""
    d, idx = nn_one_way(p[None], q[None])
    return d[0], idx[0]


def chamfer_distance(p: torch.Tensor, q: torch.Tensor):
    """(sum_p_to_q, idx_p, sum_q_to_p, idx_q) for one cloud pair: sums, not means
    (reference: loss_functions.py:93-102)."""
    d_p, idx_p = nearest_neighbor(p, q)
    d_q, idx_q = nearest_neighbor(q, p)
    return d_p.sum(), idx_p, d_q.sum(), idx_q


def batched_normal_distance(idx_p: torch.Tensor, idx_q: torch.Tensor,
                            normals_p: torch.Tensor, normals_q: torch.Tensor):
    """Two-sided per-sample summed |cos| alignment of given unit normals [B,N,3]
    at the nearest-neighbour indices. Returns ([B] sum_p, [B] sum_q)."""
    nn_p = torch.gather(normals_q, 1, idx_p.long()[..., None].expand(-1, -1, 3))
    nn_q = torch.gather(normals_p, 1, idx_q.long()[..., None].expand(-1, -1, 3))
    align_p = (normals_p * nn_p).sum(-1).abs().sum(1)
    align_q = (normals_q * nn_q).sum(-1).abs().sum(1)
    return align_p, align_q
