"""Nearest neighbour, chamfer, kNN and normal terms for point clouds
(counterpart of meshrcnn_tpu/ops/chamfer.py).

``nearest_neighbor`` is the plain single-sample form; ``chamfer_distance`` goes
through K2 (``ops/chamfer_cuda.chamfer_sums_fused``), the batched paths
through K1. ``knn`` / ``batched_knn`` go through K4 / K3 (``ops/knn_cuda.py``),
which keep the k best subtile-min candidates of each point on chip; for
M <= 1024 points they take the exact k smallest of the full distance matrix in
plain PyTorch, as the JAX package does outside any kernel. Equal distances keep
the order of their indices in both (a stable selection).
``batched_compute_normals`` is the reference's kNN + PCA normal estimator
(loss_functions.py:129-170) with the closed-form 3x3 eigensolver
``smallest_eigenvector``.

The subtile of the candidate path follows the TPU kernel's rule: the JAX
package's adaptive ``s`` (halved from 128 until it is at most M/(8k), floored
at 8, and dividing min(tile, M)), then halved until it divides 512, floored at
8 and capped at 64. Runs of ``s`` consecutive points are index-aligned, so the
candidates do not depend on any tiling. For M < 10,240 at k=10 this ``s`` is
the one the JAX package's CPU path uses; above, that path uses 128 and the
kernel 64.

Distances are in difference form here, the JAX package's in Gram form
(|p|^2 + |q|^2 - 2 p.q): near-ties may order differently.
"""
from __future__ import annotations

import math

import torch

from meshrcnn_tpu_torch.ops.chamfer_cuda import chamfer_sums_fused, nn_one_way
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.knn_cuda import knn_topk, knn_topk_batched, smallest_k_stable

EXACT_MAX_POINTS = 1024     # at most this many reference points: exact top-k
START_SUBTILE = 128         # the subtile rule's first guess (see the module note)


def nearest_neighbor(p: torch.Tensor, q: torch.Tensor):
    """For each point of p [N,3], the min squared distance to q [M,3] and its index."""
    d, idx = nn_one_way(p[None], q[None])
    return d[0], idx[0]


def chamfer_distance(p: torch.Tensor, q: torch.Tensor):
    """(sum_p_to_q, idx_p, sum_q_to_p, idx_q) for one cloud pair, through K2:
    sums, not means (reference: loss_functions.py:93-102)."""
    return chamfer_sums_fused(p, q)


def knn_subtile(M: int, k: int, tile: int = 2048) -> int:
    """The candidate kernel's subtile for M reference points (see the module note)."""
    T = min(tile, M)
    s = min(START_SUBTILE, T)
    target = max(8, M // (8 * k))
    while s > 8 and (s > target or T % s):
        s //= 2
    while 512 % s:
        s //= 2
    return min(max(s, 8), 64)


def _sqdist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Difference-form squared distances [..., N, M] of p [..., N, 3] and q [..., M, 3]."""
    diff = p[..., :, None, :] - q[..., None, :, :]
    return (diff * diff).sum(-1)


@torch.no_grad()
def knn(p: torch.Tensor, q: torch.Tensor, k: int, tile: int = 2048, exact: bool = False):
    """k nearest neighbours in q [M,3] of every point of p [N,3] (squared
    distances, ascending) -> (dists [N,k], idx [N,k] int32).

    Exact for M <= 1024 or with ``exact`` (the full distance matrix, in plain
    PyTorch); else K4, the k best of the subtile-min candidates, which loses
    a true neighbour only where two share a run of ``s`` points.
    """
    M = q.shape[0]
    if exact or M <= EXACT_MAX_POINTS:
        top, pos = smallest_k_stable(_sqdist(p, q), k)
        return top, pos.to(torch.int32)
    return knn_topk(p.contiguous(), q.contiguous(), knn_subtile(M, k, tile), k)


@torch.no_grad()
def batched_knn(p: torch.Tensor, q: torch.Tensor, k: int, tile: int = 2048,
                exact: bool = False):
    """Per-sample ``knn`` over a batch, p [B,N,3], q [B,M,3] -> (dists [B,N,k],
    idx [B,N,k]); the candidate path is one K3 launch for the whole batch."""
    M = q.shape[1]
    if exact or M <= EXACT_MAX_POINTS:
        top, pos = smallest_k_stable(_sqdist(p, q), k)
        return top, pos.to(torch.int32)
    return knn_topk_batched(p.contiguous(), q.contiguous(), knn_subtile(M, k, tile), k)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along the first row.

    Its autograd is the cofactor matrix, which stays right on singular
    matrices, as JAX's cofactor-solve JVP of ``jnp.linalg.det`` does.
    """
    a = [[m[..., i, j] for j in range(3)] for i in range(3)]
    return (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
            - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))


def smallest_eigenvector(S: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric [..., 3, 3] matrices.

    Closed-form trigonometric eigenvalues and a cross product of two rows of
    S - eig3 I, ported operation for operation from the JAX package. Degenerate
    neighbourhoods (a small relative gap between the two smallest eigenvalues,
    vanishing cross products or near-zero scatter) fall back to +z, substituted
    before normalising so no gradient sees a zero norm.
    """
    eps = 1e-12
    tr = S.diagonal(dim1=-2, dim2=-1).sum(-1)
    qm = tr / 3.0
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    A = S - qm[..., None, None] * eye
    p2 = (A * A).sum((-2, -1))
    pval = torch.sqrt(torch.clamp(p2 / 6.0, min=eps))
    B = A / pval[..., None, None]
    # clip strictly inside (-1, 1): arccos' is infinite at +-1, which isotropic
    # neighbourhoods hit exactly
    r = torch.clamp(_det3(B) / 2.0, -1.0 + 1e-6, 1.0 - 1e-6)
    phi = torch.arccos(r) / 3.0
    eig1 = qm + 2.0 * pval * torch.cos(phi)
    eig3 = qm + 2.0 * pval * torch.cos(phi + 2.0 * math.pi / 3.0)
    eig2 = 3.0 * qm - eig1 - eig3

    C = S - eig3[..., None, None] * eye
    r0, r1, r2 = C[..., 0, :], C[..., 1, :], C[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c12 = torch.linalg.cross(r1, r2)
    c02 = torch.linalg.cross(r0, r2)
    n01 = (c01 * c01).sum(-1)
    n12 = (c12 * c12).sum(-1)
    n02 = (c02 * c02).sum(-1)
    choice = torch.argmax(torch.stack([n01, n12, n02], -1), -1)
    v = torch.where((choice == 0)[..., None], c01,
                    torch.where((choice == 1)[..., None], c12, c02))
    norm2 = (v * v).sum(-1)
    scale = torch.clamp(eig1.abs(), min=1e-6)
    degenerate = ((eig2 - eig3) < 1e-4 * scale) | (norm2 < 1e-12) | (p2 < 1e-18)
    fallback = torch.zeros_like(v)      # +z, made on the device: no copy from the host
    fallback[..., 2] = 1.0
    v = torch.where(degenerate[..., None], fallback, v)
    norm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(norm, min=1e-12)


def batched_compute_normals(pts: torch.Tensor, k: int = 10, tile: int = 2048,
                            exact: bool = False) -> torch.Tensor:
    """PCA normals of clouds [B,N,3] from each point's k nearest neighbours
    within its own cloud (``batched_knn``; all M of them with ``exact``):
    neighbourhood mean, scatter matrix, eigenvector of the smallest
    eigenvalue. Differentiable in ``pts`` through the gather."""
    B, N, _ = pts.shape
    idx = batched_knn(pts, pts, k, tile, exact)[1]
    neigh = batched_gather_rows(pts, idx.reshape(B, N * k)).reshape(B, N, k, 3)
    Y = neigh - neigh.mean(2, keepdim=True)
    S = torch.einsum("bnkd,bnke->bnde", Y, Y)
    return smallest_eigenvector(S)


def compute_normals(pts: torch.Tensor, k: int = 10, tile: int = 2048) -> torch.Tensor:
    """Single-cloud PCA normals [N, 3] (see ``batched_compute_normals``)."""
    return batched_compute_normals(pts[None], k=k, tile=tile)[0]


def batched_normal_distance(p: torch.Tensor, q: torch.Tensor, idx_p: torch.Tensor,
                            idx_q: torch.Tensor, k: int = 10, tile: int = 2048,
                            normals_p=None, normals_q=None, exact: bool = False):
    """Two-sided per-sample summed |cos| alignment of the normals of clouds
    p [B,N,3], q [B,M,3] at the nearest-neighbour indices -> ([B] sum_p, [B] sum_q).

    Given unit normals (the sampler's face normals) are used as they are; a
    cloud without them gets ``batched_compute_normals`` (with ``exact``).
    """
    n_p = normals_p if normals_p is not None else batched_compute_normals(p, k, tile, exact)
    n_q = normals_q if normals_q is not None else batched_compute_normals(q, k, tile, exact)
    nn_p = batched_gather_rows(n_q, idx_p)
    nn_q = batched_gather_rows(n_p, idx_q)
    return (n_p * nn_p).sum(-1).abs().sum(1), (n_q * nn_q).sum(-1).abs().sum(1)


def normal_distance(p: torch.Tensor, q: torch.Tensor, idx_p: torch.Tensor,
                    idx_q: torch.Tensor, k: int = 10, tile: int = 2048):
    """Single-pair ``batched_normal_distance`` with estimated normals -> (sum_p, sum_q)."""
    a, b = batched_normal_distance(p[None], q[None], idx_p[None], idx_q[None], k=k, tile=tile)
    return a[0], b[0]
