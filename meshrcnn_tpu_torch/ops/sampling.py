"""Surface point sampling from padded meshes (counterpart of meshrcnn_tpu/ops/sampling.py).

Area-weighted face choice by inverse CDF, then the sqrt-barycentric trick
(reference: utils/mesh_sampling.py:6-36):
    w0 = 1 - sqrt(xi1); w1 = (1 - xi2) sqrt(xi1); w2 = xi2 sqrt(xi1).

Randomness comes from a ``uniform(shape)`` callable, drawn three times per
call in a fixed order: the face-choice uniforms ``u``, then ``xi1``, then
``xi2``, each [B, num_points], and used in the vertices' dtype. ``uniform_from(generator)`` makes one from a
``torch.Generator``; tests hand in the JAX package's draws instead.
``face_areas`` and ``sample_points`` are the single-sample forms.
"""
from __future__ import annotations

from typing import Callable

import torch

from meshrcnn_tpu_torch.core.mesh import normalize_verts_batched
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows

Uniform = Callable[[tuple], torch.Tensor]


def uniform_from(generator: torch.Generator) -> Uniform:
    """Uniform [0, 1) float32 draws of a given shape from ``generator``, on its device."""
    return lambda shape: torch.rand(shape, generator=generator,
                                    device=generator.device, dtype=torch.float32)


def face_areas(verts: torch.Tensor, faces: torch.Tensor,
               faces_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Triangle areas |AB x AC| / 2 (reference: mesh_sampling.py:39-57):
    verts [V, 3], faces [F, 3] -> [F]; masked faces get area 0."""
    tri = verts[faces.long()]                                     # [F, 3, 3]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    areas = 0.5 * torch.linalg.vector_norm(n, dim=-1)
    if faces_mask is not None:
        areas = torch.where(faces_mask, areas, torch.zeros_like(areas))
    return areas


def sample_points(verts: torch.Tensor, faces: torch.Tensor, faces_mask: torch.Tensor,
                  num_points: int, uniform: Uniform, normalize: bool = True):
    """One padded mesh: verts [V,3], faces [F,3], faces_mask [F] -> (points
    [num_points, 3], valid [] bool), ``batched_sample_points`` of a batch of
    one (its three draws are [1, num_points])."""
    pts, valid = batched_sample_points(verts[None], faces[None], faces_mask[None],
                                       num_points, uniform, normalize)
    return pts[0], valid[0]


def batched_sample_points(verts: torch.Tensor, faces: torch.Tensor,
                          faces_mask: torch.Tensor, num_points: int,
                          uniform: Uniform, normalize: bool = True,
                          return_normals: bool = False):
    """verts [B,V,3], faces [B,F,3], faces_mask [B,F] -> (points [B,N,3], valid [B]).

    ``valid`` is False for a mesh with no real face area; its cloud is all zeros.
    ``return_normals=True`` also returns the unit normal of each point's face
    ([B,N,3]); a degenerate face falls back to +z.
    """
    B, F = faces.shape[0], faces.shape[1]
    dev = verts.device
    faces = faces.long()
    bidx = torch.arange(B, device=dev)[:, None, None]
    # areas only pick integer faces: their gradient is zero, so no graph
    tri = verts.detach()[bidx, faces]                            # [B, F, 3, 3]
    ab = tri[:, :, 1] - tri[:, :, 0]
    ac = tri[:, :, 2] - tri[:, :, 0]
    areas = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(ab, ac), dim=-1)
    areas = torch.where(faces_mask, areas, torch.zeros_like(areas))
    total = areas.sum(1)
    valid = total > 1e-12
    probs = areas / torch.where(valid, total, torch.ones_like(total))[:, None]
    cdf = torch.cumsum(probs, dim=1)
    u = uniform((B, num_points)).to(dev, verts.dtype)
    face_idx = torch.searchsorted(cdf, u, side="left").clamp(max=F - 1)

    corners = batched_gather_rows(faces, face_idx)                # [B, N, 3]
    chosen = batched_gather_rows(verts, corners.reshape(B, -1)).reshape(B, num_points, 3, 3)
    xi1_sqrt = torch.sqrt(uniform((B, num_points)).to(dev, verts.dtype))
    xi2 = uniform((B, num_points)).to(dev, verts.dtype)
    w0 = 1.0 - xi1_sqrt
    w1 = (1.0 - xi2) * xi1_sqrt
    w2 = xi2 * xi1_sqrt
    pts = (chosen[:, :, 0] * w0[..., None] + chosen[:, :, 1] * w1[..., None]
           + chosen[:, :, 2] * w2[..., None])
    if normalize:
        pts = normalize_verts_batched(pts)
    pts = torch.where(valid[:, None, None], pts, torch.zeros_like(pts))
    if not return_normals:
        return pts, valid
    n = torch.linalg.cross(chosen[:, :, 1] - chosen[:, :, 0],
                           chosen[:, :, 2] - chosen[:, :, 0])
    norm2 = (n * n).sum(-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=dev).expand_as(n)
    n = torch.where(norm2 > 1e-20, n, fallback)
    normals = n / torch.sqrt((n * n).sum(-1, keepdim=True).clamp(min=1e-20))
    normals = torch.where(valid[:, None, None], normals, torch.zeros_like(normals))
    return pts, valid, normals
