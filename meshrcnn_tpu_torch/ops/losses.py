"""Mesh and voxel losses on padded buffers (counterpart of meshrcnn_tpu/ops/losses.py).

Conventions of the reference loss suite (meshRCNN/loss_functions.py):
  * chamfer is the sum of both one-sided sums divided by the cloud size once;
  * normal is the negated summed |cos| divided by the cloud size;
  * edge is the mean squared edge length over the batch's valid edges
    (one batch-global normaliser).
Empty meshes sample all-zero clouds and are masked out by ``valid``.
Normals are the exact face normals of the sampled triangles by default
(``face_normals=True``, the JAX package's default); ``face_normals=False``
estimates both clouds' normals by kNN + PCA (K3), the reference's construction,
which the JAX package selects with ``MESHRCNN_FACE_NORMALS=0``. The port reads
no environment variable: the caller passes the switch.
"""
from __future__ import annotations

from typing import Sequence

import torch

from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.ops.chamfer import batched_normal_distance
from meshrcnn_tpu_torch.ops.chamfer_cuda import chamfer_sums_batched
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.sampling import Uniform, batched_sample_points


def voxel_loss(voxel_pred: torch.Tensor, voxel_gt: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """Mean BCE between occupancy probabilities and {0,1} targets."""
    p = voxel_pred.clamp(eps, 1.0 - eps)
    t = voxel_gt.to(p.dtype)
    return -(t * torch.log(p) + (1.0 - t) * torch.log1p(-p)).mean()


def edge_loss(verts: torch.Tensor, edges: torch.Tensor,
              edges_mask: torch.Tensor) -> torch.Tensor:
    """Mean squared edge length over all valid edges of verts [B,V,3], edges [B,E,2]."""
    d = batched_gather_rows(verts, edges[..., 0]) - batched_gather_rows(verts, edges[..., 1])
    m = edges_mask.to(verts.dtype)
    return ((d * d).sum(-1) * m).sum() / m.sum().clamp(min=1.0)


def mesh_loss(pred_verts: torch.Tensor, pred_mesh: MeshBatch,
              gt_verts: torch.Tensor, gt_faces: torch.Tensor,
              gt_faces_mask: torch.Tensor, uniform: Uniform,
              point_cloud_size: int = 10000, compute_normal: bool = True,
              num_neighbours: int = 10, tile: int = 2048, face_normals: bool = True):
    """(chamfer, normal, edge) for one refinement stage.

    Samples the predicted cloud, then the ground-truth cloud (three uniforms
    each, in that order), and sends the pair through K1. ``compute_normal=False``
    skips the normal term (it reads 0).
    """
    e_loss = edge_loss(pred_verts, pred_mesh.edges, pred_mesh.edges_mask)
    # face normals come with the samples; estimated ones are computed below
    with_normals = compute_normal and face_normals
    cloud_p, valid_p, *norm_p = batched_sample_points(
        pred_verts, pred_mesh.faces, pred_mesh.faces_mask, point_cloud_size,
        uniform, return_normals=with_normals)
    cloud_g, valid_g, *norm_g = batched_sample_points(
        gt_verts, gt_faces, gt_faces_mask, point_cloud_size, uniform,
        return_normals=with_normals)
    valid = (valid_p & valid_g).to(torch.float32)
    cham_p, idx_p, cham_g, idx_g = chamfer_sums_batched(cloud_p, cloud_g)
    chamfer = ((cham_p + cham_g) * valid).sum() / point_cloud_size
    if compute_normal:
        align_p, align_g = batched_normal_distance(
            cloud_p, cloud_g, idx_p, idx_g, k=num_neighbours, tile=tile,
            normals_p=norm_p[0] if norm_p else None,
            normals_q=norm_g[0] if norm_g else None)
        normal = -((align_p + align_g) * valid).sum() / point_cloud_size
    else:
        normal = torch.zeros((), dtype=torch.float32, device=pred_verts.device)
    return chamfer, normal, e_loss


def batched_mesh_loss(stage_verts: Sequence[torch.Tensor], pred_mesh: MeshBatch,
                      gt_verts: torch.Tensor, gt_faces: torch.Tensor,
                      gt_faces_mask: torch.Tensor, uniform: Uniform,
                      point_cloud_size: int = 10000, compute_normal: bool = True,
                      num_neighbours: int = 10, tile: int = 2048,
                      face_normals: bool = True):
    """Sum of ``mesh_loss`` over the refinement stages, drawing stage by stage."""
    chamfer = normal = edge = 0.0
    for verts in stage_verts:
        c, n, e = mesh_loss(verts, pred_mesh, gt_verts, gt_faces, gt_faces_mask,
                            uniform, point_cloud_size, compute_normal,
                            num_neighbours, tile, face_normals)
        chamfer = chamfer + c
        normal = normal + n
        edge = edge + e
    return chamfer, normal, edge
