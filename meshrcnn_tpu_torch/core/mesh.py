"""Fixed-capacity padded mesh batch (counterpart of meshrcnn_tpu/core/mesh.py).

    verts      [B, Vmax, 3]  float32  padded vertex positions
    verts_mask [B, Vmax]     bool
    faces      [B, Fmax, 3]  int64    indices into the per-sample vertex axis
    faces_mask [B, Fmax]     bool
    edges      [B, Emax, 2]  int64    unique undirected edges (lo < hi)
    edges_mask [B, Emax]     bool

Padded face and edge rows point at vertex slot 0, so every gather stays in
bounds; the masks keep them out of every sum.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MeshBatch:
    verts: torch.Tensor
    verts_mask: torch.Tensor
    faces: torch.Tensor
    faces_mask: torch.Tensor
    edges: torch.Tensor
    edges_mask: torch.Tensor

    def num_verts(self) -> torch.Tensor:
        return self.verts_mask.sum(1)

    def num_faces(self) -> torch.Tensor:
        return self.faces_mask.sum(1)

    def num_edges(self) -> torch.Tensor:
        return self.edges_mask.sum(1)


def normalize_verts(verts: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Center [V, 3] vertices, and scale them into the unit ball when any
    coordinate leaves [-1, 1] (reference: utils/process.py:7-20). Masked rows
    are left out of the statistics and zeroed."""
    if mask is None:
        centered = verts - verts.mean(0, keepdim=True)
    else:
        m = mask.to(verts.dtype)[:, None]
        mean = (verts * m).sum(0, keepdim=True) / m.sum().clamp(min=1.0)
        centered = (verts - mean) * m
    return centered / _unit_ball_factor(centered)


def normalize_verts_batched(verts: torch.Tensor) -> torch.Tensor:
    """``normalize_verts`` of every sample of [B, N, 3] (no mask)."""
    centered = verts - verts.mean(1, keepdim=True)
    return centered / _unit_ball_factor(centered, dims=(1, 2))[:, None, None]


def _unit_ball_factor(centered: torch.Tensor, dims=None) -> torch.Tensor:
    if dims is None:
        needs = centered.abs().max() > 1.0
        factor = (centered * centered).sum(-1).max().sqrt()
    else:
        needs = centered.abs().amax(dim=dims) > 1.0
        factor = (centered * centered).sum(-1).amax(dim=1).sqrt()
    return torch.where(needs, factor.clamp(min=1e-12), torch.ones_like(factor))
