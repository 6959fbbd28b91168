"""Fixed-capacity padded mesh batch (counterpart of meshrcnn_tpu/core/mesh.py).

    verts      [B, Vmax, 3]  float32  padded vertex positions
    verts_mask [B, Vmax]     bool
    faces      [B, Fmax, 3]  int64    indices into the per-sample vertex axis
    faces_mask [B, Fmax]     bool
    edges      [B, Emax, 2]  int64    unique undirected edges (lo < hi)
    edges_mask [B, Emax]     bool

Padded face and edge rows point at vertex slot 0, so every gather stays in
bounds; the masks keep them out of every sum. ``pad_mesh_np`` pads one ragged
mesh on the host, for the data layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def pad_mesh_np(vertices, faces, vert_capacity: int, face_capacity: int,
                edge_capacity: int | None = None) -> dict:
    """Host-side (numpy) padding of one ragged mesh into fixed-capacity buffers.

    The data layer collates ground-truth meshes with it. A mesh larger than a
    capacity is truncated: vertices past ``vert_capacity`` are dropped with
    every face that uses one, then faces past ``face_capacity``.

    Returns a dict of numpy arrays: verts [Vmax,3] f32, verts_mask [Vmax] bool,
    faces [Fmax,3] i32, faces_mask [Fmax] bool (+ edges [Emax,2] i32 and
    edges_mask, the unique undirected edges, if ``edge_capacity`` is given).
    """
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int32)
    nv = min(v.shape[0], vert_capacity)
    if v.shape[0] > vert_capacity:
        f = f[(f < nv).all(axis=1)]
    nf = min(f.shape[0], face_capacity)
    verts = np.zeros((vert_capacity, 3), dtype=np.float32)
    verts[:nv] = v[:nv]
    verts_mask = np.zeros((vert_capacity,), dtype=bool)
    verts_mask[:nv] = True
    faces_out = np.zeros((face_capacity, 3), dtype=np.int32)
    faces_out[:nf] = f[:nf]
    faces_mask = np.zeros((face_capacity,), dtype=bool)
    faces_mask[:nf] = True
    out = dict(verts=verts, verts_mask=verts_mask, faces=faces_out, faces_mask=faces_mask)
    if edge_capacity is not None:
        e = np.concatenate([f[:nf][:, [0, 1]], f[:nf][:, [1, 2]], f[:nf][:, [0, 2]]], axis=0)
        e = np.sort(e, axis=1)
        e = np.unique(e, axis=0) if e.size else e.reshape(0, 2)
        ne = min(e.shape[0], edge_capacity)
        edges = np.zeros((edge_capacity, 2), dtype=np.int32)
        edges[:ne] = e[:ne]
        edges_mask = np.zeros((edge_capacity,), dtype=bool)
        edges_mask[:ne] = True
        out.update(edges=edges, edges_mask=edges_mask)
    return out
