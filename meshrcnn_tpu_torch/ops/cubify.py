"""Cubify: voxel occupancy grid -> padded triangle mesh batch
(counterpart of meshrcnn_tpu/ops/cubify.py; reference: meshRCNN/layers.py:342-484).

Slot order equals the JAX package's, slot by slot:
  * vertices: slot s takes the s-th used corner of the (Z+1, Y+1, X+1) lattice
    in raster order; a corner's vertex id is its rank among used corners;
  * faces: candidate triangles are laid out direction-major, two halves per
    direction, raster voxel order inside; slot s takes the s-th exposed one;
  * edges: unique undirected (lo, hi) pairs in lexicographic order.
"Slot s takes the s-th flagged entry" is a ``searchsorted`` of s + 1 in the
inclusive cumsum of the flags. Corners sit at voxel index -/+ 0.5, and the
coordinates are rotated (z, y, x) -> (z, x, -y) as the reference does.
Elements past a capacity are dropped and counted in ``CubifyOverflow``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from meshrcnn_tpu_torch.core.mesh import MeshBatch

# Per-direction corner lattice offsets (oz, oy, ox) (reference: layers.py:370-400).
# Directions: 0 back(z-1) 1 front(z+1) 2 top(y+1) 3 bottom(y-1) 4 left(x-1) 5 right(x+1).
_CORNERS = (
    ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)),  # back
    ((1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)),  # front
    ((1, 0, 0), (1, 0, 1), (0, 0, 0), (0, 0, 1)),  # top
    ((0, 1, 0), (0, 1, 1), (1, 1, 0), (1, 1, 1)),  # bottom
    ((1, 0, 0), (0, 0, 0), (1, 1, 0), (0, 1, 0)),  # left
    ((0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)),  # right
)
# Neighbour shift for the exposure test per direction: (dz, dy, dx).
_NEIGHBOR = ((-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1))
# Corner table per (direction, half): half 0 is (c0, c1, c2), half 1 is (c0, c2, c3).
_TRIANGLES = tuple(tri for cs in _CORNERS
                   for tri in ((cs[0], cs[1], cs[2]), (cs[0], cs[2], cs[3])))


@dataclasses.dataclass
class CubifyOverflow:
    """Per-sample counts of mesh elements that exceeded static capacity."""
    verts: torch.Tensor  # [B] int64
    faces: torch.Tensor
    edges: torch.Tensor

    def any(self) -> torch.Tensor:
        return (self.verts + self.faces + self.edges) > 0


def _neighbor_occ(occ: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """occ[:, z+dz, y+dy, x+dx] with zeros outside the grid."""
    _, Z, Y, X = occ.shape
    p = F.pad(occ, (1, 1, 1, 1, 1, 1))
    return p[:, 1 + dz:1 + dz + Z, 1 + dy:1 + dy + Y, 1 + dx:1 + dx + X]


def _compact(cum: torch.Tensor, capacity: int):
    """Slot s takes the s-th flagged entry. cum [B, N] is the inclusive cumsum of
    the flags -> (src [B, cap], mask [B, cap], count [B] uncapped)."""
    B, N = cum.shape
    slots = torch.arange(1, capacity + 1, device=cum.device).expand(B, capacity)
    src = torch.searchsorted(cum, slots.contiguous(), side="left").clamp(max=N - 1)
    count = cum[:, -1]
    mask = slots <= count[:, None]
    return src, mask, count


def batched_edges_from_faces(faces: torch.Tensor, faces_mask: torch.Tensor,
                             edge_capacity: int):
    """Unique undirected edges of padded triangle lists, in lexicographic order.

    Returns (edges [B, cap, 2], edges_mask [B, cap], overflow [B]).
    """
    f = faces.long()
    a = torch.cat([f[:, :, 0], f[:, :, 1], f[:, :, 0]], dim=1)
    b = torch.cat([f[:, :, 1], f[:, :, 2], f[:, :, 2]], dim=1)
    big = 2 ** 31 - 1
    m3 = torch.cat([faces_mask] * 3, dim=1)
    lo = torch.where(m3, torch.minimum(a, b), big)
    hi = torch.where(m3, torch.maximum(a, b), big)
    # one int64 key orders (lo, hi) lexicographically: both fit in 31 bits
    key = torch.sort((lo << 32) | hi, dim=1).values
    valid = key < (big << 32)
    first = torch.ones_like(valid)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    cum = torch.cumsum((valid & first).long(), dim=1)
    src, mask, n_unique = _compact(cum, edge_capacity)
    k = torch.gather(key, 1, src)
    edges = torch.stack([k >> 32, k & (2 ** 32 - 1)], dim=-1)
    edges = torch.where(mask[..., None], edges, 0)
    return edges, mask, (n_unique - edge_capacity).clamp(min=0)


def cubify(grid: torch.Tensor, threshold: float = 0.5, *, vert_capacity: int = 4096,
           face_capacity: int = 8192, edge_capacity: int = 16384):
    """Cubify occupancy probabilities [B, Z, Y, X] -> (MeshBatch, CubifyOverflow).

    Vertices come out in the grid's dtype (their half-integer coordinates are
    exact in any float type). An empty grid gives an all-masked sample.
    """
    B, Z, Y, X = grid.shape
    dev = grid.device
    occ = grid > threshold
    exposed = [occ & ~_neighbor_occ(occ, *_NEIGHBOR[d]) for d in range(6)]

    used = torch.zeros((B, Z + 1, Y + 1, X + 1), dtype=torch.bool, device=dev)
    for d in range(6):
        for (oz, oy, ox) in _CORNERS[d]:
            used |= F.pad(exposed[d], (ox, 1 - ox, oy, 1 - oy, oz, 1 - oz))
    cum_used = torch.cumsum(used.reshape(B, -1).long(), dim=1)
    vid = cum_used - 1                                 # vertex id of each used corner

    # ---- vertices: used corners in raster order --------------------------------
    lz, ly, lx = torch.meshgrid(torch.arange(Z + 1, device=dev),
                                torch.arange(Y + 1, device=dev),
                                torch.arange(X + 1, device=dev), indexing="ij")
    coords = torch.stack([lz.reshape(-1) - 0.5, lx.reshape(-1) - 0.5,
                          -(ly.reshape(-1) - 0.5)], dim=-1).to(grid.dtype)
    v_src, verts_mask, n_verts = _compact(cum_used, vert_capacity)
    verts = torch.where(verts_mask[..., None], coords[v_src], 0.0)

    # ---- faces: exposed candidates, direction-major, two halves each -------------
    cand = torch.stack([e.reshape(B, -1) for e in exposed], dim=1)  # [B, 6, ZYX]
    cand = cand.repeat_interleave(2, dim=1).reshape(B, -1)           # [B, 12*ZYX]
    f_src, faces_mask, n_faces = _compact(torch.cumsum(cand.long(), dim=1),
                                          face_capacity)
    ZYX = Z * Y * X
    block, v = f_src // ZYX, f_src % ZYX
    z, y, x = v // (Y * X), (v // X) % Y, v % X
    tbl = torch.tensor(_TRIANGLES, device=dev)         # [12, 3 corners, (oz, oy, ox)]
    off = tbl[block]                                   # [B, Fcap, 3, 3]
    lat = ((z[..., None] + off[..., 0]) * ((Y + 1) * (X + 1))
           + (y[..., None] + off[..., 1]) * (X + 1) + (x[..., None] + off[..., 2]))
    faces = torch.gather(vid, 1, lat.reshape(B, -1)).reshape(B, face_capacity, 3)
    face_valid = faces_mask & (faces < vert_capacity).all(-1)
    faces = torch.where(face_valid[..., None], faces, 0)

    edges, edges_mask, e_overflow = batched_edges_from_faces(faces, face_valid,
                                                             edge_capacity)
    mesh = MeshBatch(verts=verts, verts_mask=verts_mask, faces=faces,
                     faces_mask=face_valid, edges=edges, edges_mask=edges_mask)
    overflow = CubifyOverflow(verts=(n_verts - vert_capacity).clamp(min=0),
                              faces=(n_faces - face_capacity).clamp(min=0),
                              edges=e_overflow)
    return mesh, overflow
