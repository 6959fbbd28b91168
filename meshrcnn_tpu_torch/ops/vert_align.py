"""VertexAlign: perceptual feature pooling at projected vertices
(counterpart of meshrcnn_tpu/ops/vert_align.py; reference: meshRCNN/layers.py:509-613).

Camera intrinsics match the reference: h = 248 Y/Z + 111.5, w = 248 X/(-Z) + 111.5,
clamped to the image. Sampling is true bilinear from the floor corners with the
upper corner clamped, written as explicit gathers (``grid_sample``'s coordinate
convention differs). Padded vertex rows produce values that masks kill downstream.
"""
from __future__ import annotations

from typing import Sequence

import torch

from meshrcnn_tpu_torch.ops.gather import batched_gather_rows


def project_verts(verts: torch.Tensor, image_size: tuple[int, int],
                  focal: float = 248.0, center: float = 111.5):
    """Camera projection of [..., 3] positions to clamped (h, w) pixel coordinates."""
    X, Y, Z = verts[..., 0], verts[..., 1], verts[..., 2]
    safe_z = torch.where(Z.abs() < 1e-6, torch.full_like(Z, 1e-6), Z)
    h = focal * (Y / safe_z) + center
    w = focal * (X / -safe_z) + center
    H, W = image_size
    return h.clamp(0.0, H - 1), w.clamp(0.0, W - 1)


def _bilinear_sample_batched(fmap: torch.Tensor, rows: torch.Tensor,
                             cols: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of fmap [B, Hf, Wf, C] at fractional (rows, cols) [B, V] -> [B, V, C]."""
    B, Hf, Wf, C = fmap.shape
    r0 = torch.floor(rows)
    c0 = torch.floor(cols)
    fr = (rows - r0)[..., None]
    fc = (cols - c0)[..., None]
    r0i = r0.long().clamp(0, Hf - 1)      # a NaN coordinate reads row 0 and stays NaN
    c0i = c0.long().clamp(0, Wf - 1)
    r1i = (r0i + 1).clamp(max=Hf - 1)
    c1i = (c0i + 1).clamp(max=Wf - 1)
    rows_of = fmap.reshape(B, Hf * Wf, C)

    def g(r, c):
        return batched_gather_rows(rows_of, r * Wf + c)

    return (g(r0i, c0i) * ((1 - fr) * (1 - fc)) + g(r0i, c1i) * ((1 - fr) * fc)
            + g(r1i, c0i) * (fr * (1 - fc)) + g(r1i, c1i) * (fr * fc))


def vert_align(feature_maps: Sequence[torch.Tensor], verts: torch.Tensor,
               image_size: tuple[int, int], combine: str = "concat") -> torch.Tensor:
    """Pool NHWC feature maps [B, Hf, Wf, C_l] at the projections of verts [B, V, 3].

    ``combine`` is "concat" (channels across levels) or "sum" (equal C_l).
    """
    h, w = project_verts(verts, image_size)
    H, W = image_size
    feats = []
    for fm in feature_maps:
        Hf, Wf = fm.shape[1:3]
        rows = (h / (float(H) / Hf)).clamp(0.0, Hf - 1)
        cols = (w / (float(W) / Wf)).clamp(0.0, Wf - 1)
        feats.append(_bilinear_sample_batched(fm, rows, cols))
    if combine == "sum":
        out = feats[0]
        for f in feats[1:]:
            out = out + f
        return out
    return torch.cat(feats, dim=-1)
