"""RoIAlign and multiscale (FPN) RoIAlign by corner gathers
(counterpart of meshrcnn_tpu/ops/roi_align.py's corner-gather path; reference:
meshRCNN/layers.py:5, 819-842).

For each RoI an ``output_size x output_size`` grid of bins is sampled at
``sampling_ratio x sampling_ratio`` bilinear points a bin and averaged. Feature
maps are read channels-last, so each bilinear corner is one gather of
[B, R, P, P, C] rows (P = output_size * sampling_ratio). The JAX package's
default separable-matmul form (``MESHRCNN_MATMUL_ROIALIGN=1``) is a rewrite
for the TPU's matrix unit, whose gathers are slow; it is not ported. Neither
form is a Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


def _sample_grid(start: torch.Tensor, bin_size: torch.Tensor, output_size: int,
                 s: int) -> torch.Tensor:
    """Sample coordinates start + (i + (k + 0.5) / s) * bin [..., R, output_size*s]."""
    grid = (torch.arange(output_size, dtype=torch.float32, device=start.device)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=start.device)[None, :] + 0.5) / s)
    return start[..., None] + grid.reshape(-1) * bin_size[..., None]


def _corner_gather(flat: torch.Tensor, base: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor, hi_y, hi_x, row: int, output_size: int,
                   s: int) -> torch.Tensor:
    """Bilinear samples of channels-last rows ``flat`` [*, C] averaged per bin.

    base [B, R] is each RoI's first row, ys / xs [B, R, P] its sample
    coordinates, hi_y / hi_x the largest coordinate of its map, ``row`` the
    row stride of a map line (an int, or [B, R, 1, 1] per RoI). Returns [B, R, output_size, output_size, C].
    A NaN coordinate reads row 0 of its map with NaN weights: the integer
    corners are clamped into the map after the conversion, so no gather
    leaves it.
    """
    ys = torch.minimum(ys.clamp(min=0.0), hi_y)
    xs = torch.minimum(xs.clamp(min=0.0), hi_x)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = ys - y0
    fx = xs - x0
    hi_yi, hi_xi = hi_y.long(), hi_x.long()
    y0i = torch.minimum(y0.long().clamp(min=0), hi_yi)
    x0i = torch.minimum(x0.long().clamp(min=0), hi_xi)
    y1i = torch.minimum(y0i + 1, hi_yi)
    x1i = torch.minimum(x0i + 1, hi_xi)
    B, R, P = ys.shape
    C = flat.shape[-1]

    def gather(yi, xi):
        idx = base[..., None, None] + yi[..., :, None] * row + xi[..., None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(B, R, P, P, C)

    wy0 = (1.0 - fy)[..., :, None, None]
    wy1 = fy[..., :, None, None]
    wx0 = (1.0 - fx)[..., None, :, None]
    wx1 = fx[..., None, :, None]
    vals = (gather(y0i, x0i) * wy0 * wx0 + gather(y0i, x1i) * wy0 * wx1
            + gather(y1i, x0i) * wy1 * wx0 + gather(y1i, x1i) * wy1 * wx1)
    O = output_size
    return vals.reshape(B, R, O, s, O, s, C).mean(dim=(3, 5))


def roi_align(fmap: torch.Tensor, boxes: torch.Tensor, spatial_scale: float,
              output_size: int, sampling_ratio: int = 2) -> torch.Tensor:
    """Single-level RoIAlign: fmap [B, H, W, C] (channels-last), boxes [B, R, 4]
    -> [B, R, output_size, output_size, C]."""
    B, H, W, C = fmap.shape
    b = boxes * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    s = max(sampling_ratio, 1)
    ys = _sample_grid(y1, (y2 - y1).clamp(min=1.0) / output_size, output_size, s)
    xs = _sample_grid(x1, (x2 - x1).clamp(min=1.0) / output_size, output_size, s)
    base = (torch.arange(B, device=fmap.device) * (H * W))[:, None].expand(B, boxes.shape[1])
    hi_y = torch.full_like(ys, H - 1)
    hi_x = torch.full_like(xs, W - 1)
    return _corner_gather(fmap.reshape(B * H * W, C), base, ys, xs, hi_y, hi_x, W,
                          output_size, s)


def fpn_levels(boxes: torch.Tensor, num_levels: int, canonical_scale: int = 224,
               canonical_level: int = 4) -> torch.Tensor:
    """0-based FPN level of each box: floor(k0 + log2(sqrt(area) / 224)) clamped
    to P2..P(1+num_levels) (FPN paper eqn. 1). log2 is log(x) / log(2) in
    float32, as ``jnp.log2`` computes it, so boxes on a level boundary land
    where the JAX package puts them. Both divisions take a tensor divisor: a
    Python number would make the card multiply by its reciprocal instead. A
    box with a NaN coordinate (a step the train loop will skip) gets P2."""
    areas = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=1e-6)
    const = torch.tensor([float(canonical_scale), 2.0], device=boxes.device)
    log2 = torch.log(torch.sqrt(areas) / const[0]) / torch.log(const[1])
    k = torch.floor(canonical_level + log2)
    return k.clamp(2, 2 + num_levels - 1).nan_to_num(2.0).long() - 2


class FeatureLevels(NamedTuple):
    """FPN levels as one channels-last row table: level l's rows
    [B, H_l, W_l] start at ``offsets[l]`` of ``flat`` [sum B*H_l*W_l, C]."""
    flat: torch.Tensor
    offsets: tuple[int, ...]
    heights: tuple[int, ...]
    widths: tuple[int, ...]


def flatten_levels(feature_maps: Sequence[torch.Tensor]) -> FeatureLevels:
    """NCHW maps [B, C, H_l, W_l], highest resolution first -> FeatureLevels.
    Built once a forward and read by every pool of it.

    A bfloat16 table that needs a gradient is cast to float32: the gathers'
    backward is an ``index_add_`` into the table, and the hundreds of RoIs of
    an image overlap on the same rows, so bfloat16 sums would lose most of the
    gradient's digits. A bfloat16 value is exact in float32, so the forward is
    unchanged; the gradient is rounded to bfloat16 once, at the cast."""
    rows = [f.permute(0, 2, 3, 1).reshape(-1, f.shape[1]) for f in feature_maps]
    offsets = [0]
    for r in rows[:-1]:
        offsets.append(offsets[-1] + r.shape[0])
    flat = torch.cat(rows)
    if flat.requires_grad and flat.dtype.itemsize < 4:
        flat = flat.float()
    return FeatureLevels(flat, tuple(offsets),
                         tuple(f.shape[2] for f in feature_maps),
                         tuple(f.shape[3] for f in feature_maps))


def multiscale_roi_align(levels: FeatureLevels, boxes: torch.Tensor,
                         image_size: tuple[int, int], output_size: int,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """FPN-level-aware RoIAlign (torchvision MultiScaleRoIAlign semantics).

    levels: ``flatten_levels`` of the maps; boxes [B, R, 4] xyxy in image
    pixels. Each RoI reads only its own level, with its sample coordinates
    clipped to that level's extent. Returns [B, R, output_size, output_size, C]
    in float32 (bfloat16 maps are read as they are and weighted in float32).
    """
    L = len(levels.offsets)
    dev = boxes.device
    k = fpn_levels(boxes, L)                                       # [B, R]
    scales = torch.tensor([h / image_size[0] for h in levels.heights],
                          dtype=torch.float32, device=dev)[k]
    Hl = torch.tensor(levels.heights, device=dev)[k]
    Wl = torch.tensor(levels.widths, device=dev)[k]
    b = boxes * scales[..., None]
    x1, y1, x2, y2 = b.unbind(-1)
    s = max(sampling_ratio, 1)
    ys = _sample_grid(y1, (y2 - y1).clamp(min=1.0) / output_size, output_size, s)
    xs = _sample_grid(x1, (x2 - x1).clamp(min=1.0) / output_size, output_size, s)
    bi = torch.arange(boxes.shape[0], device=dev)[:, None]
    base = torch.tensor(levels.offsets, device=dev)[k] + bi * Hl * Wl
    hi_y = (Hl - 1)[..., None].to(torch.float32).expand_as(ys)
    hi_x = (Wl - 1)[..., None].to(torch.float32).expand_as(xs)
    return _corner_gather(levels.flat, base, ys, xs, hi_y, hi_x, Wl[..., None, None],
                          output_size, s)
