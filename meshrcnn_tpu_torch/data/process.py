"""Host-side mesh and voxel preprocessing in numpy
(counterpart of meshrcnn_tpu/data/process.py; reference: utils/process.py).

Mesh normalisation into the unit ball, and voxel grid resampling: adaptive
max pool down, nearest neighbour up (reference: process.py:23-39; torch's
``interpolate`` defaults to nearest).
"""
from __future__ import annotations

import numpy as np


def normalize_mesh(vertices: np.ndarray) -> np.ndarray:
    """Center on the mean; scale by the largest vertex norm only if a
    coordinate leaves [-1, 1] (reference: process.py:7-20)."""
    v = np.asarray(vertices, dtype=np.float32)
    v = v - v.mean(axis=0)
    if np.max(np.abs(v)) <= 1:
        return v
    factor = np.sqrt((v * v).sum(axis=1).max())
    return v / factor


def _adaptive_max_pool_1d_bounds(in_size: int, out_size: int):
    starts = (np.arange(out_size) * in_size) // out_size
    ends = -(-((np.arange(out_size) + 1) * in_size) // out_size)
    return starts, ends


def resample_voxels(voxels: np.ndarray, n: int) -> np.ndarray:
    """Resample a [B, M, M, M] grid to [B, n, n, n]: adaptive max pool when
    M > n (occupancy-preserving), nearest neighbour when M < n."""
    v = np.asarray(voxels)
    if v.ndim != 4:
        raise ValueError(f"expects a batched grid [B, M, M, M], got shape {v.shape}")
    m = v.shape[1]
    if m == n:
        return v
    if m > n:
        s, e = _adaptive_max_pool_1d_bounds(m, n)
        for axis in (1, 2, 3):
            v = np.stack([v.take(range(s[i], e[i]), axis=axis).max(axis=axis)
                          for i in range(n)], axis=axis)
        return v
    idx = (np.arange(n) * m) // n
    return v[:, idx][:, :, idx][:, :, :, idx]
