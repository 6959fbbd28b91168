"""The host batch the data layer collates (counterpart of meshrcnn_tpu/core/batch.py).

A plain dataclass of numpy arrays with the JAX ``Batch``'s fields; the train
step copies it to the device with ``parallel/train_step.Batch.from_host``,
which reads the fields by name, and the eval loops read the same attributes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Batch:
    images: np.ndarray          # [B, H, W, 3] float32 in [0, 1]
    voxels: np.ndarray          # [B, V, V, V] {0,1} ground-truth occupancy
    gt_verts: np.ndarray        # [B, Vgt, 3] float32
    gt_verts_mask: np.ndarray   # [B, Vgt] bool
    gt_faces: np.ndarray        # [B, Fgt, 3] int32
    gt_faces_mask: np.ndarray   # [B, Fgt] bool
    labels: np.ndarray          # [B] int32 class labels
    # Pix3D-only detection targets (None for ShapeNet):
    boxes: Optional[np.ndarray] = None   # [B, 1, 4] xyxy ground-truth box
    masks: Optional[np.ndarray] = None   # [B, H, W] binary instance mask

    @property
    def batch_size(self) -> int:
        return self.images.shape[0]
