"""Rotation matrix about the x axis (counterpart of meshrcnn_tpu/utils/rotation.py;
reference: utils/rotation.py:5-16)."""
from __future__ import annotations

import numpy as np


def rotation(alpha: float) -> np.ndarray:
    """[3,3] float32 rotation by ``alpha`` degrees about the x axis."""
    a = np.pi * alpha / 180.0
    return np.array([[1, 0, 0],
                     [0, np.cos(a), -np.sin(a)],
                     [0, np.sin(a), np.cos(a)]], dtype=np.float32)
