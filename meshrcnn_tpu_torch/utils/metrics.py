"""Confusion-matrix F-beta (counterpart of meshrcnn_tpu/utils/metrics.py::f_score)."""
from __future__ import annotations

import numpy as np


def f_score(confusion_matrix: np.ndarray, beta: float = 1.0) -> np.ndarray:
    """Per-class F-beta x100 from a confusion matrix (reference: metrics.py:7-28)."""
    cm = np.asarray(confusion_matrix, dtype=np.float64)
    tp = np.diag(cm)
    precision = tp / np.maximum(cm.sum(axis=0), 1e-12)
    recall = tp / np.maximum(cm.sum(axis=1), 1e-12)
    b2 = beta * beta
    denom = np.maximum(b2 * precision + recall, 1e-12)
    return 100.0 * (1 + b2) * precision * recall / denom
