"""Running-average meters (counterpart of meshrcnn_tpu/utils/meters.py;
reference: utils/train_utils.py:33-107)."""
from __future__ import annotations

import math
from typing import Dict


class AverageMeter:
    """Average of the finite values it is given; non-finite ones are reported and skipped."""

    def __init__(self, name: str):
        self.name = name
        self.history = []        # the average of each finished epoch
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        val = float(val)
        if not math.isfinite(val):
            print(f"warning meter {self.name} received a non finite value {val}")
            return
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def epoch_end(self) -> None:
        self.history.append(self.avg)
        self.reset()


def gcn_metrics(voxel_only: bool = False) -> Dict[str, AverageMeter]:
    """reference: train_utils.py:89-107."""
    meters = {"batch_time": AverageMeter("batch_time"),
              "data_loading": AverageMeter("data_loading"),
              "voxel_loss": AverageMeter("voxel_loss")}
    if not voxel_only:
        for k in ("chamfer_loss", "edge_loss", "normal_loss"):
            meters[k] = AverageMeter(k)
    return meters
