"""Running-average meters, progress lines and per-epoch stats files
(counterpart of meshrcnn_tpu/utils/meters.py; reference: utils/train_utils.py:33-107).

``AverageMeter`` skips non-finite values with a warning (53-63);
``ProgressMeter`` prints every ``print_freq`` batches; each epoch's meter
averages are pickled to a ``.st`` file, ``{key: {"name": str, "history":
[float, ...]}}``, the format ``plot_stats.py`` reads.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict, Iterable


class AverageMeter:
    """Average of the finite values it is given; non-finite ones are reported and skipped."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
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

    def __str__(self) -> str:
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(name=self.name, val=self.val, avg=self.avg)


class ProgressMeter:
    """Console progress lines every print_freq batches (reference: 66-86)."""

    def __init__(self, num_batches: int, meters: Iterable[AverageMeter], prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + str(num_batches) + "]"
        self.meters = list(meters)
        self.prefix = prefix

    def display(self, batch: int) -> None:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\t".join(entries))


def basic_metrics() -> Dict[str, AverageMeter]:
    """reference: train_utils.py:89-91."""
    return {"batch_time": AverageMeter("batch_time", ":6.3f"),
            "data_loading": AverageMeter("data_loading", ":6.3f")}


def gcn_metrics(voxel_only: bool = False) -> Dict[str, AverageMeter]:
    """reference: train_utils.py:99-107."""
    meters = basic_metrics()
    meters["voxel_loss"] = AverageMeter("voxel_loss", ":.4f")
    if not voxel_only:
        for k in ("chamfer_loss", "edge_loss", "normal_loss"):
            meters[k] = AverageMeter(k, ":.4f")
    return meters


def save_stats(meters: Dict[str, AverageMeter], path: str) -> None:
    """Pickle every meter's per-epoch history, as plain floats (reference: train.py:205-214)."""
    stats = {k: {"name": m.name, "history": [float(h) for h in m.history]}
             for k, m in meters.items()}
    with open(path, "wb") as f:
        pickle.dump(stats, f)


def load_stats(path: str) -> dict:
    """A ``.st`` file written by ``save_stats``; unpickle only files this program wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
