"""Eval step (counterpart of meshrcnn_tpu/parallel/train_step.py::make_eval_step).

The train step, the optimizer and data parallelism are later slices.
"""
from __future__ import annotations

from typing import Callable

import torch

from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel, ShapeNetOutput


def make_eval_step(model: ShapeNetModel) -> Callable[[torch.Tensor], ShapeNetOutput]:
    """The eval forward: BatchNorm on running statistics, no autograd graph.

    The backbone runs in full float32: TF32, which keeps about three decimal
    digits and which cuDNN convolutions use by default, is switched off for
    matmuls and convolutions alike (process-wide PyTorch flags).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step(images: torch.Tensor) -> ShapeNetOutput:
        model.eval()
        with torch.no_grad():
            return model(images)
    return step
