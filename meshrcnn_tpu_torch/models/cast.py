"""Layers that compute in a set dtype, as flax layers built with ``dtype=``.

flax's ``nn.Conv`` / ``nn.Dense`` / ``nn.ConvTranspose`` with ``dtype=bfloat16``
cast their input, kernel and bias to bfloat16 and return bfloat16, while the
parameters stay float32. These subclasses do the same with explicit casts, so
each layer follows flax's rule and not ``torch.autocast``'s operator lists.
``compute_dtype=None`` (float32, the parity mode) casts nothing: the layer is
its torch base class and computes in its parameters' dtype (float64 too).
Their parameters and state-dict names are those of the torch base classes;
their initial weights are flax's (``models/init.py``): ``lecun_normal``
kernels and zero biases.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from meshrcnn_tpu_torch.models.init import reset_layer_


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The JAX package's dtype name -> the layers' ``compute_dtype``: None for
    "float32", torch.bfloat16 for "bfloat16"."""
    return None if name == "float32" else getattr(torch, name)


def float32_out(x: torch.Tensor) -> torch.Tensor:
    """flax's cast back to float32 at a head's output: a bfloat16 result
    becomes float32; float32 and float64 (the backward checks) stay as they are."""
    return x.float() if x.dtype.itemsize < 4 else x


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        reset_layer_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        reset_layer_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def reset_parameters(self) -> None:
        reset_layer_(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)
