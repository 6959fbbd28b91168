"""flax's initial weights for the port's layers.

The JAX package's modules take flax's default initialisers, but for one
parameter pair:
  * ``nn.Dense``, ``nn.Conv`` and ``nn.ConvTranspose`` kernels are
    ``lecun_normal``: ``variance_scaling(1, "fan_in", "truncated_normal")``,
    a normal truncated at +-2 standard deviations whose scale is divided by
    the truncated normal's own standard deviation, so the kernel's variance
    is 1 / fan_in; their biases are 0;
  * BatchNorm scales are 1 and its biases 0 (torch's defaults too);
  * the exception: GraphConv's ``w0`` / ``w1`` are U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (``meshrcnn_tpu/models/layers.py::_fan_in_uniform``).

The fan is that of the flax kernel layout: [in, out] for a dense kernel and
[kh, kw, in, out] for a conv and a transposed conv, so fan_in = in * kh * kw
for both (torch's own rule reads dim 1 of a ``ConvTranspose2d`` weight
[in, out, kh, kw], which is out).

Every layer of the port (``models/cast.py``'s ``Conv2d``, ``Linear`` and
``ConvTranspose2d``, and ``FanInLinear`` for GraphConv) draws its own weights
as it is built, from torch's global generator, so ``torch.manual_seed(s)``
before a constructor gives the same model on every rank. A caller that wants
its own stream wraps the constructor in ``torch.random.fork_rng()`` with a
``manual_seed``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# standard deviation of a unit normal truncated to [-2, 2] (flax's constant)
TRUNCATED_STD = 0.87962566103423978


def flax_fan_in(layer: nn.Module) -> int:
    """The fan_in of ``layer``'s weight in the flax kernel layout."""
    w = layer.weight
    if isinstance(layer, nn.Linear):
        return w.shape[1]
    if isinstance(layer, nn.ConvTranspose2d):      # [in, out / groups, kh, kw]
        return w.shape[0] * w.shape[2] * w.shape[3]
    if isinstance(layer, nn.Conv2d):               # [out, in / groups, kh, kw]
        return w.shape[1] * w.shape[2] * w.shape[3]
    raise TypeError(f"no flax fan for {type(layer).__name__}")


def _draw_into(t: torch.Tensor, fill) -> None:
    """Fill ``t`` in place with ``fill(buffer)``, drawn in float32 on the CPU
    (so a layer built on the card gets the same weights) and copied over."""
    buf = torch.empty(t.shape, dtype=torch.float32)
    fill(buf)
    with torch.no_grad():
        t.copy_(buf)


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at +-2 sigma, sigma =
    sqrt(1 / fan_in) / ``TRUNCATED_STD``; drawn by the inverse CDF, as
    ``jax.random.truncated_normal`` and ``nn.init.trunc_normal_`` draw it."""
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))

    def fill(buf):
        buf.uniform_(2.0 * cdf - 1.0, 1.0 - 2.0 * cdf)
        buf.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    _draw_into(weight, fill)
    return weight


def fan_in_uniform_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), GraphConv's ``w0`` / ``w1``."""
    bound = 1.0 / math.sqrt(fan_in)
    _draw_into(weight, lambda buf: buf.uniform_(-bound, bound))
    return weight


def reset_layer_(layer: nn.Module) -> None:
    """A dense, conv or transposed-conv layer as flax initialises it:
    ``lecun_normal`` weight, zero bias."""
    lecun_normal_(layer.weight, flax_fan_in(layer))
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


class FanInLinear(nn.Linear):
    """A no-bias linear map initialised U(+-1/sqrt(in_features)): GraphConv's
    ``w0`` and ``w1`` (reference: meshRCNN/layers.py:42-45)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features, bias=False)

    def reset_parameters(self) -> None:
        fan_in_uniform_(self.weight, self.in_features)

