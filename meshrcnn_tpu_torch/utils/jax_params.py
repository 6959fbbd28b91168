"""Flax parameter trees -> the port's ``state_dict``.

The inverse of the layout rules in meshrcnn_tpu/utils/torch_convert.py:
  flax conv kernel [kh, kw, I, O]   -> torch Conv2d weight [O, I, kh, kw]
  flax Dense kernel [I, O]          -> torch Linear weight [O, I]
  flax BN scale/bias + mean/var     -> weight/bias + running_mean/running_var
plus ConvTranspose: flax's ``ConvTranspose`` (no kernel transpose) applies its
kernel spatially flipped relative to torch's ``ConvTranspose2d``, so
[kh, kw, I, O] -> [I, O, kh, kw] with both spatial axes reversed. Which
kernels those are is read from the torch module (every ``nn.ConvTranspose2d``:
the voxel head's ``deconv``, the mask head's ``conv5_mask``), never from the
flax name. GraphConv's ``w0``/``w1`` are Dense kernels; ``_LevelProjector``'s
kernel is one too. ``fc6`` of the box head takes channels-last features, the
flax flatten order, so it maps as any Dense.

Inputs are nested dicts of numpy arrays (``flax.core.unfreeze`` + ``np.asarray``
of the trees); the torch module names follow the flax scopes, so a flax path
``a/b/c`` is the torch prefix ``a.b.c``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _leaf_params(prefix: str, node: Mapping, transposed: set, out: Dict) -> None:
    if "scale" in node:                                   # BatchNorm
        out[f"{prefix}.weight"] = node["scale"]
        out[f"{prefix}.bias"] = node["bias"]
        return
    for key in ("w0", "w1"):                              # GraphConv
        if key in node:
            out[f"{prefix}.{key}.weight"] = node[key].T
    if "kernel" in node:
        k = node["kernel"]
        if k.ndim == 2:                                   # Dense
            out[f"{prefix}.weight"] = k.T
        elif prefix in transposed:                        # ConvTranspose
            out[f"{prefix}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:                                             # Conv
            out[f"{prefix}.weight"] = k.transpose(3, 2, 0, 1)
        if "bias" in node:
            out[f"{prefix}.bias"] = node["bias"]


def _walk_params(prefix: str, node: Mapping, transposed: set, out: Dict) -> None:
    if any(not isinstance(v, Mapping) for v in node.values()):
        _leaf_params(prefix, node, transposed, out)
    for key, child in node.items():
        if isinstance(child, Mapping):
            _walk_params(f"{prefix}.{key}" if prefix else key, child, transposed, out)


def _walk_stats(prefix: str, node: Mapping, out: Dict) -> None:
    if "mean" in node and not isinstance(node["mean"], Mapping):
        out[f"{prefix}.running_mean"] = node["mean"]
        out[f"{prefix}.running_var"] = node["var"]
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        return
    for key, child in node.items():
        _walk_stats(f"{prefix}.{key}" if prefix else key, child, out)


def state_dict_from_jax(module: nn.Module, params: Mapping, batch_stats: Mapping
                        ) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict for the flax ``params`` and ``batch_stats`` trees
    of the flax module it ports (any whose torch names follow the flax scopes)."""
    transposed = {name for name, m in module.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    out: Dict = {}
    _walk_params("", params, transposed, out)
    _walk_stats("", batch_stats, out)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}

