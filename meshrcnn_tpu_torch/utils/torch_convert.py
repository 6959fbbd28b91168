"""torchvision weights for the port's backbones: the ``--backbone_path`` loader
(counterpart of meshrcnn_tpu/utils/torch_convert.py; reference:
shapenet_model.py:139-150 pretrained_ResNet50, pix3d_model.py:163-178
pretrained_MaskRcnn).

The port's modules keep torch's layouts, so a torchvision name maps straight
onto a port name and the tensor is copied as it is, with three exceptions
that follow the JAX package's conversion, so that one checkpoint gives the
same function in both packages:
  * ``layer{i}.{j}`` is ``layer{i}_{j}`` and ``downsample.0`` / ``.1`` are
    ``downsample_conv`` / ``downsample_bn``;
  * the box head's ``fc6`` reads channels-last RoI features here, so its
    input axis is permuted from (C, H, W) to (H, W, C);
  * the mask predictor's ``conv5_mask`` is spatially flipped: the JAX
    conversion keeps torchvision's kernel, which flax's ``ConvTranspose``
    applies flipped relative to ``nn.ConvTranspose2d``.
A head whose size differs from the model's (an ImageNet or COCO classifier,
a 7x7 COCO box head against the 12x12 pool) keeps its fresh initialisation,
as the reference swaps it; any other shape mismatch raises.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch import nn

_STAGES = (3, 4, 6, 3)


def _resnet_names(src: str, dst: str) -> Iterator[Tuple[str, str]]:
    """(torchvision name, port name) of every ResNet-50 tensor but the fc head
    (BatchNorm's ``num_batches_tracked`` counts updates and is not a weight)."""
    bn = ("weight", "bias", "running_mean", "running_var")
    yield f"{src}conv1.weight", f"{dst}conv1.weight"
    for k in bn:
        yield f"{src}bn1.{k}", f"{dst}bn1.{k}"
    for i, blocks in enumerate(_STAGES, start=1):
        for j in range(blocks):
            s, d = f"{src}layer{i}.{j}.", f"{dst}layer{i}_{j}."
            for c in (1, 2, 3):
                yield f"{s}conv{c}.weight", f"{d}conv{c}.weight"
                for k in bn:
                    yield f"{s}bn{c}.{k}", f"{d}bn{c}.{k}"
            yield f"{s}downsample.0.weight", f"{d}downsample_conv.weight"
            for k in bn:
                yield f"{s}downsample.1.{k}", f"{d}downsample_bn.{k}"


def _maskrcnn_names() -> Iterator[Tuple[str, str]]:
    yield from _resnet_names("backbone.body.", "backbone.backbone.")
    for i in range(4):
        for k in ("weight", "bias"):
            yield f"backbone.fpn.inner_blocks.{i}.{k}", f"backbone.backbone.lateral{i + 2}.{k}"
            yield f"backbone.fpn.layer_blocks.{i}.{k}", f"backbone.backbone.out{i + 2}.{k}"
    for name in ("conv", "cls_logits", "bbox_pred"):
        for k in ("weight", "bias"):
            yield f"rpn.head.{name}.{k}", f"backbone.rpn_head.{name}.{k}"
    heads = ["box_head.fc6", "box_head.fc7", "box_predictor.cls_score",
             "box_predictor.bbox_pred"] + [f"mask_head.mask_fcn{i}" for i in range(1, 5)]
    for name in heads:
        for k in ("weight", "bias"):
            yield f"roi_heads.{name}.{k}", f"backbone.roi_heads.{name}.{k}"
    for name in ("conv5_mask", "mask_fcn_logits"):
        for k in ("weight", "bias"):
            yield (f"roi_heads.mask_predictor.{name}.{k}",
                   f"backbone.roi_heads.mask_head.{name}.{k}")


# the heads that keep their fresh initialisation, every tensor of the head,
# when any of its tensors has another size
_HEADS = ("backbone.fc.", "backbone.roi_heads.box_head.", "backbone.roi_heads.box_predictor.",
          "backbone.roi_heads.mask_head.mask_fcn_logits.")


def _fc6_channels_last(w: torch.Tensor, channels: int) -> torch.Tensor:
    side = int(round((w.shape[1] // channels) ** 0.5))
    return w.reshape(w.shape[0], channels, side, side).permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def convert_state_dict(state_dict: Dict[str, torch.Tensor], maskrcnn: bool
                       ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-50 (``maskrcnn=False``) or ``maskrcnn_resnet50_fpn``
    state dict -> {port name: tensor} for a ``ShapeNetModel`` / ``Pix3DModel``."""
    names = _maskrcnn_names() if maskrcnn else _resnet_names("", "backbone.")
    out = {dst: state_dict[src] for src, dst in names if src in state_dict}
    if not maskrcnn:
        for k in ("weight", "bias"):
            if f"fc.{k}" in state_dict:
                out[f"backbone.fc.{k}"] = state_dict[f"fc.{k}"]
        return out
    fc6 = "backbone.roi_heads.box_head.fc6.weight"
    if fc6 in out:
        channels = state_dict.get("roi_heads.mask_head.mask_fcn1.weight",
                                  torch.empty(0, 256)).shape[1]
        out[fc6] = _fc6_channels_last(out[fc6], channels)
    conv5 = "backbone.roi_heads.mask_head.conv5_mask.weight"
    if conv5 in out:
        out[conv5] = out[conv5].flip(2, 3)
    return out


def load_backbone(model: nn.Module, path: str, maskrcnn: bool) -> Tuple[int, int]:
    """Load the backbone weights of ``path`` into ``model``: a torchvision
    ResNet-50 state dict for a ShapeNetModel, a ``maskrcnn_resnet50_fpn`` one
    for a Pix3DModel (``maskrcnn``), or a checkpoint of
    ``utils/checkpoint.save_state``, whose ``backbone.*`` entries are taken.
    Names the model lacks are ignored; a head of ``_HEADS`` with a tensor of
    another size keeps its fresh initialisation, and any other shape mismatch
    raises. Returns (tensors loaded, tensors left fresh)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and "settings" in sd:
        src = {k: v for k, v in sd["model"].items() if k.startswith("backbone.")}
    else:
        src = convert_state_dict(sd, maskrcnn)
    target = model.state_dict()
    common = [k for k in src if k in target]
    swapped = {h for h in _HEADS for k in common
               if k.startswith(h) and src[k].shape != target[k].shape}
    loaded = {}
    for name in common:
        if name.startswith(tuple(swapped)):
            continue
        if src[name].shape != target[name].shape:
            raise ValueError(f"shape mismatch for {name}: {tuple(target[name].shape)} "
                             f"vs {tuple(src[name].shape)}")
        loaded[name] = src[name].to(target[name].dtype)
    model.load_state_dict(loaded, strict=False)
    return len(loaded), len(common) - len(loaded)
