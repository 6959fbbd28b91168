"""Graph convolution, vertex refinement cells and the voxel head
(counterpart of meshrcnn_tpu/models/layers.py; reference: meshRCNN/layers.py:25-339, 487-506).

Features are [B, Vmax, C] blocks; neighbour sums go through
``ops/graph_conv.aggregate_neighbours``. Module names follow the flax scopes
so ``utils/jax_params.py`` maps parameters by path. Initial weights are flax's
(``models/init.py``): GraphConv's ``w0`` / ``w1`` U(+-1/sqrt(fan_in)), every
other kernel ``lecun_normal`` with zero biases.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from meshrcnn_tpu_torch.models.cast import Conv2d, ConvTranspose2d, Linear
from meshrcnn_tpu_torch.models.init import FanInLinear
from meshrcnn_tpu_torch.ops.graph_conv import EdgeTopology, aggregate_neighbours
from meshrcnn_tpu_torch.ops.vert_align import vert_align
from meshrcnn_tpu_torch.utils.shapes import conv_output, convT_output

# The level-wise projection in the ShapeNet cells: ResNet-50's C2..C5 widths.
RESNET_LEVELS = (256, 512, 1024, 2048)


class GraphConv(nn.Module):
    """f'_i = ReLU(W0 f_i + sum_{j in N(i)} W1 f_j)  (reference: layers.py:25-68)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.w0 = FanInLinear(in_features, out_features)
        self.w1 = FanInLinear(in_features, out_features)

    def forward(self, feats: torch.Tensor, topo: EdgeTopology) -> torch.Tensor:
        return torch.relu(self.w0(feats) + aggregate_neighbours(self.w1(feats), topo))


class ResGraphConv(nn.Module):
    """Two GraphConvs plus a linear skip when widths differ (reference: layers.py:71-100)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.projection = (Linear(in_features, out_features, bias=False)
                           if in_features != out_features else None)
        self.conv0 = GraphConv(in_features, out_features)
        self.conv1 = GraphConv(out_features, out_features)

    def forward(self, feats: torch.Tensor, topo: EdgeTopology) -> torch.Tensor:
        skip = feats if self.projection is None else self.projection(feats)
        return skip + self.conv1(self.conv0(feats, topo), topo)


class _LevelProjector(Linear):
    """One [F, sum(C_l)] no-bias weight applied level-wise to a feature-map list.

    Because bilinear sampling is linear, projecting each map by its slice of
    the weight and summing the aligned results equals the reference's
    Linear(vert_align(maps, concat)) (project-then-align).
    """

    def __init__(self, levels: Sequence[int], features: int):
        super().__init__(sum(levels), features, bias=False)
        self.levels = tuple(levels)

    def forward(self, feature_maps: Sequence[torch.Tensor]):
        outs, off = [], 0
        for fm, c in zip(feature_maps, self.levels):
            outs.append(fm @ self.weight[:, off:off + c].T)
            off += c
        return outs


def _project_align(projector: _LevelProjector, feature_maps, verts, image_size):
    return vert_align(projector(feature_maps), verts, image_size, combine="sum")


class ResVertixRefineShapenet(nn.Module):
    """Residual ShapeNet refinement cell (reference: layers.py:103-178).

    VertAlign -> Linear(alignment -> F) -> concat[feats?, pos, projected]
    -> 3 ResGraphConv -> GraphConv(-> 3) -> tanh -> additive position update.
    """

    def __init__(self, use_input_features: bool = True, num_features: int = 128,
                 ndims: int = 3, levels: Sequence[int] = RESNET_LEVELS):
        super().__init__()
        self.use_input_features = use_input_features
        in_f = ndims + num_features + (num_features if use_input_features else 0)
        self.linear = _LevelProjector(levels, num_features)
        self.resGraphConv0 = ResGraphConv(in_f, num_features)
        self.resGraphConv1 = ResGraphConv(num_features, num_features)
        self.resGraphConv2 = ResGraphConv(num_features, num_features)
        self.graphConv = GraphConv(num_features, ndims)

    def forward(self, feature_maps, verts, topo, image_size,
                vert_feats: Optional[torch.Tensor] = None):
        if (vert_feats is not None) != self.use_input_features:
            raise ValueError("vert_feats must be given exactly when use_input_features")
        parts = [verts, _project_align(self.linear, feature_maps, verts, image_size)]
        if vert_feats is not None:
            parts = [vert_feats] + parts
        feats = torch.cat(parts, dim=-1)
        feats = self.resGraphConv0(feats, topo)
        feats = self.resGraphConv1(feats, topo)
        feats = self.resGraphConv2(feats, topo)
        return verts + torch.tanh(self.graphConv(feats, topo)), feats


class VertixRefineShapeNet(nn.Module):
    """Non-residual ShapeNet refinement cell (reference: layers.py:181-259).

    Positions are re-concatenated before convs 1 and 2; the position offset is
    Linear(F -> 3) + tanh.
    """

    def __init__(self, use_input_features: bool = True, num_features: int = 128,
                 ndims: int = 3, levels: Sequence[int] = RESNET_LEVELS):
        super().__init__()
        self.use_input_features = use_input_features
        in_f = ndims + num_features + (num_features if use_input_features else 0)
        self.linear0 = _LevelProjector(levels, num_features)
        self.graphConv0 = GraphConv(in_f, num_features)
        self.graphConv1 = GraphConv(num_features + ndims, num_features)
        self.graphConv2 = GraphConv(num_features + ndims, num_features)
        self.linear1 = Linear(num_features, ndims, bias=False)

    def forward(self, feature_maps, verts, topo, image_size,
                vert_feats: Optional[torch.Tensor] = None):
        if (vert_feats is not None) != self.use_input_features:
            raise ValueError("vert_feats must be given exactly when use_input_features")
        parts = [verts, _project_align(self.linear0, feature_maps, verts, image_size)]
        if vert_feats is not None:
            parts = [vert_feats] + parts
        feats = self.graphConv0(torch.cat(parts, dim=-1), topo)
        feats = self.graphConv1(torch.cat([verts, feats], dim=-1), topo)
        feats = self.graphConv2(torch.cat([verts, feats], dim=-1), topo)
        return verts + torch.tanh(self.linear1(feats)), feats


class VertixRefinePix3D(nn.Module):
    """Pix3D refinement cell (reference: layers.py:262-339): vert-align on one
    RoI feature map (channels-last [N, p, p, alignment_size]), then the
    non-residual cell's three GraphConvs, and the offset Linear(F + 3 -> 3)
    of concat[pos, feats] + tanh."""

    def __init__(self, use_input_features: bool = True, num_features: int = 128,
                 ndims: int = 3, alignment_size: int = 256):
        super().__init__()
        self.use_input_features = use_input_features
        in_f = ndims + alignment_size + (num_features if use_input_features else 0)
        self.graphConv0 = GraphConv(in_f, num_features)
        self.graphConv1 = GraphConv(num_features + ndims, num_features)
        self.graphConv2 = GraphConv(num_features + ndims, num_features)
        self.linear = Linear(num_features + ndims, ndims, bias=False)

    def forward(self, roi_features, verts, topo, image_size,
                vert_feats: Optional[torch.Tensor] = None):
        if (vert_feats is not None) != self.use_input_features:
            raise ValueError("vert_feats must be given exactly when use_input_features")
        parts = [verts, vert_align([roi_features], verts, image_size)]
        if vert_feats is not None:
            parts = [vert_feats] + parts
        feats = self.graphConv0(torch.cat(parts, dim=-1), topo)
        feats = self.graphConv1(torch.cat([verts, feats], dim=-1), topo)
        feats = self.graphConv2(torch.cat([verts, feats], dim=-1), topo)
        return verts + torch.tanh(self.linear(torch.cat([verts, feats], dim=-1))), feats


class VoxelBranch(nn.Module):
    """Occupancy head (reference: layers.py:487-506): Conv3x3 -> Conv3x3 ->
    ConvTranspose(x2) -> Conv1x1 -> soft clamp -> sigmoid, with no activations
    between, as the reference.

    Takes NHWC [B, h, w, C_in] and returns [B, out, 2h, 2w]: the output
    channel axis is the grid's depth, so this is the [B, z, y, x] grid.
    """

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int = 256):
        super().__init__()
        self.conv0 = Conv2d(in_channels, hidden_channels, 3, padding=1)
        self.conv1 = Conv2d(hidden_channels, hidden_channels, 3, padding=1)
        self.deconv = ConvTranspose2d(hidden_channels, hidden_channels, 2, stride=2)
        self.conv2 = Conv2d(hidden_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = self.conv1(self.conv0(x.permute(0, 3, 1, 2)))
        assert tuple(x.shape[2:]) == conv_output(
            *conv_output(h, w, kernel=3, padding=1), kernel=3, padding=1)
        x = self.deconv(x)
        assert tuple(x.shape[2:]) == convT_output(h, w, kernel=2, stride=2)
        return torch.sigmoid(_soft_clamp_logits(self.conv2(x)))


def _soft_clamp_logits(x: torch.Tensor, a: float = 8.0, b: float = 15.0) -> torch.Tensor:
    """Identity for |x| <= a; rational easing a + (b-a) t/(1+t) toward +-b beyond,
    t = (|x|-a)/(b-a). Keeps the sigmoid off exact 0/1 so BCE gradients survive."""
    ax = x.abs()
    t = (ax - a).clamp(min=0.0) / (b - a)
    eased = a + (b - a) * t / (1.0 + t)
    return torch.where(ax <= a, x, torch.sign(x) * eased)
