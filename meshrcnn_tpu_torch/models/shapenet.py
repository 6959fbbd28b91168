"""The ShapeNet Mesh R-CNN model: ResNet-50 -> voxel branch -> cubify -> GCN refinement
(counterpart of meshrcnn_tpu/models/shapenet.py; reference: shapenet_model.py:17-101).

  backbone -> (logits, [c2..c5]) -> 4.8x align-corners bilinear upscale of c5
  -> VoxelBranch(2048 -> 48) -> [B,48,48,48] occupancy -> cubify(threshold)
  -> refine stage 0 (no input features) -> stages 1..n-1 (with features),
giving stage positions [cubify, s1, s2, s3].

``backbone_dtype`` is the ResNet-50's conv compute dtype (``models/cast.py``).
The JAX model defaults to "bfloat16"; the port defaults to "float32", its
parity mode, and takes "bfloat16" when asked. Everything after the backbone
is float32 either way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.profiler import record_function

from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.models import cast
from meshrcnn_tpu_torch.models.layers import (ResVertixRefineShapenet,
                                              VertixRefineShapeNet, VoxelBranch)
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.ops.cubify import CubifyOverflow, cubify
from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency
from meshrcnn_tpu_torch.utils.image import resize_bilinear_align_corners, scaled_size


@dataclasses.dataclass
class ShapeNetOutput:
    logits: torch.Tensor              # [B, num_classes]
    voxels: torch.Tensor              # [B, Z, Y, X] occupancy probabilities
    mesh: Optional[MeshBatch]         # cubify topology (None if voxel_only)
    stage_verts: tuple[Any, ...]      # [B, Vmax, 3]: cubify + each refine stage
    overflow: Optional[CubifyOverflow]


class ShapeNetModel(nn.Module):
    """reference: shapenet_model.py:17-101 (constructor defaults 18-24)."""

    def __init__(self, num_classes: int = 13, residual: bool = False,
                 cubify_threshold: float = 0.2, voxel_in_channels: int = 2048,
                 voxel_out_channels: int = 48, vertex_feature_dim: int = 128,
                 num_refinement_stages: int = 3, voxel_only: bool = False,
                 upscale_factor: float = 4.8, vert_capacity: int = 8192,
                 face_capacity: int = 16384, edge_capacity: int = 32768,
                 backbone_dtype: str = "float32"):
        super().__init__()
        self.cubify_threshold = cubify_threshold
        self.voxel_only = voxel_only
        self.upscale_factor = upscale_factor
        self.vert_capacity = vert_capacity
        self.face_capacity = face_capacity
        self.edge_capacity = edge_capacity
        self.backbone = ResNet50(num_classes=num_classes, dtype=cast.compute_dtype(backbone_dtype))
        self.voxelBranch = VoxelBranch(voxel_in_channels, voxel_out_channels)
        cell = ResVertixRefineShapenet if residual else VertixRefineShapeNet
        for i in range(num_refinement_stages):
            setattr(self, f"refine{i}", cell(use_input_features=i > 0,
                                             num_features=vertex_feature_dim))
        self.num_refinement_stages = num_refinement_stages

    def forward(self, images: torch.Tensor) -> ShapeNetOutput:
        """images [B, H, W, 3] NHWC -> ShapeNetOutput."""
        H, W = images.shape[1], images.shape[2]
        with record_function("forward/backbone"):
            logits, feature_maps = self.backbone(images)
        with record_function("forward/voxel head"):
            c5 = feature_maps[-1]
            out_hw = (scaled_size(c5.shape[1], self.upscale_factor),
                      scaled_size(c5.shape[2], self.upscale_factor))
            voxels = self.voxelBranch(resize_bilinear_align_corners(c5, out_hw))
        if self.voxel_only:
            return ShapeNetOutput(logits=logits, voxels=voxels, mesh=None,
                                  stage_verts=(), overflow=None)

        with record_function("forward/cubify"):
            mesh, overflow = cubify(voxels, self.cubify_threshold,
                                    vert_capacity=self.vert_capacity,
                                    face_capacity=self.face_capacity,
                                    edge_capacity=self.edge_capacity)
        with record_function("forward/adjacency"):
            topo = precompute_adjacency(mesh.edges, mesh.edges_mask, self.vert_capacity)
        with record_function("forward/refine"):
            stage_verts = [mesh.verts]
            verts, feats = self.refine0(feature_maps, mesh.verts, topo, (H, W))
            stage_verts.append(verts)
            for i in range(1, self.num_refinement_stages):
                verts, feats = getattr(self, f"refine{i}")(feature_maps, verts, topo,
                                                           (H, W), vert_feats=feats)
                stage_verts.append(verts)
        return ShapeNetOutput(logits=logits, voxels=voxels, mesh=mesh,
                              stage_verts=tuple(stage_verts), overflow=overflow)
