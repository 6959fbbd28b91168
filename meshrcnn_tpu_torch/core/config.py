"""Configuration dataclasses the eval path reads (counterpart of meshrcnn_tpu/core/config.py).

The port keeps its own copies; only the fields this slice uses are carried.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CapacityConfig:
    """Static per-sample capacities for padded mesh buffers."""
    verts: int = 8192
    faces: int = 16384
    edges: int = 32768
    gt_verts: int = 4096
    gt_faces: int = 8192


@dataclasses.dataclass
class ShapeNetConfig:
    """ShapeNet model hyperparameters (reference: shapenet_model.py:18-24)."""
    num_classes: int = 13
    residual: bool = False
    cubify_threshold: float = 0.2
    vertex_feature_dim: int = 128
    num_refinement_stages: int = 3
    voxel_only: bool = False
    num_voxels: int = 48
    image_size: int = 137
    capacities: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)


@dataclasses.dataclass
class TrainConfig:
    """The loop settings eval reads: cloud size, normal k and distance tile."""
    point_cloud_size: int = 10000
    normal_k: int = 10
    distance_tile: int = 2048
