"""Configuration dataclasses (counterpart of meshrcnn_tpu/core/config.py).

The port keeps its own copies of the ShapeNet and Pix3D models', the losses'
and the train loop's settings. One field is the port's own: ``TrainConfig.face_normals``
selects the normal estimator, which the JAX package reads from the environment
(``MESHRCNN_FACE_NORMALS``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class LossWeights:
    """Weighted loss sum keys (reference: utils/train_utils.py:208-225)."""
    chamfer: float = 1.0
    voxel: float = 1.0
    normal: float = 0.1
    edge: float = 0.5
    backbone: float = 1.0


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
class Pix3DConfig:
    """Pix3D model hyperparameters (reference: pix3d_model.py:22-28)."""
    num_classes: int = 10
    cubify_threshold: float = 0.2
    vertex_feature_dim: int = 128
    num_refinement_stages: int = 3
    voxel_only: bool = False
    num_voxels: int = 24
    detections_per_img: int = 3
    capacities: CapacityConfig = dataclasses.field(default_factory=CapacityConfig)


@dataclasses.dataclass
class TrainConfig:
    """Optimizer / schedule / loop config (reference: train.py:56-74)."""
    optimizer: str = "adam"           # 'adam' | 'sgd'
    lr: float = 1e-4
    weight_decay: float = 5e-6
    batch_size: int = 16
    epochs: int = 10
    train_backbone: bool = False
    point_cloud_size: int = 10000
    normal_k: int = 10
    distance_tile: int = 2048
    loss_weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    # Pix3D LR schedule (reference: utils/train_utils.py:161-168): linear warmup
    # 0.002 -> 0.02 over the first 1k steps, /10 at 8k and again at 10k
    pix3d_schedule: bool = False
    grad_clip: float = 0.0            # global-norm clip; 0 disables
    # keep params, optimizer state and BN statistics when the loss or any
    # gradient is non-finite, reporting it as the grads_finite metric
    skip_nonfinite: bool = True
    # compute zero-weight loss terms anyway, to report them
    report_unweighted_losses: bool = False
    seed: int = 0
    # normals of the normal loss: the sampled triangles' own (True) or the
    # reference's kNN + PCA estimate from each cloud (False)
    face_normals: bool = True
