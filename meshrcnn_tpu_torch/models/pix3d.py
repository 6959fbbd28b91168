"""The Pix3D Mesh R-CNN model, eval mode: Mask R-CNN -> RoI features -> voxel
branch -> cubify -> GCN refinement (counterpart of meshrcnn_tpu/models/pix3d.py;
reference: meshRCNN/pix3d_model.py:21-178).

``Pix3DMaskRCNN`` is the FPN trunk, the RPN and the RoI heads; ``Pix3DModel``
gives every detection slot (``detections_per_img`` an image) a voxel grid and a
mesh, as one fixed [B * D] batch whose ``mesh_valid`` masks the empty slots.
Images are NHWC [B, H, W, 3] at a fixed size.

``backbone_dtype`` is the detection stack's conv and matmul dtype (FPN, RPN,
box and mask heads); BatchNorm, box math and the voxel and mesh branches stay
float32, and the heads return float32 where flax casts back: RPN logits and
deltas, the box head's output, mask logits and the RoI features. The default
is the JAX package's, "bfloat16"; "float32" is the parity mode.

The JAX package also has a split eval (``make_split_eval_step`` with
``Pix3DRefineStages``): three programs instead of one, which works around a
TPU runtime fault when cubify and the refine stages share one program. A GPU
has no such fault, so only the single forward is ported. The training branch
(RPN and RoI losses, best-IoU RoI filtering) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn
from torch.profiler import record_function

from meshrcnn_tpu_torch.core.config import Pix3DConfig
from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.models import cast
from meshrcnn_tpu_torch.models.fpn import ResNetFPN
from meshrcnn_tpu_torch.models.layers import VertixRefinePix3D, VoxelBranch
from meshrcnn_tpu_torch.models.roi_heads import Detections, RoIHeads
from meshrcnn_tpu_torch.models.rpn import RPNHead, generate_anchors, select_proposals
from meshrcnn_tpu_torch.ops.cubify import CubifyOverflow, cubify
from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency


@dataclasses.dataclass
class Pix3DOutput:
    detections: Detections
    mask_probs: torch.Tensor          # [B, D, 28, 28]
    voxels: torch.Tensor              # [B*D, V, V, V]
    mesh: Optional[MeshBatch]         # None if voxel_only
    stage_verts: tuple[Any, ...]      # [B*D, Vmax, 3]: cubify + each refine stage
    mesh_valid: torch.Tensor          # [B*D] bool: which mesh slots are real
    overflow: Optional[CubifyOverflow]


class Pix3DMaskRCNN(nn.Module):
    """FPN + RPN + RoI heads: images -> (Detections, mask_probs)
    (reference: pix3d_model.py:120-178: 12x12 box pool with sampling ratio 1,
    3 detections an image, 10 classes)."""

    def __init__(self, num_classes: int = 10, detections_per_img: int = 3,
                 rpn_pre_nms_top_n: int = 1000, rpn_post_nms_top_n: int = 512,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        dtype = cast.compute_dtype(compute_dtype)
        self.rpn_pre_nms_top_n = rpn_pre_nms_top_n
        self.rpn_post_nms_top_n = rpn_post_nms_top_n
        self.backbone = ResNetFPN(dtype=dtype)
        self.rpn_head = RPNHead(dtype=dtype)
        self.roi_heads = RoIHeads(num_classes=num_classes,
                                  detections_per_img=detections_per_img, dtype=dtype)

    def forward(self, images: torch.Tensor):
        H, W = images.shape[1:3]
        with record_function("forward/fpn"):
            feats = self.backbone(images)
        with record_function("forward/rpn"):
            logits, deltas = self.rpn_head(feats)
            anchors = generate_anchors([f.shape[2:] for f in feats], (H, W), images.device)
            proposals, _, valid = select_proposals(logits, deltas, anchors, (H, W),
                                                   self.rpn_pre_nms_top_n,
                                                   self.rpn_post_nms_top_n)
        with record_function("forward/roi heads"):
            return self.roi_heads(feats, proposals, valid, (H, W))


class Pix3DModel(nn.Module):
    """reference: pix3d_model.py:21-117 (constructor defaults 22-28), eval mode.

    ``mesh_feature_norm`` divides each RoI map feeding the voxel and mesh
    branches by its RMS (the JAX package's from-scratch aid; off by default,
    as the reference has no such layer).
    """

    def __init__(self, num_classes: int = 10, cubify_threshold: float = 0.2,
                 voxel_out_channels: int = 24, vertex_feature_dim: int = 128,
                 num_refinement_stages: int = 3, voxel_only: bool = False,
                 detections_per_img: int = 3, vert_capacity: int = 4096,
                 face_capacity: int = 8192, edge_capacity: int = 16384,
                 rpn_pre_nms_top_n: int = 1000, rpn_post_nms_top_n: int = 512,
                 backbone_dtype: str = "bfloat16", mesh_feature_norm: bool = False):
        super().__init__()
        self.cubify_threshold = cubify_threshold
        self.voxel_only = voxel_only
        self.detections_per_img = detections_per_img
        self.vert_capacity = vert_capacity
        self.face_capacity = face_capacity
        self.edge_capacity = edge_capacity
        self.mesh_feature_norm = mesh_feature_norm
        self.num_refinement_stages = num_refinement_stages
        self.backbone = Pix3DMaskRCNN(num_classes, detections_per_img, rpn_pre_nms_top_n,
                                      rpn_post_nms_top_n, backbone_dtype)
        self.voxelBranch = VoxelBranch(256, voxel_out_channels)
        if not voxel_only:
            for i in range(num_refinement_stages):
                setattr(self, f"refine{i}", VertixRefinePix3D(use_input_features=i > 0,
                                                              num_features=vertex_feature_dim))

    @classmethod
    def from_config(cls, cfg: Pix3DConfig, **model_kwargs) -> "Pix3DModel":
        """The model of ``cfg``, its fields mapped as the JAX package's
        ``Pix3DAPI`` maps them; ``model_kwargs`` set the rest (RPN sizes, dtype)."""
        return cls(num_classes=cfg.num_classes, cubify_threshold=cfg.cubify_threshold,
                   vertex_feature_dim=cfg.vertex_feature_dim,
                   num_refinement_stages=cfg.num_refinement_stages, voxel_only=cfg.voxel_only,
                   detections_per_img=cfg.detections_per_img,
                   vert_capacity=cfg.capacities.verts, face_capacity=cfg.capacities.faces,
                   edge_capacity=cfg.capacities.edges, **model_kwargs)

    def forward(self, images: torch.Tensor) -> Pix3DOutput:
        """images [B, H, W, 3] NHWC -> Pix3DOutput (eval mode only)."""
        if self.training:
            raise NotImplementedError("the port runs Pix3DModel in eval mode only")
        B, H, W = images.shape[:3]
        D = self.detections_per_img
        detections, mask_probs = self.backbone(images)
        roi = detections.roi_features.reshape((B * D,) + detections.roi_features.shape[2:])
        mesh_valid = detections.valid.reshape(B * D)
        with record_function("forward/voxel head"):
            if self.mesh_feature_norm:
                roi = roi / torch.sqrt((roi * roi).mean(dim=(1, 2, 3), keepdim=True) + 1e-6)
            voxels = self.voxelBranch(roi)                   # [B*D, V, V, V]
        out = Pix3DOutput(detections=detections, mask_probs=mask_probs, voxels=voxels,
                          mesh=None, stage_verts=(), mesh_valid=mesh_valid, overflow=None)
        if self.voxel_only:
            return out

        with record_function("forward/cubify"):
            mesh, out.overflow = cubify(voxels, self.cubify_threshold,
                                        vert_capacity=self.vert_capacity,
                                        face_capacity=self.face_capacity,
                                        edge_capacity=self.edge_capacity)
            v = mesh_valid[:, None]
            out.mesh = dataclasses.replace(mesh, verts_mask=mesh.verts_mask & v,
                                           faces_mask=mesh.faces_mask & v,
                                           edges_mask=mesh.edges_mask & v)
            topo = precompute_adjacency(out.mesh.edges, out.mesh.edges_mask,
                                        self.vert_capacity)
        with record_function("forward/refine"):
            stage_verts = [out.mesh.verts]
            verts, feats = self.refine0(roi, out.mesh.verts, topo, (H, W))
            stage_verts.append(verts)
            for i in range(1, self.num_refinement_stages):
                verts, feats = getattr(self, f"refine{i}")(roi, verts, topo, (H, W),
                                                           vert_feats=feats)
                stage_verts.append(verts)
        out.stage_verts = tuple(stage_verts)
        return out
