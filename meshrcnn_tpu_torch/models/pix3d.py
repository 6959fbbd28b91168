"""The Pix3D Mesh R-CNN model: Mask R-CNN -> RoI features -> voxel branch ->
cubify -> GCN refinement (counterpart of meshrcnn_tpu/models/pix3d.py;
reference: meshRCNN/pix3d_model.py:21-178).

``Pix3DMaskRCNN`` is the FPN trunk, the RPN and the RoI heads. ``Pix3DModel``
runs in two modes, as the reference's forward does:
  * train (``model.train()``, GT boxes, labels and masks given): the RPN and
    RoI-head losses, then the RoI feature of each image's detection that
    overlaps its GT box best (``filter_roi_input``) drives the voxel and mesh
    branches, one mesh an image;
  * eval: every detection slot (``detections_per_img`` an image) gets a voxel
    grid and a mesh, as one fixed [B * D] batch whose ``mesh_valid`` masks the
    empty slots.
Images are NHWC [B, H, W, 3] at a fixed size.

``backbone_dtype`` is the detection stack's conv and matmul dtype (FPN, RPN,
box and mask heads); BatchNorm, box math, the losses and the voxel and mesh
branches stay float32, and the heads return float32 where flax casts back: RPN
logits and deltas, the box head's output, mask logits and the RoI features.
The default is the JAX package's, "bfloat16"; "float32" is the parity mode.

Training draws its uniforms from a ``Uniform`` source in the JAX program's
order of keys: the RPN sampler's two [B, N] draws (N anchors), the RoI
sampler's two [B, R + G], then the mask loss's [B, roi_batch_size].

The JAX package also has a split eval (``make_split_eval_step`` with
``Pix3DRefineStages``): three programs instead of one, which works around a
TPU runtime fault when cubify and the refine stages share one program. A GPU
has no such fault, so only the single forward is ported.
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
from meshrcnn_tpu_torch.models.rpn import RPNHead, generate_anchors, rpn_loss, select_proposals
from meshrcnn_tpu_torch.ops.boxes import box_iou
from meshrcnn_tpu_torch.ops.cubify import CubifyOverflow, cubify
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows
from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency
from meshrcnn_tpu_torch.ops.matcher import first_argmax
from meshrcnn_tpu_torch.ops.sampling import Uniform


@dataclasses.dataclass
class Pix3DOutput:
    detections: Detections
    mask_probs: Optional[torch.Tensor]  # [B, D, 28, 28] in eval, None in training
    backbone_losses: dict             # the RPN and RoI-head losses in training, else {}
    voxels: torch.Tensor              # [N, V, V, V]; N = B (train) or B*D (eval)
    mesh: Optional[MeshBatch]         # None if voxel_only
    stage_verts: tuple[Any, ...]      # [N, Vmax, 3]: cubify + each refine stage
    mesh_valid: torch.Tensor          # [N] bool: which mesh slots are real
    overflow: Optional[CubifyOverflow]


class Pix3DMaskRCNN(nn.Module):
    """FPN + RPN + RoI heads: images -> (Detections, losses, mask_probs)
    (reference: pix3d_model.py:120-178: 12x12 box pool with sampling ratio 1,
    3 detections an image, 10 classes). Trains in ``self.training``."""

    def __init__(self, num_classes: int = 10, detections_per_img: int = 3,
                 rpn_pre_nms_top_n: int = 1000, rpn_post_nms_top_n: int = 512,
                 roi_batch_size: int = 512, mask_rois: int = 64,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        dtype = cast.compute_dtype(compute_dtype)
        self.rpn_pre_nms_top_n = rpn_pre_nms_top_n
        self.rpn_post_nms_top_n = rpn_post_nms_top_n
        self.backbone = ResNetFPN(dtype=dtype)
        self.rpn_head = RPNHead(dtype=dtype)
        self.roi_heads = RoIHeads(num_classes=num_classes, detections_per_img=detections_per_img,
                                  batch_size_per_image=roi_batch_size, mask_rois=mask_rois,
                                  dtype=dtype)

    def forward(self, images: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None, uniform: Optional[Uniform] = None):
        H, W = images.shape[1:3]
        with record_function("forward/fpn"):
            feats = self.backbone(images)
        with record_function("forward/rpn"):
            logits, deltas = self.rpn_head(feats)
            anchors = generate_anchors([f.shape[2:] for f in feats], (H, W), images.device)
            proposals, _, valid = select_proposals(logits, deltas, anchors, (H, W),
                                                   self.rpn_pre_nms_top_n,
                                                   self.rpn_post_nms_top_n)
        losses = {}
        if self.training:
            with record_function("losses/rpn"):
                losses["loss_objectness"], losses["loss_rpn_box_reg"] = rpn_loss(
                    uniform, logits, deltas, anchors, gt_boxes)
        with record_function("forward/roi heads"):
            detections, head_losses, mask_probs = self.roi_heads(
                feats, proposals, valid, (H, W), train=self.training, gt_boxes=gt_boxes,
                gt_labels=gt_labels, gt_masks=gt_masks, uniform=uniform)
        losses.update(head_losses)
        return detections, losses, mask_probs


def filter_roi_input(gt_boxes: torch.Tensor, detections: Detections) -> torch.Tensor:
    """The RoI feature of each image's valid detection that overlaps its GT box
    best, slot 0 when none is valid (reference: meshRCNN/utils.py:112-123):
    gt_boxes [B, 1, 4] -> [B, pool, pool, C]."""
    iou = torch.where(detections.valid, box_iou(gt_boxes, detections.boxes)[:, 0], -1.0)
    return batched_gather_rows(detections.roi_features, first_argmax(iou)[:, None])[:, 0]


class Pix3DModel(nn.Module):
    """reference: pix3d_model.py:21-117 (constructor defaults 22-28).

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
                 roi_batch_size: int = 512, mask_rois: int = 64,
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
                                      rpn_post_nms_top_n, roi_batch_size, mask_rois,
                                      backbone_dtype)
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

    def forward(self, images: torch.Tensor, gt_boxes: Optional[torch.Tensor] = None,
                gt_labels: Optional[torch.Tensor] = None,
                gt_masks: Optional[torch.Tensor] = None,
                uniform: Optional[Uniform] = None) -> Pix3DOutput:
        """images [B, H, W, 3] NHWC -> Pix3DOutput. In training also gt_boxes
        [B, 1, 4], gt_labels [B] (1-based), gt_masks [B, H, W] and the
        ``uniform`` source of the samplers."""
        B, H, W = images.shape[:3]
        detections, losses, mask_probs = self.backbone(images, gt_boxes, gt_labels, gt_masks,
                                                       uniform)
        if self.training:
            roi = filter_roi_input(gt_boxes, detections)     # [B, pool, pool, C]
            mesh_valid = torch.ones(B, dtype=torch.bool, device=images.device)
        else:
            D = self.detections_per_img
            roi = detections.roi_features.reshape((B * D,) + detections.roi_features.shape[2:])
            mesh_valid = detections.valid.reshape(B * D)
        with record_function("forward/voxel head"):
            if self.mesh_feature_norm:
                roi = roi / torch.sqrt((roi * roi).mean(dim=(1, 2, 3), keepdim=True) + 1e-6)
            voxels = self.voxelBranch(roi)                   # [N, V, V, V]
        out = Pix3DOutput(detections=detections, mask_probs=mask_probs, backbone_losses=losses,
                          voxels=voxels, mesh=None, stage_verts=(), mesh_valid=mesh_valid,
                          overflow=None)
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
