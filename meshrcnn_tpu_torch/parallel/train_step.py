"""Train and eval steps of the ShapeNet and Pix3D models (counterpart of
meshrcnn_tpu/parallel/train_step.py, single device; data parallelism is a
later slice).

The JAX step is a pure function of (params, batch_stats, opt_state); here the
model and optimizer are updated in place, and the mapping is:
  * ``optax.chain(clip_by_global_norm, add_decayed_weights, adam|sgd)`` is a
    global-norm clip of the gradients, then ``torch.optim.Adam`` / ``SGD`` with
    ``weight_decay``: L2 added to the gradient (not AdamW), SGD without momentum;
  * the frozen backbone (``multi_transform`` with ``set_to_zero``) keeps its
    parameters out of the optimizer; they still get gradients, which the
    non-finite check reads, as JAX's ``tree_leaves(grads)`` does;
  * the Pix3D schedule is a ``LambdaLR`` of the same function of the step;
  * a non-finite loss or gradient skips ``optimizer.step()`` and restores the
    BatchNorm buffers, which the forward has already updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F
from torch.profiler import record_function

from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel, Pix3DOutput
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel, ShapeNetOutput
from meshrcnn_tpu_torch.ops.losses import batched_mesh_loss, voxel_loss
from meshrcnn_tpu_torch.ops.sampling import Uniform


@dataclasses.dataclass
class Batch:
    """One training batch on the device (the fields of the JAX ``Batch`` the
    port reads; ``boxes`` and ``masks`` are Pix3D's, None for ShapeNet)."""
    images: torch.Tensor          # [B, H, W, 3]
    voxels: torch.Tensor          # [B, Z, Y, X] {0,1}
    gt_verts: torch.Tensor        # [B, Vg, 3]
    gt_faces: torch.Tensor        # [B, Fg, 3]
    gt_faces_mask: torch.Tensor   # [B, Fg]
    labels: torch.Tensor          # [B] (Pix3D: 1-based classes)
    boxes: Optional[torch.Tensor] = None   # [B, 1, 4] xyxy GT box
    masks: Optional[torch.Tensor] = None   # [B, H, W] binary GT mask

    @classmethod
    def from_host(cls, batch, device) -> "Batch":
        """Copy the fields that a batch object of numpy arrays has to ``device``."""
        fields = {f.name: getattr(batch, f.name, None) for f in dataclasses.fields(cls)}
        return cls(**{k: torch.from_numpy(np.array(v)).to(device)
                      for k, v in fields.items() if v is not None})


@dataclasses.dataclass
class TrainState:
    """What a train step updates and a checkpoint holds: the model, the
    optimizer and its schedule, the step count and the generator of the
    step's uniform draws."""
    model: ShapeNetModel | Pix3DModel
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    step: int = 0
    generator: Optional[torch.Generator] = None


def pix3d_lr(step: int) -> float:
    """reference: utils/train_utils.py:161-168 (``make_optimizer:46-49``)."""
    warm = 0.002 + (0.02 - 0.002) * min(step / 1000.0, 1.0)
    decay = 0.01 if step >= 10000 else 0.1 if step >= 8000 else 1.0
    return warm * decay


def trainable_parameters(model: torch.nn.Module, config: TrainConfig) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates: all, or all but the backbone's."""
    return [p for name, p in model.named_parameters()
            if config.train_backbone or not name.startswith("backbone.")]


def make_optimizer(config: TrainConfig, model: torch.nn.Module):
    """(optimizer, scheduler or None): Adam|SGD with weight decay, an optionally
    frozen backbone and the Pix3D schedule (reference: train.py:146-175)."""
    params = trainable_parameters(model, config)
    lr = 1.0 if config.pix3d_schedule else config.lr
    name = config.optimizer.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=config.weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, weight_decay=config.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {config.optimizer}")
    sched = (torch.optim.lr_scheduler.LambdaLR(opt, pix3d_lr)
             if config.pix3d_schedule else None)
    return opt, sched


def create_train_state(model: ShapeNetModel | Pix3DModel, config: TrainConfig,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    opt, sched = make_optimizer(config, model)
    return TrainState(model=model, optimizer=opt, scheduler=sched, generator=generator)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / |g| * max_norm when |g| >= max_norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _weighted_mesh_total(total, w: LossWeights, chamfer, normal, edge):
    """Add the weighted mesh terms, dropping zero weights from the graph:
    ``0 * term`` would still send a NaN of the term's backward into every
    gradient (0 x NaN = NaN)."""
    if w.chamfer:
        total = total + w.chamfer * chamfer
    if w.normal:
        total = total + w.normal * normal
    if w.edge:
        total = total + w.edge * edge
    return total


def shapenet_loss_fn(model: ShapeNetModel, config: TrainConfig, batch: Batch,
                     uniform: Uniform):
    """Forward + weighted loss sum -> (total, metrics) (reference:
    utils/train_utils.py:208-225). A zero normal weight elides the normal term
    (it reads 0) unless ``report_unweighted_losses``."""
    out: ShapeNetOutput = model(batch.images)
    w = config.loss_weights
    with record_function("losses/voxel"):
        v_loss = voxel_loss(out.voxels, batch.voxels)
    metrics = {"voxel_loss": v_loss}
    total = w.voxel * v_loss
    if config.train_backbone:
        b_loss = F.cross_entropy(out.logits, batch.labels.long())
        metrics["backbone_loss"] = b_loss
        total = total + w.backbone * b_loss
    return _mesh_terms(model, config, out, batch, uniform, total, metrics)


def _mesh_terms(model, config: TrainConfig, out, batch: Batch, uniform: Uniform, total,
                metrics: dict):
    """Add the weighted mesh losses and the overflow count, unless the model is
    voxel-only; returns (total, detached metrics) with ``loss`` the total."""
    w = config.loss_weights
    if not model.voxel_only:
        with record_function("losses/mesh"):
            chamfer, normal, edge = batched_mesh_loss(
                list(out.stage_verts[1:]), out.mesh, batch.gt_verts, batch.gt_faces,
                batch.gt_faces_mask, uniform, point_cloud_size=config.point_cloud_size,
                compute_normal=bool(w.normal) or config.report_unweighted_losses,
                num_neighbours=config.normal_k, tile=config.distance_tile,
                face_normals=config.face_normals)
        metrics.update(chamfer_loss=chamfer, normal_loss=normal, edge_loss=edge)
        total = _weighted_mesh_total(total, w, chamfer, normal, edge)
        ovf = out.overflow
        metrics["overflow"] = (ovf.verts + ovf.faces + ovf.edges).sum().float()
    metrics["loss"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


def pix3d_loss_fn(model: Pix3DModel, config: TrainConfig, batch: Batch, uniform: Uniform):
    """Forward in train mode + weighted loss sum -> (total, metrics) (reference:
    utils/train_utils.py:208-225). Each Mask R-CNN loss is a metric of its own
    name; their sum is ``backbone_loss``, weighted by ``backbone``. The
    samplers draw first, then the mesh losses (``Pix3DModel``'s order)."""
    out: Pix3DOutput = model(batch.images, batch.boxes, batch.labels, batch.masks, uniform)
    w = config.loss_weights
    with record_function("losses/voxel"):
        v_loss = voxel_loss(out.voxels, batch.voxels)
    metrics = {"voxel_loss": v_loss}
    total = w.voxel * v_loss
    backbone_total = 0.0
    for name, val in out.backbone_losses.items():
        metrics[name] = val
        backbone_total = backbone_total + val
    metrics["backbone_loss"] = backbone_total
    total = total + w.backbone * backbone_total
    return _mesh_terms(model, config, out, batch, uniform, total, metrics)


def _all_finite(total: torch.Tensor, grads: List[torch.Tensor]) -> bool:
    flags = [torch.isfinite(total)] + [torch.isfinite(g).all() for g in grads]
    return bool(torch.stack(flags).all())


def _update(state: TrainState, config: TrainConfig) -> None:
    """Clip, then one optimizer and schedule step over the trainable parameters."""
    trainable = trainable_parameters(state.model, config)
    for p in trainable:       # JAX's gradient of an unused parameter is 0
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if config.grad_clip and config.grad_clip > 0:
        clip_by_global_norm([p.grad for p in trainable], config.grad_clip)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()


def make_train_step(config: TrainConfig, uniform: Uniform
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """The train step: forward in train mode (BatchNorm on batch statistics),
    loss (``shapenet_loss_fn`` or, for a ``Pix3DModel``, ``pix3d_loss_fn``),
    backward, then the optimizer, unless the loss or any gradient is
    non-finite (``skip_nonfinite``: params, optimizer state, schedule and BN
    buffers stay as they were, and ``grads_finite`` reads 0).

    Sampling draws its uniforms from ``uniform``. Convolutions and matmuls run
    in full float32 (TF32 off, process-wide PyTorch flags). ``step`` counts
    every call, skipped or not, as the JAX state's does.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.train()
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if config.skip_nonfinite:
            buffers = [(b, b.clone()) for b in model.buffers()]
        loss_fn = pix3d_loss_fn if isinstance(model, Pix3DModel) else shapenet_loss_fn
        total, metrics = loss_fn(model, config, batch, uniform)
        with record_function("train/backward"):
            total.backward()
        ok = True
        if config.skip_nonfinite:
            with record_function("train/finite check"):
                ok = _all_finite(total, [p.grad for p in params if p.grad is not None])
            metrics["grads_finite"] = torch.tensor(float(ok), device=total.device)
        if ok:
            with record_function("train/optimizer"):
                _update(state, config)
        else:
            for buf, saved in buffers:
                buf.copy_(saved)
        state.step += 1
        return metrics

    return step


def make_eval_step(model: torch.nn.Module) -> Callable[[torch.Tensor], Any]:
    """The eval forward of a ShapeNetModel or a Pix3DModel: NHWC images in,
    BatchNorm on running statistics, no autograd graph.

    float32 layers run in full float32: TF32, which keeps about three decimal
    digits and which cuDNN convolutions use by default, is switched off for
    matmuls and convolutions alike (process-wide PyTorch flags). A bfloat16
    backbone computes in bfloat16 regardless.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step(images: torch.Tensor) -> ShapeNetOutput:
        model.eval()
        with torch.no_grad():
            return model(images)
    return step
