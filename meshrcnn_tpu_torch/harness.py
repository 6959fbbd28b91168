"""Training and validation loops
(counterpart of meshrcnn_tpu/harness.py; reference: utils/train_utils.py:174-250,
utils/eval_utils.py:93-194).

``train_epoch`` runs one train step per batch, ShapeNet or Pix3D (the
Pix3D step sends its three stage chamfers through K1). ``validate`` runs, per
batch, the ShapeNet eval forward, then ``shapenet_eval_metrics``: voxel BCE and
IoU, class predictions, per-stage chamfer / normal / edge losses, and
point-cloud F1@tau. Each eval batch sends four cloud pairs through K1: three
stage chamfers and the F1 distances; with ``face_normals=False`` it also sends
both clouds of each stage through K3 for their kNN + PCA normals (six launches).
``validate_pix3d`` does the same for the Pix3D model through
``pix3d_eval_metrics`` (best-IoU detection, AP_box / AP_mask, ranked AP), five
K1 launches a batch with ranked AP: the four above plus one for the mesh F1 of
every detection slot.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from meshrcnn_tpu_torch.core.config import CapacityConfig, LossWeights, Pix3DConfig, TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel, Pix3DOutput
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel, ShapeNetOutput
from meshrcnn_tpu_torch.ops.boxes import box_iou
from meshrcnn_tpu_torch.ops.chamfer_cuda import nn_bidir
from meshrcnn_tpu_torch.ops.losses import batched_mesh_loss, voxel_loss
from meshrcnn_tpu_torch.ops.sampling import Uniform, batched_sample_points
from meshrcnn_tpu_torch.parallel.train_step import Batch, TrainState
from meshrcnn_tpu_torch.utils.meters import AverageMeter, ProgressMeter, gcn_metrics
from meshrcnn_tpu_torch.utils.metrics import (detection_map, f_score, mesh_precision_recall,
                                              paste_masks)


class SyntheticBatch:
    """One numpy batch at the bench recipe's shapes (bench.py:124-134)."""

    def __init__(self, rng, B=3, H=137, grid=48, gt_v=2048, gt_f=4096, num_classes=13):
        self.images = rng.rand(B, H, H, 3).astype(np.float32)
        self.voxels = (rng.rand(B, grid, grid, grid) > 0.7).astype(np.float32)
        self.gt_verts = (rng.randn(B, gt_v, 3) * 0.4).astype(np.float32)
        self.gt_faces = rng.randint(0, gt_v, (B, gt_f, 3)).astype(np.int32)
        self.gt_faces_mask = np.ones((B, gt_f), dtype=bool)
        self.labels = rng.randint(0, num_classes, (B,)).astype(np.int32)


class SyntheticPix3DBatch:
    """One numpy batch at the Pix3D bench recipe's shapes (bench.py:165-203):
    224x224 images, 24^3 voxels, one box [40, 50, 190, 180] and its mask an
    image, 2048 / 4096 ground-truth verts / faces, classes 1..9."""

    def __init__(self, rng, B=4, H=224, grid=24, gt_v=2048, gt_f=4096, num_classes=10):
        self.images = rng.rand(B, H, H, 3).astype(np.float32)
        self.voxels = (rng.rand(B, grid, grid, grid) > 0.7).astype(np.float32)
        self.gt_verts = (rng.randn(B, gt_v, 3) * 0.4).astype(np.float32)
        self.gt_faces = rng.randint(0, gt_v, (B, gt_f, 3)).astype(np.int32)
        self.gt_faces_mask = np.ones((B, gt_f), dtype=bool)
        self.labels = rng.randint(1, num_classes, (B,)).astype(np.int32)
        self.boxes = np.tile(np.array([[40.0, 50.0, 190.0, 180.0]], np.float32), (B, 1, 1))
        self.masks = np.zeros((B, H, H), np.float32)
        self.masks[:, 40:180, 50:190] = 1.0


def pix3d_train_setup(batches: int, device: torch.device | str = "cuda", seed: int = 0,
                      **overrides):
    """(model in train mode, config, numpy batches) of the full-width Pix3D recipe
    (bench.py:165-203): Mask R-CNN with a bfloat16 detection stack at 224x224,
    10 classes, 3 detections an image, RPN 1000 / 512, 512 sampled RoIs and 64
    mask RoIs an image, 24^3 voxels, capacities 4096/8192/16384, 10k-point
    clouds, B=4, random weights and data from ``seed``; SGD at lr 0.02 under
    the Pix3D schedule (0.002 at step 0), weight decay 1e-4, the backbone
    trained, weights voxel 3 / chamfer 1 / normal 0.1 / edge 0.5.
    ``overrides`` replace fields of the config."""
    torch.manual_seed(seed)
    model = Pix3DModel.from_config(Pix3DConfig(
        capacities=CapacityConfig(verts=4096, faces=8192, edges=16384))).to(device)
    config = TrainConfig(optimizer="sgd", lr=0.02, weight_decay=1e-4, batch_size=4,
                         point_cloud_size=10000, normal_k=10, distance_tile=2048,
                         train_backbone=True, pix3d_schedule=True,
                         loss_weights=LossWeights(voxel=3.0, chamfer=1.0, normal=0.1,
                                                  edge=0.5))
    config = dataclasses.replace(config, **overrides)
    rng = np.random.RandomState(seed)
    return model.train(), config, [SyntheticPix3DBatch(rng) for _ in range(batches)]


def pix3d_bench_setup(batches: int, device: torch.device | str = "cuda", seed: int = 0,
                      **overrides):
    """``pix3d_train_setup``'s recipe with the model in eval mode, for
    ``validate_pix3d``, which reads the config's point_cloud_size, normal_k,
    distance_tile and face_normals."""
    model, config, data = pix3d_train_setup(batches, device, seed, **overrides)
    return model.eval(), config, data


def _bench_model(device) -> ShapeNetModel:
    return ShapeNetModel(num_classes=13, residual=True, cubify_threshold=0.2,
                         voxel_out_channels=48, vertex_feature_dim=128,
                         num_refinement_stages=3, vert_capacity=8192,
                         face_capacity=16384, edge_capacity=32768).to(device)


def shapenet_train_setup(batches: int, device: torch.device | str = "cuda", seed: int = 0,
                         **overrides):
    """(model, config, numpy batches) of the full-width bench recipe
    (bench.py:103-137): ResNet-50 at 137x137, residual refinement, 48^3 voxels,
    capacities 8192/16384/32768, 10k-point clouds, B=3, random weights and data
    from ``seed``; Adam at lr 1e-4 without weight decay, a frozen backbone,
    loss weights voxel 1, chamfer 1, normal 0, edge 0.5. ``overrides`` replace
    fields of the config (``loss_weights``, ``face_normals``, ...)."""
    torch.manual_seed(seed)
    model = _bench_model(device)
    config = TrainConfig(optimizer="adam", lr=1e-4, weight_decay=0.0, batch_size=3,
                         point_cloud_size=10000, normal_k=10, distance_tile=2048,
                         train_backbone=False,
                         loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0,
                                                  edge=0.5))
    config = dataclasses.replace(config, **overrides)
    rng = np.random.RandomState(seed)
    return model, config, [SyntheticBatch(rng) for _ in range(batches)]


def shapenet_bench_setup(batches: int, device: torch.device | str = "cuda", seed: int = 0,
                         **overrides):
    """``shapenet_train_setup``'s recipe with the model in eval mode, for
    ``validate``, which reads the config's point_cloud_size, normal_k,
    distance_tile and face_normals."""
    model, config, data = shapenet_train_setup(batches, device, seed, **overrides)
    return model.eval(), config, data


def _timed_iter(loader, meter: AverageMeter):
    """Iterate ``loader`` booking only the ``next()`` wall time to ``meter``."""
    it = iter(loader)
    while True:
        t0 = time.time()
        try:
            batch = next(it)
        except StopIteration:
            return
        meter.update(time.time() - t0)
        yield batch


def _book_step_time(meters: Dict[str, AverageMeter], dt: float) -> None:
    """The first step is warmup (kernel build, allocator growth), booked apart."""
    if "warmup_time" not in meters:
        meters["warmup_time"] = AverageMeter("warmup_time")
        meters["warmup_time"].update(dt)
        return
    meters["batch_time"].update(dt)


def train_epoch(epoch: int, step_fn: Callable[[TrainState, Batch], Dict[str, torch.Tensor]],
                state: TrainState, loader: Iterable, meters: Dict[str, AverageMeter],
                device: torch.device | str = "cuda", print_freq: int = 10):
    """One training epoch over numpy batches, one train step each (counterpart
    of ``harness.train_epoch`` without its multi-step dispatch; reference:
    train_utils.py:174-250). A Pix3D batch carries ``boxes`` and ``masks``,
    which ``Batch.from_host`` copies. Every metric of the step goes to a meter of its
    name; the first step of a run is booked as ``warmup_time``; every
    ``print_freq`` steps ``ProgressMeter`` prints the meters given. Returns
    (state, meters) after ``epoch_end`` on every meter."""
    progress = ProgressMeter(len(loader), meters.values(), prefix=f"Epoch: [{epoch}]")
    end = time.time()
    for i, batch in enumerate(_timed_iter(loader, meters["data_loading"])):
        metrics = step_fn(state, Batch.from_host(batch, device))
        values = torch.stack(list(metrics.values())).tolist()     # one copy to the host
        for k, v in zip(metrics, values):
            if k not in meters:
                meters[k] = AverageMeter(k, ":.4f")
            meters[k].update(v)
        _book_step_time(meters, time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            progress.display(i)
    for m in meters.values():
        m.epoch_end()
    return state, meters


def _voxel_iou(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Occupancy IoU of thresholded predictions against {0,1} targets."""
    p = pred > threshold
    t = gt > 0.5
    inter = (p & t).sum()
    union = (p | t).sum().clamp(min=1)
    return inter.float() / union.float()


def _f1_distances(verts, faces, faces_mask, gt_verts, gt_faces, gt_faces_mask,
                  point_cloud_size: int, uniform: Uniform):
    """Sampled-cloud squared NN distances both ways, through K1."""
    cloud_p, valid_p = batched_sample_points(verts, faces, faces_mask,
                                             point_cloud_size, uniform)
    cloud_g, valid_g = batched_sample_points(gt_verts, gt_faces, gt_faces_mask,
                                             point_cloud_size, uniform)
    d_p, _, d_g, _ = nn_bidir(cloud_p, cloud_g)
    return d_p, d_g, valid_p & valid_g


def _f1_per_sample(verts, faces, faces_mask, gt_verts, gt_faces, gt_faces_mask,
                   point_cloud_size: int, uniform: Uniform, taus: Sequence[float]):
    """Per-sample point-cloud F1 at each tau: ([B, T] f1, [B] valid)."""
    d_p, d_g, valid = _f1_distances(verts, faces, faces_mask, gt_verts, gt_faces,
                                    gt_faces_mask, point_cloud_size, uniform)
    f1s = []
    for tau in taus:
        thr = tau * tau
        prec = (d_p < thr).float().mean(1)
        rec = (d_g < thr).float().mean(1)
        f1s.append(2 * prec * rec / (prec + rec).clamp(min=1e-12))
    return torch.stack(f1s, dim=1), valid


def _f1_terms(verts, faces, faces_mask, gt_verts, gt_faces, gt_faces_mask,
              point_cloud_size: int, uniform: Uniform, taus: Sequence[float]):
    """Per-tau (sum of per-sample F1 [T], valid count)."""
    f1, valid = _f1_per_sample(verts, faces, faces_mask, gt_verts, gt_faces,
                               gt_faces_mask, point_cloud_size, uniform, taus)
    return torch.where(valid[:, None], f1, 0.0).sum(0), valid.sum()


def shapenet_eval_metrics(out: ShapeNetOutput, gt_vox, gt_verts, gt_faces,
                          gt_faces_mask, point_cloud_size: int, uniform: Uniform,
                          taus: Sequence[float] = (0.1, 0.3),
                          voxel_only: bool = False, normal_k: int = 10,
                          tile: int = 2048, face_normals: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """All per-batch eval metrics (counterpart of ``_shapenet_eval_metrics``).

    Draws: three refinement stages of (predicted, ground-truth) clouds, then the
    F1 pair, three uniforms per cloud, all from ``uniform`` in that order.
    ``face_normals=False`` scores normals estimated by kNN + PCA.
    """
    with record_function("metrics/voxel"):
        res = {"voxel_loss": voxel_loss(out.voxels, gt_vox),
               "voxel_iou": _voxel_iou(out.voxels, gt_vox),
               "preds": out.logits.argmax(-1)}
    if not voxel_only:
        with record_function("metrics/mesh losses"):
            chamfer, normal, edge = batched_mesh_loss(
                list(out.stage_verts[1:]), out.mesh, gt_verts, gt_faces, gt_faces_mask,
                uniform, point_cloud_size=point_cloud_size, num_neighbours=normal_k,
                tile=tile, face_normals=face_normals)
        res.update(chamfer_loss=chamfer, normal_loss=normal, edge_loss=edge)
        with record_function("metrics/F1"):
            res["f1_sum"], res["f1_count"] = _f1_terms(
                out.stage_verts[-1], out.mesh.faces, out.mesh.faces_mask, gt_verts,
                gt_faces, gt_faces_mask, point_cloud_size, uniform, taus)
    return res


def validate(eval_step: Callable[[torch.Tensor], ShapeNetOutput], loader: Iterable,
             config: TrainConfig, num_classes: int, uniform: Uniform,
             device: torch.device | str = "cuda", voxel_only: bool = False,
             f1_taus: Sequence[float] = (0.1, 0.3), print_freq: int = 10) -> dict:
    """Dataset evaluation over numpy batches (counterpart of ``harness.validate``).

    A batch has ``images`` [B,H,W,3], ``voxels``, ``gt_verts``, ``gt_faces``,
    ``gt_faces_mask`` and ``labels``. Returns the voxel/chamfer/normal/edge
    losses, ``voxel_iou``, the confusion-based ``f0_1``/``f0_3``/``f0_5``,
    point-cloud ``F1@tau`` and the ``confusion`` matrix, plus timing meters.
    The normal metric uses ``config.face_normals``, ``normal_k`` and
    ``distance_tile``.
    """
    meters = gcn_metrics(voxel_only)
    meters["voxel_iou"] = AverageMeter("voxel_iou")
    confusion = np.zeros((num_classes, num_classes), dtype=np.int64)
    taus = tuple(f1_taus)
    f1_sums = {t: 0.0 for t in taus}
    f1_count = 0
    end = time.time()

    def dev(x):
        return torch.from_numpy(np.array(x)).to(device)

    for i, batch in enumerate(_timed_iter(loader, meters["data_loading"])):
        out = eval_step(dev(batch.images))
        m = shapenet_eval_metrics(out, dev(batch.voxels), dev(batch.gt_verts),
                                  dev(batch.gt_faces), dev(batch.gt_faces_mask),
                                  config.point_cloud_size, uniform, taus, voxel_only,
                                  config.normal_k, config.distance_tile,
                                  config.face_normals)
        with record_function("metrics/to host"):
            m = {k: v.cpu().numpy() for k, v in m.items()}
        meters["voxel_loss"].update(m["voxel_loss"])
        meters["voxel_iou"].update(m["voxel_iou"])
        for p, t in zip(m["preds"], np.asarray(batch.labels)):
            confusion[int(t), int(p)] += 1
        if not voxel_only:
            for k in ("chamfer_loss", "normal_loss", "edge_loss"):
                meters[k].update(m[k])
            for j, tau in enumerate(taus):
                f1_sums[tau] += float(m["f1_sum"][j])
            f1_count += int(m["f1_count"])
        _book_step_time(meters, time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            print(f"eval [{i}/{len(loader)}] voxel {meters['voxel_loss'].avg:.4f}")

    results = {k: m.avg for k, m in meters.items()}
    for beta, name in ((0.1, "f0_1"), (0.3, "f0_3"), (0.5, "f0_5")):
        results[name] = float(np.nanmean(f_score(confusion, beta=beta)))
    for tau in taus:
        results[f"F1@{tau}"] = f1_sums[tau] / max(f1_count, 1)
    results["confusion"] = confusion
    return results


def pix3d_eval_metrics(out: Pix3DOutput, gt_boxes, gt_masks, gt_vox, gt_verts, gt_faces,
                       gt_faces_mask, point_cloud_size: int, uniform: Uniform,
                       taus: Sequence[float] = (0.1, 0.3), voxel_only: bool = False,
                       normal_k: int = 10, tile: int = 2048, face_normals: bool = True,
                       ranked: bool = False) -> Dict[str, torch.Tensor]:
    """Pix3D per-batch eval metrics (counterpart of ``_pix3d_eval_metrics``;
    reference: eval_utils.py:10-130).

    Each image's best-IoU valid detection against its GT box (slot 0 when none
    is valid) gives AP_box and AP_mask (precision@1 at IoU 0.5, the reference's
    quantities), its class, its voxel loss and IoU, and its mesh's per-stage
    losses and F1. ``ranked=True`` adds the per-slot records of score-ranked
    AP: scores, labels, validity, box IoU, pasted-mask IoU and, with meshes,
    the mesh F1@0.3 of every one of the B * D slots against its image's GT.

    Draws, all from ``uniform``, in the JAX program's order: three stages of
    (predicted, ground-truth) clouds of ``batched_mesh_loss``, the F1 pair,
    then with ``ranked`` the B * D slots' pair; three uniforms per cloud.
    """
    det = out.detections
    B, D = det.valid.shape
    H, W = gt_masks.shape[1], gt_masks.shape[2]
    gt_b = gt_boxes.reshape(B, 1, 4)
    ar = torch.arange(B, device=gt_boxes.device)
    with record_function("metrics/detection"):
        ious = torch.where(det.valid, box_iou(det.boxes, gt_b)[..., 0], -1.0)
        best = ious.argmax(1)
        best_boxes = det.boxes[ar, best]
        res = {"best_labels": det.labels[ar, best]}
        raw_iou = box_iou(gt_b, best_boxes[:, None])[:, 0, 0]
        res["ap_box"] = (raw_iou > 0.5).float().mean()
        gt_m = gt_masks > 0.5
        pm = paste_masks(out.mask_probs[ar, best], best_boxes, H, W) > 0
        inter = (pm & gt_m).sum((1, 2)).float()
        union = (pm | gt_m).sum((1, 2)).clamp(min=1).float()
        res["ap_mask"] = ((inter / union) > 0.5).float().mean()
        if ranked:
            res.update(det_scores=det.scores, det_labels=det.labels, det_valid=det.valid,
                       det_box_iou=ious)
            pa = paste_masks(out.mask_probs, det.boxes, H, W) > 0        # [B, D, H, W]
            inter_a = (pa & gt_m[:, None]).sum((2, 3)).float()
            union_a = (pa | gt_m[:, None]).sum((2, 3)).clamp(min=1).float()
            res["det_mask_iou"] = inter_a / union_a

    slot = ar * D + best
    with record_function("metrics/voxel"):
        res["voxel_loss"] = voxel_loss(out.voxels[slot], gt_vox)
        res["voxel_iou"] = _voxel_iou(out.voxels[slot], gt_vox)
    if voxel_only:
        return res
    mesh = dataclasses.replace(out.mesh, **{f.name: getattr(out.mesh, f.name)[slot]
                                             for f in dataclasses.fields(out.mesh)})
    stage_verts = [v[slot] for v in out.stage_verts]
    with record_function("metrics/mesh losses"):
        chamfer, normal, edge = batched_mesh_loss(
            stage_verts[1:], mesh, gt_verts, gt_faces, gt_faces_mask, uniform,
            point_cloud_size=point_cloud_size, num_neighbours=normal_k, tile=tile,
            face_normals=face_normals)
    res.update(chamfer_loss=chamfer, normal_loss=normal, edge_loss=edge)
    with record_function("metrics/F1"):
        res["f1_sum"], res["f1_count"] = _f1_terms(
            stage_verts[-1], mesh.faces, mesh.faces_mask, gt_verts, gt_faces, gt_faces_mask,
            point_cloud_size, uniform, taus)
    if ranked:
        with record_function("metrics/slot F1"):
            def rep(x):
                return x.repeat_interleave(D, dim=0)
            f1, valid = _f1_per_sample(out.stage_verts[-1], out.mesh.faces,
                                       out.mesh.faces_mask, rep(gt_verts), rep(gt_faces),
                                       rep(gt_faces_mask), point_cloud_size, uniform, (0.3,))
            res["det_mesh_f1"] = torch.where(valid, f1[:, 0], 0.0).reshape(B, D)
    return res


def validate_pix3d(eval_step: Callable[[torch.Tensor], Pix3DOutput], loader: Iterable,
                   config: TrainConfig, num_classes: int, uniform: Uniform,
                   device: torch.device | str = "cuda", voxel_only: bool = False,
                   f1_taus: Sequence[float] = (0.1, 0.3), print_freq: int = 10,
                   ranked_ap: bool = True) -> dict:
    """Pix3D dataset evaluation over numpy batches (counterpart of
    ``harness.validate_pix3d``; reference: eval_utils.py:93-194).

    A batch has ``images``, ``boxes`` [B,1,4], ``masks`` [B,H,W], ``voxels``,
    ``gt_verts``, ``gt_faces``, ``gt_faces_mask`` and ``labels``. Returns
    AP_box / AP_mask (precision@1 of the best-IoU detection, the reference's
    names), voxel and mesh losses, ``voxel_iou``, the confusion f0_1 / f0_3 /
    f0_5, AP_mesh (AUC over the confusion), point-cloud F1@tau, the
    ``confusion`` matrix and timing meters; with ``ranked_ap`` also class-mean
    score-ranked AP50_box, AP50_mask and AP_mesh_ranked (mesh F1@0.3 > 0.5).
    """
    meters = gcn_metrics(voxel_only)
    meters["voxel_iou"] = AverageMeter("voxel_iou")
    for k in ("AP_box", "AP_mask"):
        meters[k] = AverageMeter(k)
    confusion = np.zeros((num_classes, num_classes), dtype=np.int64)
    taus = tuple(f1_taus)
    f1_sums = {t: 0.0 for t in taus}
    f1_count = 0
    records = {k: [] for k in ("scores", "labels", "image_ids", "box_iou", "mask_iou",
                               "mesh_f1")}
    gt_labels_by_image: Dict[int, int] = {}
    n_images = 0
    end = time.time()

    def dev(x):
        return torch.from_numpy(np.array(x)).to(device)

    for i, batch in enumerate(_timed_iter(loader, meters["data_loading"])):
        out = eval_step(dev(batch.images))
        m = pix3d_eval_metrics(out, dev(batch.boxes), dev(batch.masks), dev(batch.voxels),
                               dev(batch.gt_verts), dev(batch.gt_faces),
                               dev(batch.gt_faces_mask), config.point_cloud_size, uniform,
                               taus, voxel_only, config.normal_k, config.distance_tile,
                               config.face_normals, ranked_ap)
        with record_function("metrics/to host"):
            m = {k: v.cpu().numpy() for k, v in m.items()}
        labels = np.asarray(batch.labels)
        for k, name in (("ap_box", "AP_box"), ("ap_mask", "AP_mask"),
                        ("voxel_loss", "voxel_loss"), ("voxel_iou", "voxel_iou")):
            meters[name].update(m[k])
        for p, t in zip(m["best_labels"], labels):
            confusion[int(t), int(p)] += 1
        if ranked_ap:
            valid = m["det_valid"].astype(bool)
            Bn, Dn = valid.shape
            for b in range(Bn):
                gt_labels_by_image[n_images + b] = int(labels[b])
            ids = np.broadcast_to((n_images + np.arange(Bn))[:, None], (Bn, Dn))
            for k, arr in (("scores", m["det_scores"]), ("labels", m["det_labels"]),
                           ("image_ids", ids), ("box_iou", m["det_box_iou"]),
                           ("mask_iou", m["det_mask_iou"])):
                records[k].append(np.asarray(arr)[valid])
            if not voxel_only:
                records["mesh_f1"].append(m["det_mesh_f1"][valid])
        n_images += len(labels)
        if not voxel_only:
            for k in ("chamfer_loss", "normal_loss", "edge_loss"):
                meters[k].update(m[k])
            for j, tau in enumerate(taus):
                f1_sums[tau] += float(m["f1_sum"][j])
            f1_count += int(m["f1_count"])
        _book_step_time(meters, time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            print(f"pix3d eval [{i}/{len(loader)}] AP_box {meters['AP_box'].avg:.3f}")

    results = {k: m.avg for k, m in meters.items()}
    for beta, name in ((0.1, "f0_1"), (0.3, "f0_3"), (0.5, "f0_5")):
        results[name] = float(np.nanmean(f_score(confusion, beta=beta)))
    results["AP_mesh"] = mesh_precision_recall(confusion, f_score(confusion, 0.3))
    if ranked_ap and gt_labels_by_image:
        cat = {k: (np.concatenate(v) if v else np.zeros(0)) for k, v in records.items()}
        common = (cat["scores"], cat["labels"], cat["image_ids"])
        results["AP50_box"] = detection_map(*common, cat["box_iou"], gt_labels_by_image)["mAP"]
        results["AP50_mask"] = detection_map(*common, cat["mask_iou"],
                                             gt_labels_by_image)["mAP"]
        if not voxel_only:
            results["AP_mesh_ranked"] = detection_map(*common, cat["mesh_f1"],
                                                      gt_labels_by_image)["mAP"]
    for tau in taus:
        results[f"F1@{tau}"] = f1_sums[tau] / max(f1_count, 1)
    results["confusion"] = confusion
    return results
