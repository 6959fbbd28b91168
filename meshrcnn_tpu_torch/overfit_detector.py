"""Can the Pix3D eval stack detect at all? (counterpart of the JAX package's
tools/overfit_detector.py)

    python -m meshrcnn_tpu_torch.overfit_detector [--steps 2000] [--eval_every 250]

Overfits the detector on a small synthetic Pix3D split with Adam and asks
whether the eval path (RPN proposals -> box head -> score filter -> NMS ->
valid slots) then finds the objects: if it does, held-out AP is a question of
the training budget; if not, the eval path has a bug. The set is
``SyntheticDataset(train_n + test_n, img_size, 32^3 grids, 10 classes)``, its
first ``--train_n`` samples trained and the rest held out, collated in
batches of ``--batch`` to 24^3 grids with capacities 2048/4096/8192. The
model is ``Pix3DModel(10 classes, cubify threshold 0.2, 3 stages)``, its
detection stack in bfloat16 on the card (float32 on the CPU), its flax
initialisation drawn from torch's global generator at seed 0; the training is ``--optim`` (Adam) at
``--lr`` without weight decay, everything trained, grad clip 1.0, no Pix3D
schedule, 2000-point clouds, loss weights voxel 3, chamfer 1, normal 0.1,
edge 0.5. The train steps draw from a generator seeded 1.

After the first step and every ``--eval_every`` steps it prints the JAX
tool's line: the step, its loss, and on the train and the held-out batches
``detection_metrics``' AP_box, AP_mask, mean best IoU and valid fraction.
Runs on the card unless ``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from meshrcnn_tpu_torch.core.config import (CapacityConfig, LossWeights, TrainConfig,
                                            resolve_backbone_dtype)
from meshrcnn_tpu_torch.data.datasets import SyntheticDataset, collate
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.ops.boxes import box_iou
from meshrcnn_tpu_torch.ops.matcher import first_argmax
from meshrcnn_tpu_torch.ops.sampling import uniform_from
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_eval_step, make_train_step)
from meshrcnn_tpu_torch.utils.cli import device_of
from meshrcnn_tpu_torch.utils.metrics import paste_masks

parser = argparse.ArgumentParser("detector overfit check")
parser.add_argument("--steps", type=int, default=2000)
parser.add_argument("--eval_every", type=int, default=250)
parser.add_argument("--train_n", type=int, default=24)
parser.add_argument("--test_n", type=int, default=8)
parser.add_argument("--batch", type=int, default=4)
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--optim", default="adam")
parser.add_argument("--img_size", type=int, default=224)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")

CAPS = CapacityConfig(verts=2048, faces=4096, edges=8192)


@torch.no_grad()
def detection_metrics(eval_step, batches) -> dict:
    """AP_box / AP_mask and two diagnostics over ``batches`` (``Batch``es
    with images, boxes [B, 1, 4] and masks [B, H, W]): each image's best
    detection is its valid slot of the highest IoU with the GT box (slot 0
    if none is valid); AP_box is the share of images whose best detection is
    valid with IoU > 0.5, AP_mask that of images whose best detection's mask,
    pasted into the image, has IoU > 0.5 with the GT mask; ``mean_best_iou``
    is the best valid detection's IoU (0 if none) averaged over images and
    ``any_valid_frac`` the share of images with a valid detection."""
    ap_box = ap_mask = iou_sum = valid_frac = 0.0
    n = 0
    for b in batches:
        out = eval_step(b.images)
        det = out.detections
        B = det.valid.shape[0]
        ious = box_iou(b.boxes.reshape(B, 1, 4), det.boxes)[:, 0]       # [B, D]
        best = first_argmax(torch.where(det.valid, ious, -1.0))
        ar = torch.arange(B, device=ious.device)
        best_valid = det.valid[ar, best]
        iou = torch.where(best_valid, ious[ar, best], 0.0)
        ap_box += float((iou > 0.5).float().mean()) * B
        iou_sum += float(iou.sum())
        valid_frac += float(det.valid.any(1).sum())
        H, W = b.masks.shape[1], b.masks.shape[2]
        pm = paste_masks(out.mask_probs[ar, best], det.boxes[ar, best], H, W) > 0
        gt_m = b.masks > 0.5
        inter = (pm & gt_m).sum((1, 2)).float()
        union = (pm | gt_m).sum((1, 2)).clamp(min=1).float()
        miou = torch.where(best_valid, inter / union, 0.0)
        ap_mask += float((miou > 0.5).float().mean()) * B
        n += B
    return {"ap_box": ap_box / n, "ap_mask": ap_mask / n,
            "mean_best_iou": iou_sum / n, "any_valid_frac": valid_frac / n}


def main(argv=None) -> list:
    """Run the check of the flags in ``argv``; returns the printed rows, each
    {"step", "loss", "train": detection_metrics, "test": detection_metrics}."""
    args = parser.parse_args(argv)
    device = device_of(args.device)
    ds = SyntheticDataset(n=args.train_n + args.test_n, image_size=args.img_size,
                          num_voxels=32, num_classes=10, pix3d=True)
    idx = list(range(len(ds)))

    def batches_of(indices):
        return [Batch.from_host(collate([ds[j] for j in indices[i:i + args.batch]], 24, CAPS,
                                        image_size=args.img_size), device)
                for i in range(0, len(indices) - args.batch + 1, args.batch)]

    train_batches = batches_of(idx[:args.train_n])
    test_batches = batches_of(idx[args.train_n:])
    print(f"{len(train_batches)} train batches, {len(test_batches)} test batches")

    config = TrainConfig(optimizer=args.optim, lr=args.lr, weight_decay=0.0,
                         batch_size=args.batch, point_cloud_size=2000,
                         train_backbone=True, grad_clip=1.0, pix3d_schedule=False,
                         loss_weights=LossWeights(voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5))
    torch.manual_seed(config.seed)
    model = Pix3DModel(num_classes=10, cubify_threshold=0.2, vert_capacity=CAPS.verts,
                       face_capacity=CAPS.faces, edge_capacity=CAPS.edges,
                       num_refinement_stages=3,
                       backbone_dtype=resolve_backbone_dtype("auto", device)).to(device)
    generator = torch.Generator(device=device).manual_seed(1)
    state = create_train_state(model, config, generator)
    step = make_train_step(config, uniform_from(generator))
    eval_step = make_eval_step(model)

    rows = []
    t0 = time.time()
    for i in range(args.steps):
        metrics = step(state, train_batches[i % len(train_batches)])
        if (i + 1) % args.eval_every == 0 or i == 0:
            tr = detection_metrics(eval_step, train_batches)
            te = detection_metrics(eval_step, test_batches)
            loss = float(metrics["loss"])
            print(f"step {i + 1:5d} loss {loss:.3f} "
                  f"| train AP_box {tr['ap_box']:.2f} AP_mask {tr['ap_mask']:.2f} "
                  f"iou {tr['mean_best_iou']:.3f} valid {tr['any_valid_frac']:.2f} "
                  f"| test AP_box {te['ap_box']:.2f} AP_mask {te['ap_mask']:.2f} "
                  f"iou {te['mean_best_iou']:.3f} valid {te['any_valid_frac']:.2f} "
                  f"| {time.time() - t0:.0f}s", flush=True)
            rows.append({"step": i + 1, "loss": loss, "train": tr, "test": te})
    return rows


if __name__ == "__main__":
    main()
