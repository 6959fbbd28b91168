"""Backbone-only training on a CUDA card (counterpart of the JAX package's
train_backbone.py; reference: train_backbone.py:16-45, utils/train_utils.py:110-171).

    python -m meshrcnn_tpu_torch.train_backbone --model ShapeNet [--dataRoot synthetic] ...
    python -m meshrcnn_tpu_torch.train_backbone --model Pix3D --device cpu ...

ShapeNet trains the ResNet-50 classifier with softmax cross-entropy (the
reference's nll-on-softmax is degenerate, SURVEY.md §6), float32, Adam or
SGD with L2 weight decay added to the gradient (``optax.chain(
add_decayed_weights, adam | sgd)``: ``torch.optim`` ``weight_decay``, SGD
without momentum); meters ``loss``, ``acc``, ``batch_time``. Pix3D trains the
Mask R-CNN alone (``Pix3DMaskRCNN``, bfloat16 detection stack, no mesh
branch) on the sum of its RPN and RoI-head losses, SGD with weight decay under
the Pix3D schedule (``parallel/train_step.pix3d_lr``); its samplers draw from
a generator on the device seeded 0; meters ``maskrcnn_metrics`` and ``loss``.

After each epoch it writes ``backbone_<epoch>.pt`` and ``stats_<epoch>.st``
into ``<checkpoint_root>/<model>/backbone/<date>/``. The checkpoint holds
``model``, the backbone's tensors under the names of a ``ShapeNetModel`` /
``Pix3DModel`` (``backbone.*``), and ``settings``, so that the train CLI's
``--backbone_path`` (``utils/torch_convert.load_backbone``) reads it. Runs on
the card unless ``--device cpu``; without a card it raises. The JAX CLI's
``--backbone_path`` (an orbax checkpoint of it) is not read here.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.nn import functional as F

from meshrcnn_tpu_torch.core.config import CapacityConfig, TrainConfig
from meshrcnn_tpu_torch.data.datasets import (SyntheticDataset, dataLoader, pix3dDataset,
                                              shapeNet_Dataset)
from meshrcnn_tpu_torch.models.pix3d import Pix3DMaskRCNN
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.ops.sampling import Uniform, uniform_from
from meshrcnn_tpu_torch.parallel.train_step import make_optimizer
from meshrcnn_tpu_torch.utils.checkpoint import checkpoint_dir
from meshrcnn_tpu_torch.utils.cli import device_of
from meshrcnn_tpu_torch.utils.meters import (AverageMeter, maskrcnn_metrics, safe_print,
                                             save_stats)

parser = argparse.ArgumentParser(description="backbone training script")
parser.add_argument("--model", "-m", choices=["ShapeNet", "Pix3D"], required=True)
parser.add_argument("--backbone_path", "-bp", type=str, default="")
parser.add_argument("-c", "--classes", type=str, default=None)
parser.add_argument("--num_sampels", type=int, default=None)
parser.add_argument("--train_ratio", type=float, default=None)
parser.add_argument("--dataRoot", type=str, default="synthetic")
parser.add_argument("--batchSize", "-b", type=int, default=16)
parser.add_argument("--workers", type=int, default=4)
parser.add_argument("--nEpoch", type=int, default=10)
parser.add_argument("--optim", type=str, default="Adam", choices=["Adam", "SGD"])
parser.add_argument("--weightDecay", type=float, default=5e-6)
parser.add_argument("--lr", type=float, default=1e-4)
parser.add_argument("--checkpoint_root", type=str, default="checkpoints")
parser.add_argument("--print_freq", type=int, default=10)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")

PIX3D_IMAGE_SIZE = 224


def _host(batch, device, *names):
    return [torch.from_numpy(getattr(batch, n)).to(device) for n in names]


def classifier_step(model: ResNet50, optimizer: torch.optim.Optimizer,
                    images: torch.Tensor, labels: torch.Tensor):
    """One classifier update (train-mode BatchNorm): (loss, acc) before it."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits, _ = model(images)
    loss = F.cross_entropy(logits, labels.long())
    loss.backward()
    optimizer.step()
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss.detach(), acc


def maskrcnn_step(model: Pix3DMaskRCNN, optimizer: torch.optim.Optimizer,
                  scheduler, uniform: Uniform, images, boxes, labels, masks):
    """One Mask R-CNN update on the sum of its losses: (total, losses) before it."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    _, losses, _ = model(images, boxes, labels, masks, uniform)
    total = sum(losses.values())
    total.backward()
    optimizer.step()
    scheduler.step()
    return total.detach(), {k: v.detach() for k, v in losses.items()}


def save_backbone(model: torch.nn.Module, path: str, settings: dict) -> str:
    """``<path>.pt`` of the backbone's tensors as ``backbone.*`` and ``settings``."""
    path = os.path.abspath(path + ".pt")
    torch.save({"model": {f"backbone.{k}": v for k, v in model.state_dict().items()},
                "settings": dict(settings)}, path)
    return path


def _loader(options, is_pix3d: bool):
    classes = options.classes.split(",") if options.classes else None
    n = max(options.num_sampels or 64, options.batchSize)
    if options.dataRoot == "synthetic":
        dataset = (SyntheticDataset(n=n, image_size=PIX3D_IMAGE_SIZE, num_voxels=32,
                                    num_classes=10, pix3d=True)
                   if is_pix3d else SyntheticDataset(n=n))
    else:
        dataset = (pix3dDataset(options.dataRoot, classes) if is_pix3d
                   else shapeNet_Dataset(options.dataRoot, classes))
    loader = dataLoader(dataset, options.batchSize, 24 if is_pix3d else 48,
                        CapacityConfig(gt_verts=64, gt_faces=64),
                        num_train_samples=options.num_sampels, train_ratio=options.train_ratio,
                        image_size=PIX3D_IMAGE_SIZE if is_pix3d else None,
                        workers=options.workers)
    # the JAX CLI draws one batch to initialise its model, which takes the
    # loader's first shuffle; taking it here gives every epoch JAX's order
    loader.rng.shuffle(list(loader.indices))
    return loader


def _epochs(options, loader, meters, ckpt_dir, model, settings, run_batch) -> dict:
    written = {"dir": ckpt_dir, "checkpoints": [], "stats": []}
    for epoch in range(options.nEpoch):
        end = time.time()
        for i, batch in enumerate(loader):
            if "data_loading" in meters:
                meters["data_loading"].update(time.time() - end)
            run_batch(batch)
            meters["batch_time"].update(time.time() - end)
            end = time.time()
            if i % options.print_freq == 0:
                safe_print(f"epoch {epoch} [{i}/{len(loader)}] "
                           + "\t".join(str(m) for m in meters.values()))
        for m in meters.values():
            m.epoch_end()
        written["checkpoints"].append(
            save_backbone(model, os.path.join(ckpt_dir, f"backbone_{epoch}"), settings))
        stats = os.path.join(ckpt_dir, f"stats_{epoch}.st")
        save_stats(meters, stats)
        written["stats"].append(stats)
    return dict(written, meters=meters, model=model)


def main(argv=None) -> dict:
    """Train as the flags in ``argv`` say. Returns what it wrote (``dir``, the
    ``checkpoints`` and ``stats`` of each epoch), the ``meters`` and the ``model``."""
    options = parser.parse_args(argv)
    device = device_of(options.device)
    if options.model == "Pix3D":
        return train_pix3d_backbone(options, device)

    loader = _loader(options, False)
    torch.manual_seed(0)
    model = ResNet50(num_classes=13).to(device)
    optimizer, _ = make_optimizer(TrainConfig(optimizer=options.optim.lower(), lr=options.lr,
                                              weight_decay=options.weightDecay,
                                              train_backbone=True), model)
    meters = {"loss": AverageMeter("loss", ":.4f"), "acc": AverageMeter("acc", ":.3f"),
              "batch_time": AverageMeter("batch_time", ":6.3f")}

    def run_batch(batch):
        loss, acc = classifier_step(model, optimizer, *_host(batch, device, "images", "labels"))
        meters["loss"].update(float(loss))
        meters["acc"].update(float(acc))

    ckpt_dir = checkpoint_dir(options.checkpoint_root, options.model, kind="backbone")
    out = _epochs(options, loader, meters, ckpt_dir, model,
                  {"model": "ShapeNet", "num_classes": 13, "backbone_dtype": "float32"},
                  run_batch)
    safe_print("backbone training done")
    return out


def train_pix3d_backbone(options, device: torch.device) -> dict:
    """Mask R-CNN-only training: RPN, RoI and mask losses, no mesh branch
    (reference: train_backbone.py's Pix3D path, utils/train_utils.py:110-171)."""
    loader = _loader(options, True)
    torch.manual_seed(0)
    model = Pix3DMaskRCNN(num_classes=10).to(device)
    optimizer, scheduler = make_optimizer(TrainConfig(optimizer="sgd",
                                                      weight_decay=options.weightDecay,
                                                      train_backbone=True,
                                                      pix3d_schedule=True), model)
    uniform = uniform_from(torch.Generator(device=device).manual_seed(0))
    meters = maskrcnn_metrics()
    meters["loss"] = AverageMeter("loss", ":.4f")

    def run_batch(batch):
        total, losses = maskrcnn_step(model, optimizer, scheduler, uniform,
                                      *_host(batch, device, "images", "boxes", "labels",
                                             "masks"))
        meters["loss"].update(float(total))
        for k, v in losses.items():
            meters[k].update(float(v))

    ckpt_dir = checkpoint_dir(options.checkpoint_root, "Pix3D", kind="backbone")
    out = _epochs(options, loader, meters, ckpt_dir, model,
                  {"model": "Pix3D", "num_classes": 10, "backbone_dtype": "bfloat16"},
                  run_batch)
    safe_print("pix3d backbone training done")
    return out


if __name__ == "__main__":
    main()
