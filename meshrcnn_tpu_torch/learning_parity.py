"""The learning-parity protocol on the card (counterpart of the baseline arm
of the JAX package's tools/agg_bf16_parity.py:65-145).

    python -m meshrcnn_tpu_torch.learning_parity [--seeds 1 7] [--epochs 5] [--n 240] [--batch 4]

Trains the ShapeNet recipe from scratch on the synthetic dataset and scores
the trained model on held-out samples, once a seed: ``SyntheticDataset(n,
137x137, 32^3 grids, 13 classes)`` collated to 48^3 grids in batches of
``--batch`` with capacities 2048/4096/8192; the first n - n // 6 samples train
and the rest are held out. The model is ``ShapeNetModel(13 classes, residual,
cubify threshold 0.2, 3 stages)`` with the bfloat16 backbone of the JAX model's
default, its initial weights flax's (``models/init.py``: ``lecun_normal``
kernels, zero biases, GraphConv's uniform), drawn from torch's global
generator at seed 0 whatever the seed; the
training is Adam at lr 1e-4 without weight decay, the backbone trained, clouds
of 2048 points, loss weights voxel 1, chamfer 1, normal 0, edge 0.5. The seed
seeds the train step's draws, as the JAX tool's ``--seed`` keys its steps;
held-out batch i draws from a generator seeded 100 + i, as the JAX tool keys
it with ``PRNGKey(100 + i)``.

Prints the card's name and power limit, then the JAX tool's JSON lines (the
arm is ``baseline``; each line also names its ``seed``): one a epoch with the
mean voxel, chamfer, edge and total loss over its steps, then the held-out
voxel loss, voxel IoU, chamfer loss and point-cloud F1@0.1 and F1@0.3 of
``harness.shapenet_eval_metrics``; and last a summary of every seed. The other
arms of the JAX tool switch environment gates of JAX kernels that the port
does not have. Runs on the card unless ``--device cpu``; without a card it
raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from meshrcnn_tpu_torch.core.config import CapacityConfig, LossWeights, TrainConfig
from meshrcnn_tpu_torch.data.datasets import SyntheticDataset, collate
from meshrcnn_tpu_torch.harness import shapenet_eval_metrics
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.ops.sampling import uniform_from
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_eval_step, make_train_step)
from meshrcnn_tpu_torch.utils.cli import device_of

parser = argparse.ArgumentParser("learning-parity protocol")
parser.add_argument("--seeds", type=int, nargs="+", default=[1, 7],
                    help="seeds of the train steps' draws, one training run each")
parser.add_argument("--epochs", type=int, default=5)
parser.add_argument("--n", type=int, default=240, help="samples; the last n // 6 are held out")
parser.add_argument("--batch", type=int, default=4)
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")

CAPS = CapacityConfig(verts=2048, faces=4096, edges=8192)
TAUS = (0.1, 0.3)
EPOCH_KEYS = ("voxel_loss", "chamfer_loss", "edge_loss", "loss")


def protocol_batches(n: int, batch: int):
    """(train, held-out) lists of numpy batches, the JAX tool's ``batches_of``."""
    n_train = n - n // 6
    ds = SyntheticDataset(n=n, image_size=137, num_voxels=32, num_classes=13, pix3d=False)

    def batches_of(lo, hi):
        return [collate([ds[j] for j in range(i, i + batch)], 48, CAPS)
                for i in range(lo, hi - batch + 1, batch)]
    return batches_of(0, n_train), batches_of(n_train, n)


def _setup(batch: int, device: torch.device):
    """(model, config) of the protocol, the model's flax initialisation drawn
    from torch's global generator at seed 0."""
    torch.manual_seed(0)
    model = ShapeNetModel(num_classes=13, residual=True, cubify_threshold=0.2,
                          vert_capacity=CAPS.verts, face_capacity=CAPS.faces,
                          edge_capacity=CAPS.edges, num_refinement_stages=3,
                          backbone_dtype="bfloat16").to(device)
    config = TrainConfig(optimizer="adam", lr=1e-4, weight_decay=0.0, batch_size=batch,
                         point_cloud_size=2048, normal_k=10, distance_tile=1024,
                         train_backbone=True,
                         loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5))
    return model, config


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def run_seed(seed: int, train_batches, test_batches, epochs: int, batch: int,
             device: torch.device) -> dict:
    """Train one seed's run and score it on the held-out batches: {"epochs":
    [mean losses of each epoch], "heldout": {held-out metrics}}."""
    model, config = _setup(batch, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    state = create_train_state(model, config, generator)
    step = make_train_step(config, uniform_from(generator))
    t0 = time.time()
    epochs_out = []
    for e in range(epochs):
        sums = dict.fromkeys(EPOCH_KEYS, 0.0)
        for b in train_batches:
            metrics = step(state, Batch.from_host(b, device))
            values = torch.stack([metrics[k].float() for k in EPOCH_KEYS]).tolist()
            for k, v in zip(EPOCH_KEYS, values):
                sums[k] += v
        row = {k: round(v / len(train_batches), 5) for k, v in sums.items()}
        epochs_out.append(row)
        _emit({"arm": "baseline", "seed": seed, "epoch": e, **row,
               "elapsed_s": round(time.time() - t0, 1)})

    eval_step = make_eval_step(model)
    agg = dict.fromkeys(("voxel_loss", "voxel_iou", "chamfer_loss", "f1_01", "f1_03"), 0.0)
    f1_n = 0
    for i, b in enumerate(test_batches):
        d = Batch.from_host(b, device)
        m = shapenet_eval_metrics(
            eval_step(d.images), d.voxels, d.gt_verts, d.gt_faces, d.gt_faces_mask,
            config.point_cloud_size,
            uniform_from(torch.Generator(device=device).manual_seed(100 + i)), TAUS, False,
            config.normal_k, config.distance_tile, config.face_normals)
        for k in ("voxel_loss", "voxel_iou", "chamfer_loss"):
            agg[k] += float(m[k])
        f1 = m["f1_sum"].tolist()
        agg["f1_01"] += f1[0]
        agg["f1_03"] += f1[1]
        f1_n += int(m["f1_count"])
    nb = max(len(test_batches), 1)
    heldout = {k: round(agg[k] / nb, 5) for k in ("voxel_loss", "voxel_iou", "chamfer_loss")}
    heldout["F1@0.1"] = round(agg["f1_01"] / max(f1_n, 1), 5)
    heldout["F1@0.3"] = round(agg["f1_03"] / max(f1_n, 1), 5)
    _emit({"arm": "baseline", "seed": seed, "heldout": heldout})
    return {"epochs": epochs_out, "heldout": heldout}


def main(argv=None) -> dict:
    """Run the protocol of the flags in ``argv``; returns {seed: run_seed's result}."""
    from meshrcnn_tpu_torch.bench import device_info

    args = parser.parse_args(argv)
    device = device_of(args.device)
    name, power = device_info(device)
    _emit({"device": name, "power_limit_w": power, "seeds": args.seeds, "epochs": args.epochs,
           "n": args.n, "batch": args.batch})
    train_batches, test_batches = protocol_batches(args.n, args.batch)
    print(f"{len(train_batches)} train / {len(test_batches)} held-out batches", flush=True)
    results = {seed: run_seed(seed, train_batches, test_batches, args.epochs, args.batch,
                              device) for seed in args.seeds}
    summary = {}
    for seed, r in results.items():
        first, last = r["epochs"][0], r["epochs"][-1]
        summary[seed] = {
            "finite": bool(np.isfinite([v for row in r["epochs"] for v in row.values()]).all()
                           and np.isfinite(list(r["heldout"].values())).all()),
            "voxel_loss_fell": last["voxel_loss"] < first["voxel_loss"],
            "chamfer_loss_fell": last["chamfer_loss"] < first["chamfer_loss"],
            "F1@0.1": r["heldout"]["F1@0.1"], "F1@0.3": r["heldout"]["F1@0.3"]}
    _emit({"arm": "baseline", "summary": summary})
    return results


if __name__ == "__main__":
    main()
