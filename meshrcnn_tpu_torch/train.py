"""GCN training on a CUDA card (counterpart of the JAX package's train.py;
reference: train.py:19-74).

    python -m meshrcnn_tpu_torch.train --model ShapeNet [--dataRoot synthetic] ...
    python -m meshrcnn_tpu_torch.train --model Pix3D --device cpu ...

Trains ``--nEpoch`` epochs over ``--dataRoot`` (the built-in synthetic dataset
by default) through the port's data layer, one train step a batch, and after
each epoch writes ``model_<epoch>.pt`` and ``stats_<epoch>.st`` into
``<checkpoint_root>/<model>/GCN/<date>/``, then ``final.pt``. Runs on the card
unless ``--device cpu``; without a card it raises. ``--model_path`` resumes a
checkpoint (``load_state``, else the matching entries through
``load_state_partial``); ``--backbone_path`` loads a torchvision ResNet-50 or
``maskrcnn_resnet50_fpn`` state dict, or a checkpoint of this CLI.
``--knn_normals`` trains the normal loss on normals estimated by kNN + PCA
(K3, 6 launches a step), as the JAX CLI under ``MESHRCNN_FACE_NORMALS=0``;
the default is the sampled triangles' face normals.

Data parallelism, as the JAX CLI has it: ``--num_devices N`` (default every
visible card; one on the CPU) spawns N ranks, one process and one card each,
NCCL on the card and gloo on the CPU; ``--multihost`` joins the ranks
``torchrun`` started:

    torchrun --nproc_per_node 4 -m meshrcnn_tpu_torch.train --multihost --model ShapeNet ...

``--batchSize`` is the global batch; each rank takes its rows of it and runs
``make_dp_train_step``. Rank 0 prints and writes the checkpoints and stats.
One rank without ``--multihost`` runs the single-card step.

``--steps_per_dispatch N`` runs the batches in groups of N steps, one
``make_multi_step`` call a group that reads nothing back to the host between
its steps (under data parallelism ``make_multi_step(group=...)`` on each
rank's rows of the group, ``shard_stacked_batch``); an epoch's leftover
batches run one step each. The step count counts every step, so checkpoints
and ``--model_path`` resume as without groups.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.data.datasets import dataLoader
from meshrcnn_tpu_torch.harness import train_epoch
from meshrcnn_tpu_torch.ops.sampling import Uniform, uniform_from
from meshrcnn_tpu_torch.parallel import distributed
from meshrcnn_tpu_torch.parallel.train_step import (create_train_state, make_dp_train_step,
                                                    make_multi_step, make_train_step)
from meshrcnn_tpu_torch.utils import cli
from meshrcnn_tpu_torch.utils.checkpoint import (checkpoint_dir, load_state,
                                                 load_state_partial, save_state)
from meshrcnn_tpu_torch.utils.meters import gcn_metrics, safe_print, save_stats
from meshrcnn_tpu_torch.utils.torch_convert import load_backbone

parser = argparse.ArgumentParser(description="GCN training script")
cli.add_model_flags(parser)
cli.add_parallel_flags(parser, "every visible card; 1 on the CPU")
parser.add_argument("--model_path", default="",
                    help="checkpoint of this CLI to continue training from")
parser.add_argument("--backbone_path", "-bp", type=str, default="",
                    help="torchvision ResNet-50 / maskrcnn_resnet50_fpn state dict, or a "
                         "checkpoint of this CLI, for the backbone")
parser.add_argument("--train_backbone", default=False, action="store_true",
                    help="train the backbone in addition to the GCN")
parser.add_argument("--chamfer", type=float, default=1.0, help="chamfer loss weight")
parser.add_argument("--voxel", type=float, default=1.0, help="voxel loss weight")
parser.add_argument("--normal", type=float, default=0.1, help="normal loss weight")
parser.add_argument("--edge", type=float, default=0.5, help="edge loss weight")
parser.add_argument("--backbone", type=float, default=1.0, help="backbone loss weight")
parser.add_argument("--num_sampels", type=int, default=None,
                    help="number of samples to train on")
parser.add_argument("--synthetic_size", type=int, default=None,
                    help="total size of the synthetic dataset; set it larger than "
                         "--num_sampels and give eval_model the same value to keep "
                         "held-out samples (one seed-42 split for both)")
parser.add_argument("--train_ratio", type=float, default=None,
                    help="ratio of samples used for training")
parser.add_argument("--nEpoch", type=int, default=10, help="number of epochs")
parser.add_argument("--optim", type=str, default="Adam", choices=["Adam", "SGD"])
parser.add_argument("--weightDecay", type=float, default=5e-6)
parser.add_argument("--lr", type=float, default=1e-4)
parser.add_argument("--checkpoint_root", type=str, default="checkpoints")
parser.add_argument("--print_freq", type=int, default=10)
parser.add_argument("--rpn_pre_nms_top_n", type=int, default=1000)
parser.add_argument("--roi_batch_size", type=int, default=512)
parser.add_argument("--grad_clip", type=float, default=0.0,
                    help="global-norm gradient clip (0 disables)")
parser.add_argument("--no_pix3d_schedule", default=False, action="store_true",
                    help="use --lr as it is instead of the reference's Pix3D warmup and "
                         "step schedule")
parser.add_argument("--steps_per_dispatch", type=int, default=1,
                    help="train steps run as one group (make_multi_step), which reads "
                         "nothing back to the host between its steps; composes with "
                         "--num_devices data parallelism")
parser.add_argument("--report_unweighted_losses", default=False, action="store_true",
                    help="compute loss terms whose weight is 0, to report them")


def train_config(options) -> TrainConfig:
    """The optimizer, schedule, loss weights and loop of the flags."""
    weights = LossWeights(chamfer=options.chamfer, voxel=options.voxel,
                          normal=options.normal, edge=options.edge,
                          backbone=options.backbone)
    return TrainConfig(optimizer=options.optim.lower(), lr=options.lr,
                       weight_decay=options.weightDecay,
                       batch_size=options.batchSize, epochs=options.nEpoch,
                       train_backbone=options.train_backbone,
                       point_cloud_size=options.point_cloud_size,
                       loss_weights=weights, grad_clip=options.grad_clip,
                       pix3d_schedule=options.model == "Pix3D" and not options.no_pix3d_schedule,
                       report_unweighted_losses=options.report_unweighted_losses,
                       face_normals=not options.knn_normals)


def model_settings(options, device) -> dict:
    """The model config of the flags, which the checkpoints record."""
    return cli.model_settings(options, device, rpn_pre_nms_top_n=options.rpn_pre_nms_top_n,
                              roi_batch_size=options.roi_batch_size)


def main(argv=None, uniform: Optional[Uniform] = None) -> dict:
    """Train as the flags in ``argv`` say. ``uniform`` is the source of the
    train steps' draws; by default the rank's generator (seeded from
    ``TrainConfig.seed`` and the rank). Returns what it wrote: ``dir``, the
    ``checkpoints`` and ``stats`` of each epoch and the ``final`` checkpoint,
    with the ``meters`` and, unless the ranks were spawned, the final train
    ``state``."""
    options = parser.parse_args(argv)
    visible = torch.cuda.device_count() if options.device.startswith("cuda") else 1
    return cli.run_ranks(_train, options, max(visible, 1), uniform)


def _train(options, device: torch.device, uniform: Optional[Uniform] = None) -> dict:
    """The training run of one rank (the only one without data parallelism)."""
    dp = distributed.active()
    rank, world = distributed.rank(), distributed.world()
    is_pix3d = options.model == "Pix3D"
    safe_print(f"{options.model} training on {device}, {world} rank(s), "
               f"{options.nEpoch} epochs\noptions were:\n{options}\n")
    config = train_config(options)

    dataset = cli.dataset_of(options, is_pix3d, max(options.synthetic_size
                                                    or options.num_sampels or 64,
                                                    options.batchSize))
    loader = dataLoader(dataset, options.batchSize, cli.num_voxels_of(is_pix3d),
                        cli.capacities_of(options), num_train_samples=options.num_sampels,
                        train_ratio=options.train_ratio,
                        image_size=options.img_size if is_pix3d else None,
                        workers=options.workers)
    # the JAX CLI draws one batch to initialise its model, which takes the
    # loader's first shuffle; taking it here gives every epoch JAX's order
    loader.rng.shuffle(list(loader.indices))

    settings = model_settings(options, device)
    torch.manual_seed(config.seed)          # the same initial weights on every rank
    model = cli.build_model(settings, device)
    generator = distributed.rank_generator(config.seed, rank, device)
    state = create_train_state(model, config, generator)
    if options.model_path:
        try:
            load_state(options.model_path, state, settings)
            safe_print(f"loaded checkpoint {options.model_path} at step {state.step}")
        except (ValueError, RuntimeError, KeyError) as err:
            # another structure (a voxel-only checkpoint into the full model,
            # another optimizer): merge the matching entries, fresh optimizer
            n_loaded, n_total = load_state_partial(options.model_path, state, settings)
            safe_print(f"partially loaded checkpoint {options.model_path} "
                       f"({n_loaded}/{n_total} parameters): {err}")
    elif options.backbone_path:
        n_loaded, n_fresh = load_backbone(model, options.backbone_path, maskrcnn=is_pix3d)
        safe_print(f"loaded backbone {options.backbone_path}: {n_loaded} tensors, "
                   f"{n_fresh} of heads of another size left fresh")

    uniform, n = uniform or uniform_from(generator), options.steps_per_dispatch
    multi_step_fn = group_shard_fn = None
    if dp:
        step_fn = make_dp_train_step(config, uniform)
        shard_fn = lambda batch: distributed.shard_batch(batch, rank, world)  # noqa: E731
        if n > 1:
            multi_step_fn = make_multi_step(config, uniform, n,
                                            group=torch.distributed.group.WORLD)
            group_shard_fn = lambda group: distributed.shard_stacked_batch(  # noqa: E731
                group, rank, world)
    else:
        step_fn, shard_fn = make_train_step(config, uniform), None
        if n > 1:
            multi_step_fn = make_multi_step(config, uniform, n)
    ckpt_dir = checkpoint_dir(options.checkpoint_root, options.model)
    meters = gcn_metrics(options.voxel_only)
    written = {"dir": ckpt_dir, "checkpoints": [], "stats": []}
    for epoch in range(options.nEpoch):
        state, meters = train_epoch(epoch, step_fn, state, loader, meters, device,
                                    print_freq=options.print_freq, shard_fn=shard_fn,
                                    multi_step_fn=multi_step_fn, steps_per_dispatch=n,
                                    group_shard_fn=group_shard_fn)
        written["checkpoints"].append(save_state(state, os.path.join(ckpt_dir, "model"),
                                                 settings, step=epoch))
        stats = os.path.join(ckpt_dir, f"stats_{epoch}.st")
        if rank == 0:
            save_stats(meters, stats)
        written["stats"].append(stats)
        safe_print(f"epoch {epoch} done; checkpoint and stats saved to {ckpt_dir}")
    written["final"] = save_state(state, os.path.join(ckpt_dir, "final"), settings)
    safe_print("training done")
    return dict(written, state=state, meters=meters)


if __name__ == "__main__":
    main()
