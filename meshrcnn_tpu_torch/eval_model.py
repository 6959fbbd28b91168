"""Dataset evaluation on a CUDA card (counterpart of the JAX package's
eval_model.py; reference: eval_model.py:13-44).

    python -m meshrcnn_tpu_torch.eval_model --model ShapeNet --model_path <ckpt.pt> ...

Evaluates a checkpoint of ``meshrcnn_tpu_torch.train`` on the test side of the
seed-42 split of ``--dataRoot``: voxel, chamfer, normal and edge losses, the
confusion-based f0_1 / f0_3 / f0_5 and point-cloud F1@0.1 / 0.3; for Pix3D
also AP_box, AP_mask, AP_mesh and the score-ranked AP50s (ranked AP on, as
the JAX ``validate_pix3d`` has it). Pickles the metrics, ``confusion``
included, to ``<output_path>/metrics_<model>.st``. ``--knn_normals`` scores
normals estimated by kNN + PCA (K3), as the JAX CLI under
``MESHRCNN_FACE_NORMALS=0``; face normals by default. Runs on the card unless
``--device cpu``; without a card it raises.

Data-parallel eval, as the JAX CLI has it: ``--num_devices N`` (default 1)
spawns N ranks, one process and one card each (NCCL; gloo on the CPU), and
``--multihost`` joins the ranks ``torchrun`` started. ``--batchSize`` is the
global batch and must divide by N; each rank runs the forward on its rows,
the outputs are gathered along the batch (``make_dp_eval_step``) and rank 0
computes the metrics of the whole batch and writes them. The JAX CLI's
``--split_eval`` (a TPU workaround) is not here.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np
import torch

from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.data.datasets import dataLoader
from meshrcnn_tpu_torch.harness import validate, validate_pix3d
from meshrcnn_tpu_torch.ops.sampling import Uniform, uniform_from
from meshrcnn_tpu_torch.parallel import distributed
from meshrcnn_tpu_torch.parallel.train_step import (create_train_state, make_dp_eval_step,
                                                    make_eval_step)
from meshrcnn_tpu_torch.utils import cli
from meshrcnn_tpu_torch.utils.checkpoint import load_state, load_state_partial
from meshrcnn_tpu_torch.utils.meters import safe_print

parser = argparse.ArgumentParser(description="dataset evaluation script")
cli.add_model_flags(parser)
cli.add_parallel_flags(parser, "1")
parser.add_argument("--model_path", type=str, default="",
                    help="checkpoint of meshrcnn_tpu_torch.train to evaluate")
parser.add_argument("--synthetic_size", type=int, default=64,
                    help="total size of the synthetic dataset; give the value train "
                         "was given, so the test side of the seed-42 split is disjoint "
                         "from the training samples")
parser.add_argument("--test_ratio", type=float, default=1.0, help="ratio of samples to test")
parser.add_argument("--output_path", type=str, default=".")
parser.add_argument("--print_freq", type=int, default=10)


def main(argv=None, uniform: Optional[Uniform] = None) -> dict:
    """Evaluate as the flags in ``argv`` say. ``uniform`` is the source of the
    metrics' point-cloud draws; by default a generator on the device seeded
    from ``TrainConfig.seed``. Returns the metrics, with ``path`` the file
    they were written to."""
    return cli.run_ranks(_evaluate, parser.parse_args(argv), 1, uniform)


def _evaluate(options, device: torch.device, uniform: Optional[Uniform]) -> Optional[dict]:
    """The evaluation of one rank; rank 0's returns the metrics, the others None."""
    is_pix3d = options.model == "Pix3D"
    num_classes = 10 if is_pix3d else 13
    config = TrainConfig(point_cloud_size=options.point_cloud_size,
                         batch_size=options.batchSize, face_normals=not options.knn_normals)

    dataset = cli.dataset_of(options, is_pix3d, options.synthetic_size)
    loader = dataLoader(dataset, options.batchSize, cli.num_voxels_of(is_pix3d),
                        cli.capacities_of(options), test=True,
                        num_train_samples=int(np.floor(len(dataset)
                                                       * (1.0 - options.test_ratio))),
                        image_size=options.img_size if is_pix3d else None,
                        workers=options.workers)
    # the JAX CLI draws one batch to initialise its model, which takes the
    # loader's first shuffle; the batches it evaluates follow the second
    loader.rng.shuffle(list(loader.indices))

    settings = cli.model_settings(options, device)
    torch.manual_seed(config.seed)
    model = cli.build_model(settings, device)
    if options.model_path:
        state = create_train_state(model, config)
        try:
            load_state(options.model_path, state, settings)
            safe_print(f"loaded checkpoint {options.model_path}")
        except (ValueError, RuntimeError, KeyError) as err:
            # another optimizer structure (e.g. a checkpoint trained with
            # --train_backbone): eval reads only the model's entries
            n_loaded, n_total = load_state_partial(options.model_path, state, settings)
            safe_print(f"partially loaded checkpoint {options.model_path} "
                       f"({n_loaded}/{n_total} parameters): {err}")
            if n_loaded < n_total:
                safe_print("warning: some parameters of the model were not in the "
                           "checkpoint (a voxel-only checkpoint into a full model?)")

    if uniform is None:
        uniform = uniform_from(torch.Generator(device=device).manual_seed(config.seed))
    if distributed.active():
        rank, world = distributed.rank(), distributed.world()
        eval_step = make_dp_eval_step(model)
        shard_fn = lambda batch: distributed.shard_batch(batch, rank, world)  # noqa: E731
    else:
        eval_step, shard_fn = make_eval_step(model), None
    validate_fn = validate_pix3d if is_pix3d else validate
    results = validate_fn(eval_step, loader, config, num_classes, uniform, device=device,
                          voxel_only=options.voxel_only, print_freq=options.print_freq,
                          shard_fn=shard_fn)
    if results is None:               # a rank but the first
        return None
    print({k: v for k, v in results.items() if k != "confusion"})

    os.makedirs(options.output_path, exist_ok=True)
    out = os.path.join(options.output_path, f"metrics_{options.model}.st")
    with open(out, "wb") as f:
        pickle.dump(results, f)
    print(f"metrics saved to {out}")
    return dict(results, path=out)


if __name__ == "__main__":
    main()
