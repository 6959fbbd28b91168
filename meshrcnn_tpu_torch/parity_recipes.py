"""The JAX package's parity recipes through the port's CLIs (counterparts of
tools/run_parity_experiment.sh, run_pix3d_parity.sh,
run_pix3d_detection_scale.sh and run_pix3d_finetune.sh).

    python -m meshrcnn_tpu_torch.parity_recipes shapenet --data_root DIR --out DIR
    python -m meshrcnn_tpu_torch.parity_recipes pix3d --out DIR [--n 400] [--epochs 30]
    python -m meshrcnn_tpu_torch.parity_recipes pix3d_detection_scale --out DIR \\
        [--n 950] [--epochs 24]
    python -m meshrcnn_tpu_torch.parity_recipes pix3d_finetune --ckpt FINAL.pt --out DIR \\
        [--mode frozen|<lr>] [--epochs 12] [--n 950]

Each recipe runs the phases of its script, with the script's flags, through
``train.main`` and ``eval_model.main`` in this process, and hands each
phase's ``final.pt`` to the next as the script hands its ``final``
checkpoint on:

  * ``shapenet``: on ``--n`` (1400) training samples, phase A,
    ``--voxel_only`` for ``--epochs_a`` (10) epochs;
    phase B, the full model for ``--epochs_b`` (25) epochs from A's
    checkpoint; phase C, the held-out eval (``--test_ratio 0.0666``), on the
    mini-ShapeNet at ``--data_root`` (``make_mini_shapenet`` and
    ``download_dataset --render_meshes --build_manifest``);
  * ``pix3d``: SGD under the Pix3D schedule on ``--n`` synthetic samples for
    ``--epochs``, then the held-out eval;
  * ``pix3d_detection_scale``: Adam at lr 1e-3 on ``--n`` of round(n / 0.85)
    synthetic samples (asserting floor(size * 0.85) = n, so train and eval
    split alike), then the eval of the held-out 15%;
  * ``pix3d_finetune``: from ``--ckpt`` (the detection-scale run's
    ``final.pt``), ``--mode frozen`` trains the mesh branch alone under the
    verbatim Pix3D schedule, the whole detector (``backbone.*``) frozen;
    ``--mode <lr>`` trains everything with SGD at that flat lr; then the eval.

Where a script exports ``MESHRCNN_FACE_NORMALS=0`` (the ShapeNet and Pix3D
parity scripts) every phase gets ``--knn_normals``; ``--device`` goes to
every phase. After the
run the port's held-out metrics are printed beside the JAX run's
``experiments/<recipe>/eval_metrics.st`` and the last phase's per-epoch
losses beside its ``stats_*.st`` (read with the port's ``load_stats``),
where the repo holds that run. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from meshrcnn_tpu_torch import eval_model, train
from meshrcnn_tpu_torch.utils.meters import load_stats

RECIPES = ("shapenet", "pix3d", "pix3d_detection_scale", "pix3d_finetune")
# the folders of the JAX runs' results, where the repo holds them
REFERENCE_ROOT = Path(__file__).resolve().parents[1] / "experiments"
REFERENCE_RUNS = {"shapenet": "parity_shapenet", "pix3d": "parity_pix3d"}
EVAL_KEYS = ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss", "voxel_iou",
             "F1@0.1", "F1@0.3")
PIX3D_EVAL_KEYS = ("AP_box", "AP_mask", "AP_mesh", "AP50_box", "AP50_mask", "AP_mesh_ranked")
EPOCH_KEYS = ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss", "backbone_loss", "loss")

# The scripts' flags, word for word; {name} fields are filled from the run's flags.
SHAPENET_COMMON = (
    "--model ShapeNet --dataRoot {data} --batchSize 3 --num_sampels {n} "
    "--optim Adam --weightDecay 0.0 --lr 1e-4 --threshold 0.2 "
    "--chamfer 1.0 --voxel 1.0 --normal 0.0 --edge 0.5 --residual "
    "--train_backbone "
    "--vert_capacity 8192 --face_capacity 16384 --edge_capacity 32768 "
    "--point_cloud_size 10000 --print_freq 50")
SHAPENET_EVAL = (
    "--model ShapeNet --dataRoot {data} --batchSize 3 "
    "--model_path {full} --residual --threshold 0.2 "
    "--vert_capacity 8192 --face_capacity 16384 --edge_capacity 32768 "
    "--point_cloud_size 10000 --test_ratio 0.0666 "
    "--output_path {out}/eval")
PIX3D_COMMON = (
    "--model Pix3D --dataRoot synthetic --batchSize 4 --num_sampels {n} "
    "--optim SGD --weightDecay 1e-4 --threshold 0.2 "
    "--voxel 3.0 --chamfer 1.0 --normal 0.1 --edge 0.5 "
    "--train_backbone --grad_clip 1.0 "
    "--vert_capacity 4096 --face_capacity 8192 --edge_capacity 16384 "
    "--point_cloud_size 10000 --img_size 224 --print_freq 25")
PIX3D_EVAL = (
    "--model Pix3D --dataRoot synthetic --batchSize 4 "
    "--model_path {ckpt} --threshold 0.2 "
    "--vert_capacity 4096 --face_capacity 8192 --edge_capacity 16384 "
    "--point_cloud_size 10000 --img_size 224 --test_ratio 0.15 "
    "--output_path {out}/eval")
DETECTION_COMMON = (
    "--model Pix3D --dataRoot synthetic --batchSize 4 --num_sampels {n} "
    "--synthetic_size {size} "
    "--optim Adam --lr 1e-3 --weightDecay 0.0 --threshold 0.2 "
    "--voxel 3.0 --chamfer 1.0 --normal 0.1 --edge 0.5 "
    "--train_backbone --grad_clip 1.0 --no_pix3d_schedule "
    "--vert_capacity 4096 --face_capacity 8192 --edge_capacity 16384 "
    "--point_cloud_size 10000 --img_size 224 --print_freq 25 --workers 2")
SCALE_EVAL = (
    "--model Pix3D --dataRoot synthetic --batchSize 4 "
    "--synthetic_size {size} --model_path {ckpt} --threshold 0.2 "
    "--vert_capacity 4096 --face_capacity 8192 --edge_capacity 16384 "
    "--point_cloud_size 10000 --img_size 224 --test_ratio 0.15 "
    "--output_path {out}/eval")
FINETUNE_COMMON = (
    "--model Pix3D --dataRoot synthetic --batchSize 4 --num_sampels {n} "
    "--synthetic_size {size} "
    "--optim SGD --weightDecay 0.0 --threshold 0.2 "
    "--voxel 3.0 --chamfer 1.0 --normal 0.1 --edge 0.5 "
    "--grad_clip 1.0 "
    "--vert_capacity 4096 --face_capacity 8192 --edge_capacity 16384 "
    "--point_cloud_size 10000 --img_size 224 --print_freq 25 --workers 2")
FINETUNE_FLAT = "--train_backbone --no_pix3d_schedule --lr {mode}"

parser = argparse.ArgumentParser("the JAX package's parity recipes through the port's CLIs")
parser.add_argument("recipe", choices=RECIPES)
parser.add_argument("--out", type=str, required=True, help="directory the phases write under")
parser.add_argument("--data_root", type=str, default=None,
                    help="shapenet: the mini-ShapeNet root (shapenet.json and its files)")
parser.add_argument("--ckpt", type=str, default=None,
                    help="pix3d_finetune: the detection-scale run's final.pt")
parser.add_argument("--mode", type=str, default="frozen",
                    help="pix3d_finetune: 'frozen' or a flat SGD lr such as 2e-3")
parser.add_argument("--n", type=int, default=None,
                    help="training samples (default 1400 shapenet, 400 pix3d, 950 the others)")
parser.add_argument("--epochs", type=int, default=None,
                    help="Pix3D epochs (default 30 pix3d, 24 detection scale, 12 finetune)")
parser.add_argument("--epochs_a", type=int, default=10, help="shapenet phase A epochs")
parser.add_argument("--epochs_b", type=int, default=25, help="shapenet phase B epochs")
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device of every phase: 'cuda' (default) or 'cpu'")

# Each recipe's defaults of --n / --epochs, and the recipes whose script
# exports MESHRCNN_FACE_NORMALS=0.
DEFAULTS = {"shapenet": (1400, None), "pix3d": (400, 30),
            "pix3d_detection_scale": (950, 24), "pix3d_finetune": (950, 12)}
KNN_NORMALS = ("shapenet", "pix3d")


def _flags(text: str, **fields) -> List[str]:
    return text.format(**fields).split()


def detection_size(n: int) -> int:
    """The synthetic dataset's size for ``n`` training samples, as the
    detection-scale script sizes it: round(n / 0.85), with its assert that
    the 15% test side starts right after the n training samples."""
    size = int(round(n / 0.85))
    assert math.floor(size * 0.85) == n, (size, n, "adjust SIZE for this N")
    return size


def phases(args) -> List[Tuple[str, str, List[str]]]:
    """The recipe's phases as (name, "train" | "eval", argv). A checkpoint an
    earlier phase writes is the field ``{<phase>}``, filled by ``run``."""
    out, r = args.out, args.recipe
    n, epochs = args.n or DEFAULTS[r][0], args.epochs or DEFAULTS[r][1]
    if r == "shapenet":
        if not args.data_root:
            raise ValueError("shapenet needs --data_root")
        common = _flags(SHAPENET_COMMON, data=args.data_root, n=n)
        out_list = [
            ("warm", "train", common + _flags(
                "--voxel_only --nEpoch {e} --checkpoint_root {out}/warm",
                e=args.epochs_a, out=out)),
            ("full", "train", common + _flags(
                "--nEpoch {e} --model_path {{warm}} --checkpoint_root {out}/full",
                e=args.epochs_b, out=out)),
            ("eval", "eval", _flags(SHAPENET_EVAL, data=args.data_root, full="{full}",
                                    out=out))]
    elif r == "pix3d":
        out_list = [
            ("train", "train", _flags(PIX3D_COMMON, n=n) + _flags(
                "--nEpoch {e} --checkpoint_root {out}/train", e=epochs, out=out)),
            ("eval", "eval", _flags(PIX3D_EVAL, ckpt="{train}", out=out))]
    elif r == "pix3d_detection_scale":
        size = detection_size(n)
        out_list = [
            ("train", "train", _flags(DETECTION_COMMON, n=n, size=size) + _flags(
                "--nEpoch {e} --checkpoint_root {out}/train", e=epochs, out=out)),
            ("eval", "eval", _flags(SCALE_EVAL, size=size, ckpt="{train}", out=out))]
    else:
        if not args.ckpt:
            raise ValueError("pix3d_finetune needs --ckpt")
        size = int(round(n / 0.85))
        phase2 = _flags(FINETUNE_COMMON, n=n, size=size)
        if args.mode != "frozen":
            phase2 += _flags(FINETUNE_FLAT, mode=args.mode)
        out_list = [
            ("train", "train", phase2 + _flags(
                "--nEpoch {e} --model_path {ckpt} --checkpoint_root {out}/train",
                e=epochs, ckpt=args.ckpt, out=out)),
            ("eval", "eval", _flags(SCALE_EVAL, size=size, ckpt="{train}", out=out))]
    extra = ["--device", args.device] + (["--knn_normals"] if r in KNN_NORMALS else [])
    return [(name, kind, argv + extra) for name, kind, argv in out_list]


def _last_stats(folder: str) -> Optional[dict]:
    """The ``stats_<epoch>.st`` of the highest epoch in ``folder`` (every
    meter's history of epoch means), or None."""
    paths = glob.glob(os.path.join(folder, "stats_*.st"))
    if not paths:
        return None
    return load_stats(max(paths, key=lambda p: int(re.findall(r"(\d+)\.st$", p)[0])))


def compare(recipe: str, heldout: dict, stats: Optional[dict]) -> dict:
    """The port's held-out metrics and per-epoch losses beside the JAX run's
    (``{"heldout": [...], "epochs": [...]}``, one row a metric or an epoch);
    the JAX column is None where the repo holds no such run."""
    folder = os.path.join(REFERENCE_ROOT, REFERENCE_RUNS.get(recipe, ""))
    have = recipe in REFERENCE_RUNS and os.path.isfile(os.path.join(folder, "eval_metrics.st"))
    jax_eval = load_stats(os.path.join(folder, "eval_metrics.st")) if have else {}
    keys = EVAL_KEYS + (PIX3D_EVAL_KEYS if recipe != "shapenet" else ())
    rows = [{"metric": k, "port": heldout.get(k), "jax": jax_eval.get(k)} for k in keys
            if k in heldout]
    jax_stats = _last_stats(folder) if have else None
    epochs = []
    if stats is not None:
        n_epochs = max(len(m["history"]) for m in stats.values())
        for e in range(n_epochs):
            row = {"epoch": e}
            for k in EPOCH_KEYS:
                if k in stats and e < len(stats[k]["history"]):
                    jax_h = (jax_stats or {}).get(k, {}).get("history", [])
                    row[k] = {"port": stats[k]["history"][e],
                              "jax": jax_h[e] if e < len(jax_h) else None}
            epochs.append(row)
    return {"heldout": rows, "epochs": epochs}


def run(args) -> dict:
    """Run the recipe of ``args``: {"phases": {name: what its CLI returned},
    "comparison": ``compare``'s rows}."""
    done: Dict[str, dict] = {}
    checkpoints: Dict[str, str] = {}
    for name, kind, argv in phases(args):
        argv = [a.format(**checkpoints) if "{" in a else a for a in argv]
        print(f"=== {args.recipe} phase {name}: {kind} {' '.join(argv)}", flush=True)
        if kind == "train":
            res = {k: v for k, v in train.main(argv).items() if k != "state"}
            checkpoints[name] = res["final"]
            print(f"{name} checkpoint: {res['final']}", flush=True)
        else:
            res = eval_model.main(argv)
        done[name] = res
    last_train = [r for r in done.values() if "stats" in r][-1]
    stats = load_stats(last_train["stats"][-1]) if last_train["stats"] else None
    comparison = compare(args.recipe, done["eval"], stats)
    for row in comparison["heldout"]:
        print(json.dumps({"recipe": args.recipe, "heldout": row}), flush=True)
    for row in comparison["epochs"]:
        print(json.dumps({"recipe": args.recipe, "epoch_means": row}), flush=True)
    return {"phases": done, "comparison": comparison}


def main(argv=None) -> dict:
    return run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
