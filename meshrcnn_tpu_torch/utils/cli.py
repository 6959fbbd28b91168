"""What the port's ``train`` and ``eval_model`` entry points share: the
device rule, data parallelism's flags and processes, the dataset of
``--dataRoot``, the model config of the flags (the ``settings`` a checkpoint
records) and the model built from it.

Data parallelism (``--num_devices N``, ``--multihost``): one process a rank.
``--num_devices N`` above 1 spawns N ranks on this host, NCCL on ``cuda:0`` ..
``cuda:N-1`` or gloo on the CPU; ``--multihost`` joins the group ``torchrun``
started. N never exceeds the visible cards (no card is shared, nothing falls
back to gloo or to the CPU), and the global ``--batchSize`` must split evenly
over the ranks (JAX: ``eval_model.py:158``). The kernels are built in the
parent before the ranks start, so they do not race on the build directory.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
from typing import Callable

import torch

from meshrcnn_tpu_torch.core.config import CapacityConfig, resolve_backbone_dtype
from meshrcnn_tpu_torch.data.datasets import SyntheticDataset, pix3dDataset, shapeNet_Dataset
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.parallel import distributed


def device_of(name: str) -> torch.device:
    """The device a CLI runs on: the card unless the CPU is asked for. A CUDA
    request without a CUDA device raises; nothing falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


def add_parallel_flags(parser: argparse.ArgumentParser, default: str) -> None:
    """``--num_devices`` and ``--multihost``; ``default`` says what N defaults to."""
    parser.add_argument("--num_devices", type=int, default=None,
                        help=f"data-parallel ranks, one process and one card each "
                             f"(default: {default}); --batchSize is the global batch "
                             f"and must divide by it")
    parser.add_argument("--multihost", default=False, action="store_true",
                        help="join the process group torchrun started (RANK, WORLD_SIZE, "
                             "LOCAL_RANK, MASTER_ADDR, MASTER_PORT), one rank a process")


def world_of(options, device: torch.device, default: int) -> int:
    """The ranks to spawn: ``--num_devices``, else ``default``. Raises when it
    exceeds the visible cards (the CPU's cores under gloo) or does not divide
    the batch."""
    n = options.num_devices or default
    have = torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)
    if not 1 <= n <= have:
        raise ValueError(f"--num_devices {n}: {have} {device.type} devices are visible; "
                         "a rank never shares a card")
    check_split(options.batchSize, n)
    return n


def check_split(batch_size: int, world: int) -> None:
    if batch_size % world:
        raise ValueError(f"--batchSize {batch_size} does not split over {world} ranks")


def run_ranks(body: Callable, options, default_world: int, *args):
    """``body(options, device, *args)`` on every rank: in this process without
    data parallelism (one rank) or under ``--multihost``, else in
    ``world_of`` spawned processes, each joining a group through a file
    store. Returns rank 0's result (spawned: what of it pickles, without
    ``state``)."""
    device = device_of(options.device)
    if options.multihost:
        distributed.init_from_env(distributed.backend_of(device))
        try:
            check_split(options.batchSize, distributed.world())
            return body(options, _rank_device(device, distributed.local_rank()), *args)
        finally:
            distributed.destroy()
    world = world_of(options, device, default_world)
    if world == 1:
        return body(options, device, *args)
    if device.type == "cuda":
        from meshrcnn_tpu_torch.ops import cuda_build
        cuda_build.build(("chamfer_nn", "knn_topk"))
    with tempfile.TemporaryDirectory() as tmp:
        # spawned, not forked: a child must not inherit an initialised CUDA context
        torch.multiprocessing.spawn(_rank_main, args=(world, tmp, body, options, args),
                                    nprocs=world)
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


def _rank_device(device: torch.device, local: int) -> torch.device:
    dev = torch.device(f"cuda:{local}") if device.type == "cuda" else device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank: int, world: int, tmp: str, body: Callable, options, args) -> None:
    """One spawned rank: join the group, run ``body``, and on rank 0 pickle
    its result for the parent."""
    device = _rank_device(device_of(options.device), rank)
    if device.type == "cpu":         # the ranks share the cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.distributed.init_process_group(distributed.backend_of(device), rank=rank,
                                         world_size=world,
                                         init_method=f"file://{os.path.join(tmp, 'store')}")
    try:
        out = body(options, device, *args)
        if rank == 0 and out is not None:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump({k: v for k, v in out.items() if k != "state"}, f)
    finally:
        distributed.destroy()


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    """The model flags both CLIs take, with the JAX CLIs' names and defaults."""
    parser.add_argument("--model", "-m", choices=["ShapeNet", "Pix3D"], required=True,
                        help="the model to train or evaluate")
    parser.add_argument("--featDim", type=int, default=128, help="number of vertex features")
    parser.add_argument("--num_refinement_stages", "-nr", type=int, default=3,
                        help="number of mesh refinement stages")
    parser.add_argument("--threshold", "-th", type=float, default=0.2, help="cubify threshold")
    parser.add_argument("--voxel_only", default=False, action="store_true",
                        help="only the voxel branch (curriculum warm start)")
    parser.add_argument("--residual", default=False, action="store_true",
                        help="residual refinement for ShapeNet")
    parser.add_argument("-c", "--classes", type=str, default=None,
                        help="comma separated classes of examples in the dataset")
    parser.add_argument("--dataRoot", type=str, default="synthetic",
                        help="dataset root, or 'synthetic' for the built-in dataset")
    parser.add_argument("--batchSize", "-b", type=int, default=16, help="batch size")
    parser.add_argument("--workers", type=int, default=4,
                        help="prefetch threads collating upcoming batches while the "
                             "device runs the current one (0 = synchronous)")
    parser.add_argument("--vert_capacity", type=int, default=8192)
    parser.add_argument("--face_capacity", type=int, default=16384)
    parser.add_argument("--edge_capacity", type=int, default=32768)
    parser.add_argument("--point_cloud_size", type=int, default=10000)
    parser.add_argument("--img_size", type=int, default=224,
                        help="fixed Pix3D input size (the letterbox's square)")
    parser.add_argument("--rpn_post_nms_top_n", type=int, default=512)
    parser.add_argument("--backbone_dtype", type=str, default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="conv compute dtype of the backbone (ShapeNet ResNet-50, Pix3D "
                             "detection stack; norms, box math and losses stay float32). "
                             "'auto' = bfloat16 on the card, float32 on the CPU")
    parser.add_argument("--mesh_feature_norm", default=False, action="store_true",
                        help="parameter-free RMS norm of the RoI features feeding the Pix3D "
                             "mesh branch; must match between train and eval")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: 'cuda' (default) or 'cpu'")
    parser.add_argument("--knn_normals", default=False, action="store_true",
                        help="estimate the normals of the normal loss and metric by kNN + "
                             "PCA from each cloud (the reference's estimator; the JAX "
                             "CLIs' MESHRCNN_FACE_NORMALS=0) instead of the sampled "
                             "triangles' own normals")


def capacities_of(options) -> CapacityConfig:
    return CapacityConfig(verts=options.vert_capacity, faces=options.face_capacity,
                          edges=options.edge_capacity)


def num_voxels_of(is_pix3d: bool) -> int:
    return 24 if is_pix3d else 48


def dataset_of(options, is_pix3d: bool, synthetic_size: int):
    """``--dataRoot``'s dataset: the synthetic one of ``synthetic_size`` samples
    (137x137 ShapeNet images, ``--img_size`` Pix3D ones, 32^3 grids), or the
    ShapeNet / Pix3D manifest under the root."""
    if options.dataRoot == "synthetic":
        return SyntheticDataset(n=synthetic_size,
                                image_size=options.img_size if is_pix3d else 137,
                                num_voxels=32, num_classes=10 if is_pix3d else 13,
                                pix3d=is_pix3d)
    classes = options.classes.split(",") if options.classes else None
    if is_pix3d:
        return pix3dDataset(options.dataRoot, classes)
    return shapeNet_Dataset(options.dataRoot, classes)


def model_settings(options, device: torch.device, **pix3d_sizes) -> dict:
    """The model config of the flags as a dict of primitives: what
    ``build_model`` reads and a checkpoint records. ``pix3d_sizes`` are the
    Pix3D RPN and RoI sizes the CLI sets (``rpn_pre_nms_top_n``, ``roi_batch_size``)."""
    is_pix3d = options.model == "Pix3D"
    settings = {"model": options.model, "num_classes": 10 if is_pix3d else 13,
                "cubify_threshold": options.threshold,
                "vertex_feature_dim": options.featDim,
                "num_refinement_stages": options.num_refinement_stages,
                "voxel_only": options.voxel_only,
                "vert_capacity": options.vert_capacity,
                "face_capacity": options.face_capacity,
                "edge_capacity": options.edge_capacity,
                "backbone_dtype": resolve_backbone_dtype(options.backbone_dtype, device)}
    if is_pix3d:
        settings.update(rpn_post_nms_top_n=options.rpn_post_nms_top_n,
                        mesh_feature_norm=options.mesh_feature_norm, **pix3d_sizes)
    else:
        settings["residual"] = options.residual
    return settings


def build_model(settings: dict, device: torch.device) -> ShapeNetModel | Pix3DModel:
    """The model of ``settings`` on ``device``, its flax initialisation
    (``models/init.py``) drawn from torch's global generator."""
    kwargs = {k: v for k, v in settings.items() if k != "model"}
    cls = Pix3DModel if settings["model"] == "Pix3D" else ShapeNetModel
    return cls(**kwargs).to(device)
