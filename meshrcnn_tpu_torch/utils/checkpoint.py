"""Checkpoints of the train state through ``torch.save``
(counterpart of meshrcnn_tpu/utils/checkpoint.py; reference:
utils/train_utils.py:11-30, train.py:186-223).

A checkpoint is one file holding plain data only, so ``torch.load`` reads it
with ``weights_only=True``: the model ``state_dict``, the optimizer's and the
schedule's state, the step count, the state of each rank's generator of the
step's uniform draws with the world size (one rank without data
parallelism), the optimizer's class name, and ``settings``, the model config
as a dict of primitives. The directory layout is the reference's:
``<root>/<Model>/GCN/<iso-date>/model_<epoch>.pt``
(``train_backbone`` writes under ``<root>/<Model>/backbone/<iso-date>/``).

Under data parallelism every rank holds the same model and optimizer state;
rank 0 writes the file while the others wait at a barrier, and every rank
loads it onto its own device and takes its own generator's state. A train
state with a generator resumes only at the world size that wrote it
(``WorldSizeError``): another would not continue each rank's stream.

Three settings change what the weights mean, and the loads check them against
the caller's config: ``mesh_feature_norm`` must agree (else both loads raise;
the JAX checkpoint does not record it and loads it silently),
``voxel_only`` must agree for ``load_state`` (a voxel-only checkpoint goes
into a full model through ``load_state_partial``), and a ``backbone_dtype``
that differs only prints a warning, since the weights are stored in float32
either way.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from meshrcnn_tpu_torch.parallel import distributed
from meshrcnn_tpu_torch.parallel.train_step import TrainState


class WorldSizeError(Exception):
    """A checkpoint's generators are of another number of ranks than this run's."""


def checkpoint_dir(root: str, model_name: str, kind: str = "GCN") -> str:
    """<root>/<Model>/<kind>/<iso-date>/, made if missing (reference:
    train.py:186-192); ``kind`` is "GCN", or "backbone" for ``train_backbone``."""
    path = os.path.join(root, model_name, kind, datetime.date.today().isoformat())
    os.makedirs(path, exist_ok=True)
    return path


def _generator_states(generator: Optional[torch.Generator], device) -> Optional[list]:
    """Every rank's generator state, in rank order (None without a generator)."""
    if generator is None:
        return None
    state = generator.get_state()
    if distributed.world() == 1:
        return [state]
    rows = distributed.gather_batch(state.to(device, torch.int64)[None])
    return [row.to("cpu", torch.uint8) for row in rows]


def save_state(state: TrainState, path: str, settings: dict,
               step: Optional[int] = None) -> str:
    """Write ``state`` to ``<path>[_<step>].pt``; returns the file's path.
    ``settings`` is the model config, a dict of primitives. Under data
    parallelism every rank calls it: rank 0 writes, the others wait."""
    path = os.path.abspath((path if step is None else f"{path}_{step}") + ".pt")
    device = next(state.model.parameters()).device
    generators = _generator_states(state.generator, device)
    if distributed.rank() == 0:
        torch.save({
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "optimizer_class": type(state.optimizer).__name__,
            "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
            "step": state.step,
            "generators": generators,
            "world_size": distributed.world(),
            "settings": dict(settings),
        }, path)
    if distributed.world() > 1:
        torch.distributed.barrier()
    return path


def _read(path: str, settings: dict) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    stored = ckpt["settings"]
    key = "mesh_feature_norm"
    if bool(stored.get(key, False)) != bool(settings.get(key, False)):
        raise ValueError(f"{path} was trained with {key}={stored.get(key, False)}, "
                         f"this model has {key}={settings.get(key, False)}")
    key = "backbone_dtype"
    if stored.get(key) != settings.get(key):
        print(f"warning: {path} was trained with {key} {stored.get(key)}, this model "
              f"computes in {settings.get(key)}; the weights are float32 either way")
    return ckpt


def load_state(path: str, state: TrainState, settings: dict) -> TrainState:
    """Restore a checkpoint of ``save_state`` into ``state`` in place, exactly:
    parameters, buffers, optimizer moments, schedule, step and generator.

    The optimizer keeps this run's hyperparameters, as the JAX optimizer, a
    function of the config, does; under a schedule its learning rate is the
    schedule's at the restored step. Under data parallelism each rank takes
    its own generator's state. Raises ValueError when the model config or the
    optimizer's structure differs, RuntimeError or KeyError when the model's
    state does not fit, and ``WorldSizeError`` when ``state`` has a generator
    and the checkpoint was written by another number of ranks."""
    ckpt = _read(path, settings)
    if state.generator is not None and ckpt["world_size"] != distributed.world():
        raise WorldSizeError(
            f"{path} was written by a run of {ckpt['world_size']} ranks, this run has "
            f"{distributed.world()}: each rank's stream of uniform draws continues only at "
            "the world size that wrote it")
    key = "voxel_only"
    if bool(ckpt["settings"].get(key, False)) != bool(settings.get(key, False)):
        raise ValueError(f"{path} has {key}={ckpt['settings'].get(key, False)}, this model "
                         f"{settings.get(key, False)}: load it with load_state_partial")
    if ckpt["optimizer_class"] != type(state.optimizer).__name__:
        raise ValueError(f"{path} holds a {ckpt['optimizer_class']} state, this run uses "
                         f"{type(state.optimizer).__name__}")
    if (ckpt["scheduler"] is None) != (state.scheduler is None):
        raise ValueError(f"{path} and this run differ in having a learning-rate schedule")
    state.model.load_state_dict(ckpt["model"], strict=True)
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(ckpt["optimizer"])
    for group, h in zip(state.optimizer.param_groups, hyper):
        group.update(h)
    if state.scheduler is not None:
        sched = state.scheduler
        sched.load_state_dict(ckpt["scheduler"])
        for group, base, fn in zip(state.optimizer.param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
            group["lr"] = base * fn(sched.last_epoch)
    state.step = int(ckpt["step"])
    if state.generator is not None and ckpt["generators"] is not None:
        state.generator.set_state(ckpt["generators"][distributed.rank()])
    return state


def load_state_partial(path: str, state: TrainState, settings: dict) -> Tuple[int, int]:
    """Merge the model entries of a checkpoint whose name and shape match into
    ``state.model``; the optimizer, step and generator keep their fresh state.

    The voxel-only -> full-model curriculum (reference: train.py:34-35), and
    the path for a model whose optimizer structure differs. Returns
    (parameters loaded, parameters of the model): a parameter whose shape
    differs, as at another ``--featDim``, counts as not loaded."""
    ckpt = _read(path, settings)
    target = state.model.state_dict()
    merged = {k: v for k, v in ckpt["model"].items()
              if k in target and v.shape == target[k].shape}
    state.model.load_state_dict(merged, strict=False)
    params = [k for k, _ in state.model.named_parameters()]
    return sum(k in merged for k in params), len(params)
