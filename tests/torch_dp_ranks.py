"""Rank side of the data-parallel parity tests (tests/test_torch_dp_*.py).

The tests spawn two gloo ranks on the CPU with ``run``; each rank runs a list
of jobs through the port and writes what it saw to ``<out>/rank<r>.pkl`` as
numpy. This module imports no JAX: the JAX references are computed in the
test process and reach the ranks as numpy arrays (weights, batches, replayed
draws). ``emulate_dp_steps`` is the one-process emulation the ranks are held
to: per-shard losses and gradients averaged, BN statistics averaged, then the
optimizer.
"""
from __future__ import annotations

import copy
import os
import pickle
from typing import Callable, Dict, List

import numpy as np
import torch

from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.parallel import distributed
from meshrcnn_tpu_torch.parallel.train_step import (Batch, _update, create_train_state,
                                                    make_dp_eval_step, make_dp_train_step,
                                                    make_eval_step, pix3d_loss_fn,
                                                    shapenet_loss_fn)


class Replay:
    """A ``uniform(shape)`` source that hands out recorded draws in order
    (``tests/torch_parity.Replay``, which imports JAX)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        x = self.draws.pop(0)
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        return torch.from_numpy(np.array(x, dtype=np.float32))


def state_numpy(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def optimizer_numpy(optimizer: torch.optim.Optimizer) -> Dict[str, np.ndarray]:
    out = {}
    for i, st in optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"{i}.{k}"] = np.array(v.numpy() if torch.is_tensor(v) else v)
    return out


def _train_job(job: dict, rank: int, world: int) -> dict:
    """``job``: ``model`` (a callable building the port model), ``state_dict``
    (numpy), ``config``, ``batches`` (global numpy batches, one a step) and
    ``draws`` (rank -> the rank's replayed draws of every step)."""
    model = job["model"]()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
    state = create_train_state(model, job["config"])
    step = make_dp_train_step(job["config"], Replay(job["draws"][rank]))
    out = {"metrics": [], "states": [], "optimizer": []}
    for batch in job["batches"]:
        m = step(state, Batch.from_host(distributed.shard_batch(batch, rank, world), "cpu"))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(state_numpy(model))
        out["optimizer"].append(optimizer_numpy(state.optimizer))
    out["step"] = state.step
    return out


def _eval_job(job: dict, rank: int, world: int) -> dict:
    """``job``: ``model``, ``state_dict`` and ``images`` (the global batch):
    the gathered output of ``make_dp_eval_step`` as numpy."""
    model = job["model"]()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
    images = distributed.shard_batch(job["batch"], rank, world).images
    out = make_dp_eval_step(model)(torch.from_numpy(np.array(images)))
    return {"out": tree_numpy(out)}


class NumpyUniform:
    """A ``uniform(shape)`` source of a numpy stream: two of one seed draw the same."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)

    def __call__(self, shape):
        return torch.from_numpy(self.rng.rand(*shape).astype(np.float32))


def _validate(job: dict, eval_step: Callable, shard_fn=None):
    from meshrcnn_tpu_torch.harness import validate, validate_pix3d
    fn = validate_pix3d if job["pix3d"] else validate
    return fn(eval_step, job["loader"], job["config"], job["num_classes"],
              NumpyUniform(job["seed"]), device="cpu", print_freq=10 ** 9, shard_fn=shard_fn)


def _validate_job(job: dict, rank: int, world: int) -> dict:
    """``job``: ``model``, ``state_dict``, ``loader`` (global numpy batches),
    ``config``, ``num_classes``, ``seed`` of the draws and ``pix3d``:
    ``validate`` or ``validate_pix3d`` with a ``shard_fn``; rank 0's metrics
    (None on the other ranks)."""
    model = job["model"]()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
    return {"results": _validate(job, make_dp_eval_step(model),
                                 lambda b: distributed.shard_batch(b, rank, world))}


def _resume_job(job: dict, rank: int, world: int) -> dict:
    """``job``: ``model``, ``state_dict``, ``config``, ``settings``, ``seed``,
    ``path`` and ``batches`` (3 global batches). Three DP steps from the
    rank's generator, and two, ``save_state``, a ``load_state`` into a fresh
    state (another generator seed) and the third: each run's final state and
    generator, and how often this rank called ``torch.save``."""
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.utils import checkpoint

    saves = []
    real_save = checkpoint.torch.save

    def counted(*args, **kwargs):
        saves.append(1)
        return real_save(*args, **kwargs)

    def fresh(seed):
        model = job["model"]()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
        gen = distributed.rank_generator(seed, rank, "cpu")
        return create_train_state(model, job["config"], gen)

    def steps(state, batches):
        step = make_dp_train_step(job["config"], uniform_from(state.generator))
        for batch in batches:
            step(state, Batch.from_host(distributed.shard_batch(batch, rank, world), "cpu"))

    def record(state):
        return dict(state=state_numpy(state.model), optimizer=optimizer_numpy(state.optimizer),
                    generator=state.generator.get_state().numpy(), step=state.step)

    whole = fresh(job["seed"])
    steps(whole, job["batches"])
    first = fresh(job["seed"])
    steps(first, job["batches"][:2])
    checkpoint.torch.save = counted
    try:
        path = checkpoint.save_state(first, job["path"], job["settings"])
    finally:
        checkpoint.torch.save = real_save
    resumed = checkpoint.load_state(path, fresh(job["seed"] + 7), job["settings"])
    steps(resumed, job["batches"][2:])
    return dict(whole=record(whole), resumed=record(resumed), saves=len(saves))


JOBS: Dict[str, Callable[[dict, int, int], dict]] = {
    "train": _train_job, "eval": _eval_job, "validate": _validate_job,
    "resume": _resume_job}


def _rank(rank: int, world: int, store: str, out: str, jobs: List[dict]) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", rank=rank, world_size=world,
                                         init_method=f"file://{store}")
    try:
        results = [JOBS[job["kind"]](job, rank, world) for job in jobs]
    finally:
        distributed.destroy()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run(jobs: List[dict], tmp_path, world: int = 2) -> List[List[dict]]:
    """Run ``jobs`` on ``world`` gloo ranks; returns each rank's results."""
    out = str(tmp_path)
    torch.multiprocessing.spawn(_rank, args=(world, os.path.join(out, "store"), out, jobs),
                                nprocs=world)
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def tree_numpy(tree):
    """An output dataclass tree with its tensors as numpy arrays."""
    import dataclasses
    if torch.is_tensor(tree):
        return tree.detach().numpy()
    if dataclasses.is_dataclass(tree):
        return {f.name: tree_numpy(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_numpy(x) for x in tree]
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    return tree


def emulate_dp_steps(job: dict, world: int = 2) -> dict:
    """The DP train job in one process: each step runs the loss and backward
    of every shard from the step's starting state with that rank's draws,
    then sets the gradients (zero where a parameter got none), the metrics
    and the BN running statistics to their means over the shards, and runs
    the optimizer unless the mean loss or a mean gradient is non-finite.
    One thread, as in the ranks."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = job["model"]()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
        config = job["config"]
        state = create_train_state(model, config)
        sources = [Replay(job["draws"][r]) for r in range(world)]
        loss_fn = pix3d_loss_fn if isinstance(model, Pix3DModel) else shapenet_loss_fn
        params = list(model.parameters())
        out = {"metrics": [], "states": []}
        for batch in job["batches"]:
            start = copy.deepcopy(model.state_dict())
            grads, stats, metrics = [], [], []
            for r in range(world):
                model.load_state_dict(start)
                model.train()
                for p in params:
                    p.grad = None
                shard = Batch.from_host(distributed.shard_batch(batch, r, world), "cpu")
                total, m = loss_fn(model, config, shard, sources[r])
                total.backward()
                grads.append([torch.zeros_like(p) if p.grad is None else p.grad for p in params])
                stats.append({k: v.clone() for k, v in model.state_dict().items()
                              if "running_" in k})
                metrics.append(m)
            model.load_state_dict(start)
            mean = {k: sum(m[k] for m in metrics) / world for k in metrics[0]}
            for i, p in enumerate(params):
                p.grad = sum(g[i] for g in grads) / world
            ok = bool(torch.isfinite(mean["loss"])) and all(
                bool(torch.isfinite(p.grad).all()) for p in params)
            if ok:
                sd = model.state_dict()
                for k in stats[0]:
                    sd[k].copy_(sum(s[k] for s in stats) / world)
                for k, v in sd.items():
                    if k.endswith("num_batches_tracked"):
                        v.add_(1)
                _update(state, config)
            mean["grads_finite"] = torch.tensor(float(ok))
            state.step += 1
            out["metrics"].append({k: float(v) for k, v in mean.items()})
            out["states"].append(state_numpy(model))
        return out
    finally:
        torch.set_num_threads(threads)


def eval_one_process(job: dict, chunks: int = 1):
    """``make_eval_step`` in this process (one thread) on the eval job's batch,
    in ``chunks`` equal forwards whose outputs are concatenated."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = job["model"]()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
        step = make_eval_step(model)
        outs = [tree_numpy(step(torch.from_numpy(np.array(
            distributed.shard_batch(job["batch"], c, chunks).images)))) for c in range(chunks)]
        return _concat(outs)
    finally:
        torch.set_num_threads(threads)


def _concat(trees: list):
    if isinstance(trees[0], dict):
        return {k: _concat([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_concat([t[i] for t in trees]) for i in range(len(trees[0]))]
    if isinstance(trees[0], np.ndarray):
        return np.concatenate(trees)
    return trees[0]


def validate_one_process(job: dict) -> dict:
    """The validate job's loop in this process, one thread, no ``shard_fn``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = job["model"]()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in job["state_dict"].items()})
        return _validate(job, make_eval_step(model))
    finally:
        torch.set_num_threads(threads)
