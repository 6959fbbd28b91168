"""Parity rig shared by the tests/test_torch_*.py files.

Runs a JAX function and its counterpart in the PyTorch port on the same numpy
inputs: it reproduces the JAX package's ``jax.random`` draws so they can be
handed to the port, and carries flax parameters across with
``state_dict_from_jax``. Everything runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import types

import jax
import numpy as np
import torch

from meshrcnn_tpu_torch.utils.jax_params import state_dict_from_jax

# Under pytest-xdist each worker process would start one torch thread a core,
# and the workers' threads would spin against each other (a port test ran ~15x
# slower so): share the cores out between the workers. Every worker imports
# this module when it collects the tests.
_XDIST_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _XDIST_WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _XDIST_WORKERS))


def to_numpy_tree(tree):
    """A flax variable tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def state_dict_from_flax(module: torch.nn.Module, params, batch_stats=None) -> dict:
    """``module``'s state_dict of flax ``params`` / ``batch_stats`` trees (a
    gradient tree maps as a params tree: every layout change is linear)."""
    return state_dict_from_jax(module, to_numpy_tree(params),
                               to_numpy_tree(batch_stats or {}))


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax ``{"params": ..., "batch_stats": ...}`` into ``module`` (strict), eval mode."""
    sd = state_dict_from_flax(module, variables["params"], variables.get("batch_stats"))
    module.load_state_dict(sd, strict=True)
    return module.eval()


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def sampler_draws(key, B: int, n: int) -> list:
    """The (u, xi1, xi2) uniforms ``batched_sample_points`` draws from ``key``."""
    k_face, k1, k2 = jax.random.split(key, 3)
    return [np.asarray(jax.random.uniform(k, (B, n))) for k in (k_face, k1, k2)]


def train_step_draws(key, B: int, n: int, num_stages: int = 3) -> list:
    """Every uniform of ``batched_mesh_loss(key, ...)`` (the train step's), in
    the port's order: per stage fold_in(key, i) split into (pred, gt) clouds."""
    draws = []
    for i in range(num_stages):
        k_pred, k_gt = jax.random.split(jax.random.fold_in(key, i))
        draws += sampler_draws(k_pred, B, n) + sampler_draws(k_gt, B, n)
    return draws


def eval_metric_draws(key, B: int, n: int, num_stages: int = 3) -> list:
    """Every uniform of ``_shapenet_eval_metrics(key, ...)``, in the port's order:
    the train step's, then the F1 pair from fold_in(key, 7)."""
    draws = train_step_draws(key, B, n, num_stages)
    k_p, k_g = jax.random.split(jax.random.fold_in(key, 7))
    return draws + sampler_draws(k_p, B, n) + sampler_draws(k_g, B, n)


def pix3d_eval_metric_draws(key, B: int, D: int, n: int, ranked: bool = True,
                            num_stages: int = 3) -> list:
    """Every uniform of ``_pix3d_eval_metrics(key, ...)``, in the port's order:
    ``eval_metric_draws`` over the B best-IoU slots, then with ``ranked`` the
    B * D slots' pair from fold_in(key, 11)."""
    draws = eval_metric_draws(key, B, n, num_stages)
    if ranked:
        k_p, k_g = jax.random.split(jax.random.fold_in(key, 11))
        draws += sampler_draws(k_p, B * D, n) + sampler_draws(k_g, B * D, n)
    return draws


def sampler_pair_draws(key, B: int, n: int) -> list:
    """The two [B, n] uniforms of per-image ``balanced_sample`` calls under
    ``split(key, B)``: every image's positive scores, then every image's
    negative scores (each image splits its key into the two)."""
    pairs = [jax.random.split(k) for k in jax.random.split(key, B)]
    return [np.stack([np.asarray(jax.random.uniform(p[j], (n,))) for p in pairs])
            for j in (0, 1)]


def maskrcnn_train_draws(key, B: int, anchors: int, proposals: int, roi_batch: int) -> list:
    """Every uniform of the JAX ``Pix3DMaskRCNN`` in train mode with ``rng=key``,
    in the port's order: the RPN sampler's pair over ``anchors`` rows from
    fold_in(key, 3); the RoI sampler's pair over ``proposals`` rows (RPN
    proposals + GT boxes) from fold_in(key, 5); the mask loss's
    [B, roi_batch] from fold_in(fold_in(key, 5), 101)."""
    k_roi = jax.random.fold_in(key, 5)
    return (sampler_pair_draws(jax.random.fold_in(key, 3), B, anchors)
            + sampler_pair_draws(k_roi, B, proposals)
            + [np.asarray(jax.random.uniform(jax.random.fold_in(k_roi, 101), (B, roi_batch)))])


def pix3d_train_step_draws(key, B: int, anchors: int, proposals: int, roi_batch: int,
                           pcs: int, num_stages: int = 3) -> list:
    """Every uniform of the JAX ``pix3d_loss_fn(..., key)``, in the port's order:
    k_model, k_mesh = split(key); ``maskrcnn_train_draws`` of k_model, then the
    mesh losses' ``train_step_draws`` from k_mesh."""
    k_model, k_mesh = jax.random.split(key)
    return (maskrcnn_train_draws(k_model, B, anchors, proposals, roi_batch)
            + train_step_draws(k_mesh, B, pcs, num_stages))


class Replay:
    """A ``uniform(shape)`` source that hands out recorded draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        x = self.draws.pop(0)
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        return torch.from_numpy(np.array(x, dtype=np.float32))


def rel_err(got, want) -> float:
    """max |got - want| / max(max |want|, 1)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def host_batch(batch) -> types.SimpleNamespace:
    """A JAX batch as numpy arrays, which spawned ranks read without JAX."""
    return types.SimpleNamespace(**{f.name: np.asarray(getattr(batch, f.name))
                                    for f in dataclasses.fields(batch)
                                    if getattr(batch, f.name) is not None})


def nudged_images(images, seeds=range(8)):
    """1e-6 changes of the input that measure a train-mode result's own
    spread: scaled by 1 + 1e-6, and pixel by pixel by 1 + 1e-6 u for uniforms
    u in [-1, 1] of each seed. One change alone may move a result 100 times
    less than another (BatchNorm cancels a uniform scale)."""
    images = np.asarray(images)
    yield images * np.float32(1.0 + 1e-6)
    for seed in seeds:
        u = np.random.RandomState(seed).uniform(-1.0, 1.0, images.shape).astype(np.float32)
        yield images * (1.0 + 1e-6 * u)


def jax_dp_train_run(jm, jcfg, batch, template: torch.nn.Module, keys, steps: int,
                     world: int = 2, last=None, seeds=range(8)) -> dict:
    """JAX ``make_dp_train_step`` of ``jm`` on a ``world``-device CPU mesh:
    ``steps`` steps on ``batch`` with ``keys``, then one on ``last`` if given
    (key ``keys[steps]``); the same ``steps`` from each ``nudged_images``
    first batch. State and batches are placed on the mesh first, so that the
    program compiles once. Every state as numpy keyed like ``template``'s
    state_dict."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from meshrcnn_tpu.parallel import train_step as jts
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    state0 = jax.device_put(jts.create_train_state(jm, jcfg, jax.random.PRNGKey(0),
                                                   batch.images),
                            NamedSharding(mesh, PartitionSpec()))
    step = jts.make_dp_train_step(jm, jcfg, mesh)

    def sd(s):
        return {k: v.numpy() for k, v in state_dict_from_flax(template, s.params,
                                                              s.batch_stats).items()}

    def run(first):
        s, metrics, states = state0, [], []
        for i in range(steps):
            s, m = step(s, jts.shard_batch(first if i == 0 else batch, mesh), keys[i])
            metrics.append(jax.device_get(m))
            states.append(sd(s))
        return s, metrics, states

    s, metrics, states = run(batch)
    if last is not None:
        s, m = step(s, jts.shard_batch(last, mesh), keys[steps])
        metrics.append(jax.device_get(m))
        states.append(sd(s))
    nudged = [run(batch.replace(images=x))[1:] for x in nudged_images(batch.images, seeds)]
    return dict(sd0=sd(state0), metrics=metrics, states=states, nudged=nudged)


def tree_distance(a: dict, b: dict, keys) -> float:
    return float(np.sqrt(sum(((np.asarray(a[k], np.float64) - b[k]) ** 2).sum()
                             for k in keys)))


def within_spread(got: dict, want: dict, nudged: list, keys, what: str,
                  factor: float = 4.0, floor: float = 1e-4) -> None:
    """|got - want| <= factor max |nudged - want| + floor * scale, over the keys' tree."""
    d = tree_distance(got, want, keys)
    spread = max(tree_distance(n, want, keys) for n in nudged)
    scale = tree_distance(want, {k: np.zeros_like(want[k]) for k in keys}, keys)
    assert d <= factor * spread + floor * max(scale, 1.0), (what, d, spread, scale)
