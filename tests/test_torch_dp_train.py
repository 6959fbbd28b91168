"""The port's data-parallel ShapeNet train step (``make_dp_train_step``, two
gloo ranks spawned on the CPU by ``tests/torch_dp_ranks.py``) against the JAX
package's ``make_dp_train_step`` on a 2-device CPU mesh, at the tiny model of
``__graft_entry__`` (48x48 images, capacities 512/1024/2048, float32
backbone), a global batch of 4 (2 a rank), 256-point clouds and the bench
recipe (Adam lr 1e-4, frozen backbone, weights voxel 1 / chamfer 1 / normal 0
/ edge 0.5). The residual model runs the same checks in
tests/test_torch_dp_train_residual.py, the Pix3D model in
tests/test_torch_dp_pix3d_train.py; the checks live here.

Each rank replays JAX's per-shard draws, ``train_step_draws(fold_in(key,
rank))`` (the DP step folds the axis index into its key). Held over 3 steps:
  * the two ranks' parameters, buffers, optimizer state and metrics equal in
    every bit after every step;
  * the metrics, parameters and BN statistics within ``NOISE_FACTOR`` times
    JAX's own spread plus ``FLOOR`` of scale, the rule of
    tests/test_torch_train_step.py (in train mode the tiny model amplifies
    float32 rounding ~1e4-fold: a 1e-6 change of the input moves the stage-2
    vertices of the residual model by up to 1 on a scale of 17), the spread
    being the largest distance to JAX's run from a first batch changed by
    1e-6 (``torch_parity.nudged_images``, nine changes), and every parameter
    within 2 lr a step taken (Adam's first update is ~lr sign(g));
  * against a one-process emulation (``torch_dp_ranks.emulate_dp_steps``:
    per-shard losses and gradients averaged, BN statistics averaged, then
    the optimizer): 1e-6 relative.
A fourth step puts a NaN in rank 1's rows: both ranks read ``grads_finite``
0 and keep parameters, optimizer state and buffers, as JAX's DP step does on
the same batch. The estimator (``face_normals=False``, normal weight 0.1, 1100
points, so K3's twin picks the candidates) runs one DP step against the
emulation. Each JAX program is built once for the module.
"""
import functools

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from meshrcnn_tpu.core.config import LossWeights as JaxLossWeights
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from tests import torch_dp_ranks
from tests.torch_parity import (host_batch, jax_dp_train_run, rel_err, train_step_draws,
                                within_spread)

WORLD = 2
B = 4                   # the global batch
PCS = 256
LR = 1e-4
NOISE_FACTOR = 4.0
FLOOR = 1e-4
KEYS = [jax.random.PRNGKey(i) for i in (1, 2, 3, 4)]
WEIGHTS = dict(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5)
CONFIG = dict(optimizer="adam", lr=LR, weight_decay=0.0, batch_size=B, point_cloud_size=PCS,
              normal_k=10, distance_tile=2048, train_backbone=False)
STEPS = 3


def port_model(residual: bool) -> functools.partial:
    return functools.partial(ShapeNetModel, num_classes=13, residual=residual,
                             cubify_threshold=0.2, voxel_out_channels=8, vert_capacity=512,
                             face_capacity=1024, edge_capacity=2048, num_refinement_stages=3)


def nan_batch(batch):
    images = np.array(batch.images)
    images[B // WORLD, 0, 0, 0] = np.nan          # the first row of rank 1
    return batch.replace(images=images)


@functools.lru_cache(maxsize=None)
def jax_run(residual: bool) -> dict:
    """JAX's DP program: 3 steps and, without residual refinement, the NaN step."""
    jcfg = JaxTrainConfig(loss_weights=JaxLossWeights(**WEIGHTS), **CONFIG)
    jm = graft._tiny_model().clone(backbone_dtype="float32", residual=residual)
    batch = graft._tiny_batch(B)
    ref = jax_dp_train_run(jm, jcfg, batch, port_model(residual)(), KEYS, STEPS, WORLD,
                           last=None if residual else nan_batch(batch))
    return dict(ref, batch=batch)


def shapenet_job(residual: bool) -> dict:
    """The port's DP train job of ``jax_run(residual)``: same weights, batches
    and per-rank draws."""
    ref = jax_run(residual)
    batches = [host_batch(ref["batch"])] * STEPS
    if not residual:
        batches.append(host_batch(nan_batch(ref["batch"])))
    return dict(kind="train", model=port_model(residual), state_dict=ref["sd0"],
                config=TrainConfig(loss_weights=LossWeights(**WEIGHTS), **CONFIG),
                batches=batches,
                draws={r: [d for k in KEYS[:len(batches)]
                           for d in train_step_draws(jax.random.fold_in(k, r), B // WORLD, PCS)]
                       for r in range(WORLD)})


def _estimator_job() -> dict:
    """One DP step of the kNN + PCA estimator at 1100 points (K3's twin)."""
    ref = jax_run(False)
    rng = np.random.RandomState(5)
    draws = {r: [rng.rand(B // WORLD, 1100).astype(np.float32) for _ in range(18)]
             for r in range(WORLD)}
    config = TrainConfig(loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.1,
                                                  edge=0.5),
                         face_normals=False, **dict(CONFIG, point_cloud_size=1100,
                                                    weight_decay=5e-6))
    return dict(kind="train", model=port_model(False), state_dict=ref["sd0"], config=config,
                batches=[host_batch(ref["batch"])], draws=draws)


def run_jobs(jobs: dict, tmp_path) -> dict:
    """Every job on two gloo ranks in one spawn, and each job's emulation."""
    ranks = torch_dp_ranks.run(list(jobs.values()), tmp_path, WORLD)
    return {name: dict(ranks=[r[i] for r in ranks], job=job,
                       emulated=torch_dp_ranks.emulate_dp_steps(job, WORLD))
            for i, (name, job) in enumerate(jobs.items())}


def check_ranks_equal(run: dict) -> None:
    """Rank 0 and rank 1 after every step: metrics, parameters, buffers and
    optimizer state equal in every bit."""
    r0, r1 = run["ranks"]
    assert r0["step"] == r1["step"] == len(run["job"]["batches"])
    for i in range(r0["step"]):
        assert set(r0["metrics"][i]) == set(r1["metrics"][i])
        for k, v in r0["metrics"][i].items():
            assert np.array_equal(v, r1["metrics"][i][k], equal_nan=True), (i, k)
        for what in ("states", "optimizer"):
            a, b = r0[what][i], r1[what][i]
            assert set(a) == set(b)
            for k in a:
                assert np.array_equal(a[k], b[k]), (i, what, k)


def check_emulation(run: dict) -> None:
    """Rank 0 against the one-process emulation: 1e-6 relative."""
    got, want = run["ranks"][0], run["emulated"]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(gm) == set(wm)
        for k in wm:
            if np.isnan(wm[k]):
                assert np.isnan(gm[k]), (i, k)
            else:
                assert rel_err(gm[k], wm[k]) <= 1e-6, (i, k, gm[k], wm[k])
        for k, v in want["states"][i].items():
            assert rel_err(got["states"][i][k], v) <= 1e-6, (i, k)
    assert want["metrics"][0]["grads_finite"] == 1.0


def check_metrics_against_jax(got: dict, ref: dict, i: int, keys=None) -> None:
    """Step i's metrics (``keys``, default all) within NOISE_FACTOR times JAX's
    spread plus FLOOR of scale. ``overflow`` counts the vertices past
    cubify's capacity, a sum of threshold decisions: a voxel within rounding
    of the threshold may cross it, and one crossing moves the count by a few
    vertices, so its floor is 1e-3 of it."""
    gm, wm = got["metrics"][i], ref["metrics"][i]
    assert set(gm) == set(wm)
    assert gm["grads_finite"] == float(wm["grads_finite"]) == 1.0
    for k in sorted(keys or wm):
        spread = max(abs(float(n[0][i][k]) - float(wm[k])) for n in ref["nudged"])
        floor = 1e-3 if k == "overflow" else FLOOR
        tol = NOISE_FACTOR * spread + floor * max(abs(float(wm[k])), 1.0)
        assert abs(gm[k] - float(wm[k])) <= tol, (i, k, gm[k], wm[k], spread)


def check_shapenet_step(run: dict, ref: dict, i: int, mesh_branch: bool = True) -> None:
    """Step i of the port's DP step against JAX's ``make_dp_train_step``.
    Without ``mesh_branch`` the mesh losses and the refine stages' parameters
    are held only within 2 lr a step (see tests/test_torch_dp_train_residual.py)."""
    got = run["ranks"][0]
    check_metrics_against_jax(got, ref, i, None if mesh_branch else ("voxel_loss", "overflow"))
    state, want = got["states"][i], ref["states"][i]
    nudged = [n[1][i] for n in ref["nudged"]]
    stats = [k for k in want if "running_" in k]
    params = [k for k in want if "running_" not in k and "num_batches" not in k
              and (mesh_branch or not k.startswith("refine"))]
    within_spread(state, want, nudged, stats, "BN statistics", NOISE_FACTOR, FLOOR)
    within_spread(state, want, nudged, params, "parameters", NOISE_FACTOR, FLOOR)
    params = [k for k in want if "running_" not in k and "num_batches" not in k]
    for k in params:
        assert np.abs(state[k] - want[k]).max() <= 2 * LR * (i + 1) * 1.001, k
    assert all(np.array_equal(state[k], ref["sd0"][k]) for k in params
               if k.startswith("backbone."))
    assert any(not np.array_equal(state[k], ref["sd0"][k]) for k in params
               if k.startswith("refine0."))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs({"plain": shapenet_job(False), "estimator": _estimator_job()},
                    tmp_path_factory.mktemp("dp_train"))


@pytest.mark.parametrize("name", ["plain", "estimator"])
def test_ranks_equal_in_every_bit(runs, name):
    check_ranks_equal(runs[name])


@pytest.mark.parametrize("name", ["plain", "estimator"])
def test_dp_steps_match_one_process_emulation(runs, name):
    check_emulation(runs[name])
    if name == "estimator":
        assert runs[name]["emulated"]["metrics"][0]["normal_loss"] < 0.0


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_step_matches_jax(runs, i):
    check_shapenet_step(runs["plain"], jax_run(False), i)


def test_nonfinite_shard_skips_on_every_rank(runs):
    """A NaN in rank 1's rows: the reduced loss is NaN on both ranks, both
    skip, and parameters, optimizer state and buffers stay as they were, as
    in JAX's DP step on the same batch."""
    ref = jax_run(False)
    assert float(ref["metrics"][STEPS]["grads_finite"]) == 0.0
    for k, v in ref["states"][STEPS].items():
        assert np.array_equal(v, ref["states"][STEPS - 1][k]), k
    for rank in runs["plain"]["ranks"]:
        assert rank["metrics"][STEPS]["grads_finite"] == 0.0
        assert np.isnan(rank["metrics"][STEPS]["loss"])
        for what in ("states", "optimizer"):
            before, after = rank[what][STEPS - 1], rank[what][STEPS]
            for k in before:
                assert np.array_equal(before[k], after[k]), (what, k)
