"""The port's data-parallel Pix3D train step (``make_dp_train_step``, two
gloo ranks) against the JAX package's ``make_dp_train_step`` on a 2-device
CPU mesh, at the tiny configuration of tests/test_pix3d.py (64x64 images, RPN
64 / 32, 32 sampled RoIs and 8 mask RoIs an image, capacities 256/512/1024,
float32 detection stack, RoIAlign by corner gathers on the JAX side), a global
batch of 4 (2 a rank), 512-point clouds and the bench recipe's SGD under the
Pix3D schedule, weight decay 1e-4, backbone trained, weights voxel 3 /
chamfer 1 / normal 0.1 / edge 0.5.

Each rank replays ``pix3d_train_step_draws(fold_in(key, rank))``: the RPN and
RoI samplers' uniforms, the mask loss's and the mesh losses'. Held over 3
steps, as tests/test_torch_dp_train.py holds ShapeNet: the ranks equal in
every bit; the metrics, each step's SGD update (the detection stack and the
mesh branch apart, the rule of tests/test_torch_pix3d_train.py) and the BN
statistics within 4x JAX's own spread plus 1e-4 of scale; the one-process
emulation at 1e-6. The JAX program is built once for the module.
"""
import functools

import jax
import numpy as np
import pytest

from meshrcnn_tpu.core.config import LossWeights as JaxLossWeights
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from tests import test_torch_dp_train as base
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import (host_batch, jax_dp_train_run, pix3d_train_step_draws,
                                within_spread)

WORLD = 2
B = 4
PCS = 512
STEPS = 3
KEYS = base.KEYS
ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)   # P2..P6 at 64x64
PROPOSALS = TINY["rpn_post_nms_top_n"] + 1              # RPN proposals + GT
CONFIG = dict(optimizer="sgd", lr=0.02, weight_decay=1e-4, batch_size=B, point_cloud_size=PCS,
              normal_k=4, distance_tile=32, train_backbone=True, pix3d_schedule=True)
WEIGHTS = dict(voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5)

port_model = functools.partial(Pix3DModel, backbone_dtype="float32", **TINY)


@pytest.fixture(scope="module")
def ref():
    """JAX's DP program over 3 steps, RoIAlign by corner gathers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
        jcfg = JaxTrainConfig(loss_weights=JaxLossWeights(**WEIGHTS), **CONFIG)
        jm = JaxPix3DModel(backbone_dtype="float32", **TINY)
        batch = tiny_batch(B)
        return dict(jax_dp_train_run(jm, jcfg, batch, port_model(), KEYS, STEPS, WORLD,
                                     seeds=range(3)), batch=batch)


@pytest.fixture(scope="module")
def run(ref, tmp_path_factory):
    draws = {r: [d for k in KEYS[:STEPS] for d in pix3d_train_step_draws(
        jax.random.fold_in(k, r), B // WORLD, ANCHORS, PROPOSALS, TINY["roi_batch_size"], PCS)]
        for r in range(WORLD)}
    job = dict(kind="train", model=port_model, state_dict=ref["sd0"],
               config=TrainConfig(loss_weights=LossWeights(**WEIGHTS), **CONFIG),
               batches=[host_batch(ref["batch"])] * STEPS, draws=draws)
    return base.run_jobs({"pix3d": job}, tmp_path_factory.mktemp("dp_pix3d_train"))["pix3d"]


def test_ranks_equal_in_every_bit(run):
    base.check_ranks_equal(run)


def test_dp_steps_match_one_process_emulation(run):
    base.check_emulation(run)


@pytest.mark.parametrize("i", range(STEPS))
def test_dp_step_matches_jax(ref, run, i):
    """Step i's metrics, SGD update of every parameter and BN statistics."""
    got = run["ranks"][0]
    base.check_metrics_against_jax(got, ref, i)
    before = ref["sd0"] if i == 0 else ref["states"][i - 1]
    port_before = ref["sd0"] if i == 0 else got["states"][i - 1]
    stats = [k for k in before if "running_" in k]
    params = [k for k in before if "running_" not in k and "num_batches" not in k]

    def update(after, start):
        return {k: after[k].astype(np.float64) - start[k] for k in params}
    want = update(ref["states"][i], before)
    nudged = [update(n[1][i], ref["sd0"] if i == 0 else n[1][i - 1]) for n in ref["nudged"]]
    for name, keys in (("detection stack", [k for k in params if k.startswith("backbone.")]),
                       ("mesh branch", [k for k in params if not k.startswith("backbone.")])):
        within_spread(update(got["states"][i], port_before), want, nudged, keys,
                      f"step {i} update, {name}")
        assert any(np.abs(want[k]).max() > 0.0 for k in keys)
    within_spread(got["states"][i], ref["states"][i], [n[1][i] for n in ref["nudged"]], stats,
                  f"step {i} BN statistics")
