"""The port's reference-style Pix3D API (``meshrcnn_tpu_torch/models/api.py``)
against the JAX package's, at tests/test_pix3d.py's tiny configuration (B=2,
64x64 images, RPN 64 / 32, 32 sampled RoIs and 8 mask RoIs an image,
capacities 256/512/1024, 128-point clouds), RoIAlign by corner gathers on the
JAX side (``MESHRCNN_MATMUL_ROIALIGN=0``, the port's form).

Weights: the JAX API's initial state, carried into the port by ``load_flax``.
Both APIs take the detection stack's dtype among their model keywords:
float32 for the tight comparisons, the default bfloat16 for the loose one.

Tolerances and why (as tests/test_torch_pix3d.py and test_torch_pix3d_train.py):
  * float32 eval dict: validity, labels, counts and the ragged topology
    exact; boxes within 1e-3 px; scores, mask probabilities and voxels 1e-4
    relative; stage vertices 5e-4 relative (the JAX neighbour sums);
  * bfloat16 eval dict: valid detections, scores and voxels within 5e-2 of
    scale where the two agree on validity, the bound of chip_smoke.py's
    bfloat16 FPN check;
  * float32 train-mode losses against JAX's ``pix3d_loss_fn`` on the same
    draws: each within 4x JAX's own spread (the largest change of four 1e-6
    input changes) plus 1e-4 of scale, the cubify overflow count too (it
    moves by tens of vertices under those changes, as in
    tests/test_torch_pix3d_train.py);
  * within the port: ``step()`` equal in every bit to ``make_train_step``,
    every parameter and buffer unchanged by the train-mode call.
"""
import os

import jax
import numpy as np
import pytest
import torch

from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.models.api import Pix3DAPI as JaxPix3DAPI
from meshrcnn_tpu.parallel.train_step import pix3d_loss_fn as jax_pix3d_loss_fn
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.models.api import Pix3DAPI
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_train_step)
from meshrcnn_tpu_torch.utils.checkpoint import save_state
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import (Replay, host_batch, load_flax, nudged_images,
                                pix3d_train_step_draws, rel_err)

B = 2
PCS = 128
KEY = jax.random.PRNGKey(6)
ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
PROPOSALS = TINY["rpn_post_nms_top_n"] + 1
CONFIG = dict(optimizer="sgd", pix3d_schedule=True, train_backbone=True, point_cloud_size=PCS,
              normal_k=4, distance_tile=32)
NOISE_FACTOR = 4.0
FLOOR = 1e-4
BF16_BOUND = 5e-2
LOSSES = ("voxel_loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss_mask", "backbone_loss", "chamfer_loss", "normal_loss",
          "edge_loss", "overflow")


def _draws(key):
    return pix3d_train_step_draws(key, B, ANCHORS, PROPOSALS, TINY["roi_batch_size"], PCS)


def _port_api(variables, dtype: str) -> Pix3DAPI:
    api = Pix3DAPI(config=TrainConfig(**CONFIG), device="cpu", backbone_dtype=dtype, **TINY)
    load_flax(api.model, variables)
    return api


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
        batch = tiny_batch(B)
        jcfg = JaxTrainConfig(**CONFIG)
        jf = JaxPix3DAPI(config=jcfg, backbone_dtype="float32", **TINY)
        jf._ensure_state(batch.images)
        jb = JaxPix3DAPI(config=jcfg, **TINY)
        jb.state = jf.state
        s = jf.state
        loss = jax.jit(lambda im, k: jax_pix3d_loss_fn(
            jf.model, jcfg, s.params, s.batch_stats, batch.replace(images=im), k)[1][0])
        out = dict(batch=batch, variables={"params": s.params, "batch_stats": s.batch_stats},
                   f32=jf.eval()(batch.images), bf16=jb.eval()(batch.images),
                   losses=jax.device_get(loss(batch.images, KEY)))
        out["nudged"] = [jax.device_get(loss(x, KEY))
                         for x in list(nudged_images(batch.images, seeds=(0, 1, 2)))]
    return out


def test_eval_dict_matches_jax_in_float32(run):
    got = _port_api(run["variables"], "float32").eval()(run["batch"].images)
    want = run["f32"]
    assert set(got) == set(want)
    assert len(got["backbone"]) == len(want["backbone"]) == B
    for g, w in zip(got["backbone"], want["backbone"]):
        assert set(g) == set(w) == {"boxes", "labels", "scores", "valid", "masks"}
        np.testing.assert_array_equal(g["valid"], w["valid"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
        assert rel_err(g["scores"], w["scores"]) < 1e-4
        assert rel_err(g["masks"], w["masks"]) < 1e-4
    assert rel_err(got["voxels"].numpy(), want["voxels"]) < 1e-4
    assert got["mesh_index"] == want["mesh_index"] and sum(got["mesh_index"]) > 0
    for k in ("vertice_index", "face_index"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_array_equal(got["edge_index"], want["edge_index"])
    for a, b in zip(got["vertex_positions"], want["vertex_positions"]):
        assert rel_err(a, b) < 5e-4


def test_eval_dict_matches_jax_in_bfloat16(run):
    got = _port_api(run["variables"], "bfloat16").eval()(run["batch"].images)
    want = run["bf16"]
    assert set(got) == set(want)
    for g, w in zip(got["backbone"], want["backbone"]):
        both = g["valid"] & w["valid"]
        assert both.any()
        assert rel_err(g["scores"][both], w["scores"][both]) < BF16_BOUND
    assert rel_err(got["voxels"].numpy(), want["voxels"]) < BF16_BOUND


def test_train_mode_losses_match_jax_and_leave_the_model_unchanged(run):
    api = _port_api(run["variables"], "float32").train()
    before = {k: v.clone() for k, v in api.model.state_dict().items()}
    api.uniform = Replay(_draws(KEY))
    got = api(run["batch"].images, host_batch(run["batch"]))
    assert not api.uniform.draws
    want = run["losses"]
    assert set(got) == set(want) - {"loss"}
    for k in LOSSES:
        spread = max(abs(float(n[k]) - float(want[k])) for n in run["nudged"])
        tol = NOISE_FACTOR * spread + FLOOR * max(abs(float(want[k])), 1.0)
        assert abs(float(got[k]) - float(want[k])) <= tol, (k, got[k], want[k], spread)
    after = api.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in api.model.parameters())


def test_step_equals_make_train_step_in_every_bit(run):
    batch = host_batch(run["batch"])
    api = _port_api(run["variables"], "float32").train()
    api.uniform = Replay(_draws(KEY))
    got = api.step(batch.images, batch)
    assert api.state.step == 1
    other = _port_api(run["variables"], "float32")
    cfg = TrainConfig(**CONFIG)
    want = make_train_step(cfg, Replay(_draws(KEY)))(create_train_state(other.model, cfg),
                                                     Batch.from_host(batch, "cpu"))
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    a, b = api.model.state_dict(), other.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert api.state.optimizer.param_groups[0]["lr"] == pytest.approx(0.002 + 0.018 / 1000)


def test_load_before_any_forward_and_mode_errors(run, tmp_path):
    src = _port_api(run["variables"], "float32")
    path = save_state(create_train_state(src.model, src.config), str(tmp_path / "ck"),
                      src.settings)
    fresh = Pix3DAPI(config=TrainConfig(**CONFIG), device="cpu", seed=3,
                     backbone_dtype="float32", **TINY).load(path)
    a, b = fresh.model.state_dict(), src.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    got, want = fresh.eval()(run["batch"].images), src.eval()(run["batch"].images)
    assert torch.equal(got["voxels"], want["voxels"])
    assert got["mesh_index"] == want["mesh_index"]
    os.remove(path)                  # a ResNet-50 FPN model
    batch = host_batch(run["batch"])
    with pytest.raises(RuntimeError):
        fresh.step(batch.images, batch)
    fresh.train()
    with pytest.raises(ValueError):
        fresh(batch.images)
