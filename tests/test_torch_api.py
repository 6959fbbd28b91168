"""The port's reference-style ShapeNet API (``meshrcnn_tpu_torch/models/api.py``)
against the JAX package's, at tests/test_api.py's tiny sizes (48x48 images,
``voxel_out_channels=8``, capacities 512/1024/2048, 64-point clouds, B=2).

Weights: the JAX API's initial state, carried into the port by ``load_flax``.
The APIs compute their backbones in bfloat16, the JAX models' default; the
float32 comparisons swap each API's ``model`` for a float32 one before any
call (on the JAX side its eval step too, which closes over the model).

Tolerances and why:
  * ``to_ragged``: equal in every bit (the same numpy operations);
  * eval dicts in float32: softmax and voxels 1e-4 relative, the ragged
    topology (faces, edge_index, counts) exact, stage vertices 5e-4 relative
    (tests/test_torch_slice.py: the JAX neighbour sums cancel to ~1e-4);
  * eval dicts in bfloat16: softmax and voxels within 5e-2 of scale, the
    bound chip_smoke.py holds the bfloat16 FPN to (bfloat16 keeps 8 bits; the
    two packages round their convolutions' partial sums differently);
  * the train-mode loss dict in float32 against JAX's ``shapenet_loss_fn``
    on the same draws: the overflow count exact, each loss within 4x JAX's
    own spread (its loss on images scaled by 1 + 1e-6) plus 1e-4 of scale,
    as tests/test_torch_train_step.py holds a step's metrics (BatchNorm over
    eight values at c5 makes the train-mode model ill-conditioned);
  * within the port: ``step()`` equal in every bit to ``make_train_step`` on
    the same state and draws, the train-mode call's losses equal in every bit
    to a step's metrics, every parameter and buffer unchanged by it.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.models.api import ShapeNetAPI as JaxShapeNetAPI
from meshrcnn_tpu.models.api import to_ragged as jax_to_ragged
from meshrcnn_tpu.models.shapenet import ShapeNetModel as JaxShapeNetModel
from meshrcnn_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from meshrcnn_tpu.parallel.train_step import shapenet_loss_fn as jax_shapenet_loss_fn
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.models.api import ShapeNetAPI, to_ragged
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_train_step)
from meshrcnn_tpu_torch.utils.checkpoint import save_state
from tests.test_train_step import tiny_batch
from tests.torch_parity import Replay, host_batch, load_flax, rel_err, train_step_draws

B = 2
PCS = 64
TINY = dict(vert_capacity=512, face_capacity=1024, edge_capacity=2048, voxel_out_channels=8)
CONFIG = dict(point_cloud_size=PCS, normal_k=4, distance_tile=32)
KEY = jax.random.PRNGKey(3)
NOISE_FACTOR = 4.0
FLOOR = 1e-4
BF16_BOUND = 5e-2
LOSSES = ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss")


def _f32_port_model() -> ShapeNetModel:
    return ShapeNetModel(num_classes=13, cubify_threshold=0.2, num_refinement_stages=3,
                         backbone_dtype="float32", **TINY)


def _port_api(variables, float32: bool) -> ShapeNetAPI:
    api = ShapeNetAPI(config=TrainConfig(**CONFIG), device="cpu", **TINY)
    if float32:
        api.model = _f32_port_model()
    load_flax(api.model, variables)
    return api


@pytest.fixture(scope="module")
def run():
    batch = tiny_batch()
    jcfg = JaxTrainConfig(**CONFIG)
    japi = JaxShapeNetAPI(config=jcfg, **TINY)
    japi._ensure_state(batch.images)
    jf = JaxShapeNetAPI(config=jcfg, **TINY)
    jf.model = JaxShapeNetModel(num_classes=13, cubify_threshold=0.2, num_refinement_stages=3,
                                vert_capacity=512, face_capacity=1024, edge_capacity=2048,
                                voxel_out_channels=8, backbone_dtype="float32")
    jf._eval_step = jax_make_eval_step(jf.model)
    jf.state = japi.state
    variables = {"params": japi.state.params, "batch_stats": japi.state.batch_stats}
    loss = jax.jit(lambda p, bs, b, k: jax_shapenet_loss_fn(jf.model, jcfg, p, bs, b, k)[1][0])
    return dict(
        batch=batch, variables=variables,
        bf16=japi.eval()(batch.images), f32=jf.eval()(batch.images),
        losses=jax.device_get(loss(japi.state.params, japi.state.batch_stats, batch, KEY)),
        losses_nudged=jax.device_get(loss(japi.state.params, japi.state.batch_stats,
                                          batch.replace(images=batch.images * (1.0 + 1e-6)),
                                          KEY)))


@pytest.mark.parametrize("with_valid", [False, True])
def test_to_ragged_equals_jax_in_every_bit(with_valid):
    rng = np.random.RandomState(7)
    S, V, F, E = 4, 20, 30, 40
    mesh = types.SimpleNamespace(
        verts_mask=rng.rand(S, V) > 0.3, faces_mask=rng.rand(S, F) > 0.4,
        edges_mask=rng.rand(S, E) > 0.5, faces=rng.randint(0, V, (S, F, 3)).astype(np.int32),
        edges=rng.randint(0, V, (S, E, 2)).astype(np.int32))
    stages = [rng.randn(S, V, 3).astype(np.float32) for _ in range(4)]
    valid = np.array([True, False, True, True]) if with_valid else None
    want = jax_to_ragged(stages, mesh, valid)
    got = to_ragged([torch.from_numpy(s) for s in stages],
                    types.SimpleNamespace(**{k: torch.from_numpy(v)
                                             for k, v in vars(mesh).items()}),
                    None if valid is None else torch.from_numpy(valid))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[3] == want[3] and got[4] == want[4]


def _check_ragged(got, want, vert_tol):
    for k in ("vertice_index", "face_index", "mesh_index"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["faces"], np.asarray(want["faces"]))
    np.testing.assert_array_equal(got["edge_index"], np.asarray(want["edge_index"]))
    assert len(got["vertex_positions"]) == 4
    for a, b in zip(got["vertex_positions"], want["vertex_positions"]):
        assert rel_err(a, b) < vert_tol


def test_eval_dict_matches_jax_in_float32(run):
    got = _port_api(run["variables"], float32=True).eval()(run["batch"].images)
    want = run["f32"]
    assert set(got) == set(want)
    assert rel_err(got["backbone"].numpy(), want["backbone"]) < 1e-4
    assert rel_err(got["voxels"].numpy(), want["voxels"]) < 1e-4
    _check_ragged(got, want, 5e-4)


def test_eval_dict_matches_jax_in_bfloat16(run):
    """The APIs' default backbone dtype, bfloat16, on both sides."""
    api = _port_api(run["variables"], float32=False)
    assert api.model.backbone.conv1.weight.dtype == torch.float32     # stored f32
    got = api.eval()(run["batch"].images)
    want = run["bf16"]
    assert set(got) == set(want)
    assert rel_err(got["backbone"].numpy(), want["backbone"]) < BF16_BOUND
    assert rel_err(got["voxels"].numpy(), want["voxels"]) < BF16_BOUND
    assert rel_err(got["voxels"].numpy(), run["f32"]["voxels"]) < BF16_BOUND
    np.testing.assert_allclose(got["backbone"].sum(-1).numpy(), 1.0, atol=1e-5)


def test_train_mode_losses_match_jax_and_leave_the_model_unchanged(run):
    api = _port_api(run["variables"], float32=True).train()
    before = {k: v.clone() for k, v in api.model.state_dict().items()}
    api.uniform = Replay(train_step_draws(KEY, B, PCS))
    got = api(run["batch"].images, host_batch(run["batch"]))
    assert not api.uniform.draws                       # every draw taken, in order
    want, nudged = run["losses"], run["losses_nudged"]
    assert set(got) == set(want) - {"loss"}
    assert float(got["overflow"]) == float(want["overflow"])
    for k in LOSSES:
        spread = abs(float(nudged[k]) - float(want[k]))
        tol = NOISE_FACTOR * spread + FLOOR * max(abs(float(want[k])), 1.0)
        assert abs(float(got[k]) - float(want[k])) <= tol, (k, got[k], want[k], spread)
    after = api.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)     # BN buffers included
    assert int(after["backbone.bn1.num_batches_tracked"]) == 0
    assert all(p.grad is None for p in api.model.parameters())
    assert all(not v.requires_grad for v in got.values())


def test_step_equals_make_train_step_in_every_bit(run):
    batch = host_batch(run["batch"])
    draws = [d for k in (KEY, jax.random.PRNGKey(4)) for d in train_step_draws(k, B, PCS)]
    api = _port_api(run["variables"], float32=True).train()
    api.uniform = Replay(draws)
    got = [api.step(batch.images, batch) for _ in range(2)]
    assert api.state.step == 2

    model = load_flax(_f32_port_model(), run["variables"])
    cfg = TrainConfig(**CONFIG)
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, Replay(draws))
    want = [step(state, Batch.from_host(batch, "cpu")) for _ in range(2)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert all(torch.equal(g[k], w[k]) for k in g)
    a, b = api.model.state_dict(), model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sd0 = load_flax(_f32_port_model(), run["variables"]).state_dict()
    assert not torch.equal(a["refine0.graphConv0.w0.weight"], sd0["refine0.graphConv0.w0.weight"])

    # the train-mode call on the state a step starts from gives that step's metrics
    api2 = _port_api(run["variables"], float32=True).train()
    api2.uniform = Replay(draws[:len(draws) // 2])
    losses = api2(batch.images, batch)
    assert all(torch.equal(losses[k], got[0][k]) for k in losses)


def test_load_before_any_forward(run, tmp_path):
    src = _port_api(run["variables"], float32=False)
    path = save_state(create_train_state(src.model, src.config), str(tmp_path / "ck"),
                      src.settings)
    fresh = ShapeNetAPI(config=TrainConfig(**CONFIG), device="cpu", seed=5, **TINY).load(path)
    a, b = fresh.model.state_dict(), src.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    got, want = fresh.eval()(run["batch"].images), src.eval()(run["batch"].images)
    assert torch.equal(got["voxels"], want["voxels"])
    for s, t in zip(got["vertex_positions"], want["vertex_positions"]):
        np.testing.assert_array_equal(s, t)
    os.remove(path)                  # a ResNet-50 model with its Adam moments


def test_mode_errors(run, monkeypatch):
    """As tests/test_api.py: step() in eval mode and a train-mode call without
    targets raise; and without a card the default device raises."""
    api = _port_api(run["variables"], float32=False)
    batch = host_batch(run["batch"])
    api.eval()
    with pytest.raises(RuntimeError):
        api.step(batch.images, batch)
    api.train()
    with pytest.raises(ValueError):
        api(batch.images)
    with pytest.raises(ValueError):
        api.step(batch.images, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ShapeNetAPI(**TINY)


def test_seed_sets_the_initial_weights_and_leaves_the_global_generator():
    state = torch.random.get_rng_state()
    a = ShapeNetAPI(device="cpu", seed=1, **TINY).model.state_dict()
    b = ShapeNetAPI(device="cpu", seed=1, **TINY).model.state_dict()
    c = ShapeNetAPI(device="cpu", seed=2, **TINY).model.state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["voxelBranch.deconv.weight"], c["voxelBranch.deconv.weight"])
