"""The port's Pix3D train step against the JAX package's ``make_train_step``, at
the tiny configuration of tests/test_pix3d.py (B=2, 64x64 images, RPN 64 / 32,
32 sampled RoIs and 8 mask RoIs an image, capacities 256/512/1024), float32
detection stack on both sides, the bench recipe's optimizer and weights (SGD,
lr 0.02 under the Pix3D schedule, weight decay 1e-4, backbone trained, voxel 3
/ chamfer 1 / normal 0.1 / edge 0.5), draws replayed by
``torch_parity.pix3d_train_step_draws``.

Tolerances and why. In train mode this model is ill-conditioned: BatchNorm
over a batch of two images, the RPN's proposals (a change of 1e-4 in a delta
moves a 512-px anchor's box by 0.05 px), matches at IoU 0.5, the best-IoU
slot, and cubify at a capacity of 256 vertices (which vertices are kept
changes with the voxels near the threshold). A change of 1e-6 in the input
images moves JAX's own losses by up to ~1e-3 relative. So each quantity is
held within ``NOISE_FACTOR`` times JAX's own spread, the largest distance
between JAX's result and JAX's result on images changed by 1e-6 (scaled by
1 + 1e-6, and multiplied pixel by pixel by 1 + 1e-6 u for uniforms u in
[-1, 1] of three seeds; one change alone may move a loss 100 times less than
another), plus a floor of ``FLOOR`` of scale:
  * the metrics of steps 1 and 2 (``tests/test_pix3d.py``'s keys and the rest);
  * the gradients, as the first SGD update of every parameter (the
    detection stack and the mesh branch apart), and the second update;
  * BatchNorm ``running_mean`` / ``running_var`` after each step.
The Mask R-CNN pieces are held tightly, at fixed inputs, in
tests/test_torch_pix3d_train_ops.py.
The JAX program is built once for the module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshrcnn_tpu.core.config import LossWeights as JaxLossWeights
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu.parallel import train_step as jts
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.harness import train_epoch
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.parallel.train_step import Batch, create_train_state, make_train_step
from meshrcnn_tpu_torch.utils.meters import gcn_metrics
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import (Replay, load_flax, pix3d_train_step_draws,
                                state_dict_from_flax, to_numpy_tree)

B = 2
PCS = 512
NOISE_FACTOR = 4.0
FLOOR = 1e-4
KEYS = (jax.random.PRNGKey(1), jax.random.PRNGKey(2))
# rows the samplers draw over at 64x64: anchors of P2..P6, RPN proposals + GT
ANCHORS = 3 * (16 * 16 + 8 * 8 + 4 * 4 + 2 * 2 + 1)
PROPOSALS = TINY["rpn_post_nms_top_n"] + 1
CONFIG = dict(optimizer="sgd", lr=0.02, weight_decay=1e-4, batch_size=B, point_cloud_size=PCS,
              normal_k=4, distance_tile=32, train_backbone=True, pix3d_schedule=True)
WEIGHTS = dict(voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5)
METRIC_KEYS = {"voxel_loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
               "loss_box_reg", "loss_mask", "chamfer_loss", "normal_loss", "edge_loss", "loss"}


def _configs():
    return (JaxTrainConfig(loss_weights=JaxLossWeights(**WEIGHTS), **CONFIG),
            TrainConfig(loss_weights=LossWeights(**WEIGHTS), **CONFIG))


def _port_model() -> Pix3DModel:
    return Pix3DModel(backbone_dtype="float32", **TINY)


def _draws(keys) -> list:
    return [d for k in keys for d in pix3d_train_step_draws(
        k, B, ANCHORS, PROPOSALS, TINY["roi_batch_size"], PCS)]


def _sd(state) -> dict:
    """A JAX state's params and BN statistics, keyed like the port's state_dict."""
    return {k: v.numpy() for k, v in state_dict_from_flax(_port_model(), state.params,
                                                          state.batch_stats).items()
            if not k.endswith("num_batches_tracked")}


def _nudges(images):
    """The 1e-6 input changes that measure JAX's own spread."""
    yield images * (1.0 + 1e-6)
    for seed in (0, 1, 2):
        u = np.random.RandomState(seed).uniform(-1.0, 1.0, images.shape).astype(np.float32)
        yield images * (1.0 + 1e-6 * u)


@pytest.fixture(scope="module")
def jax_run(monkeypatch_module):
    """Two JAX train steps from the initial state, and the same two from each
    nudged first batch; every state as numpy keyed like the port's."""
    # RoIAlign by corner gathers, the form the port has (tests/test_torch_pix3d_ops.py)
    monkeypatch_module.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
    jcfg, _ = _configs()
    jm = JaxPix3DModel(backbone_dtype="float32", **TINY)
    batch = tiny_batch(B)
    state0 = jts.create_train_state(jm, jcfg, jax.random.PRNGKey(0), batch.images)
    step = jax.jit(jts.make_train_step(jm, jcfg))

    def two_steps(first):
        s1, m1 = step(state0, first, KEYS[0])
        s2, m2 = step(s1, batch, KEYS[1])
        return [jax.device_get(m1), jax.device_get(m2)], [_sd(s1), _sd(s2)]

    metrics, states = two_steps(batch)
    nudged = [two_steps(batch.replace(images=jnp.asarray(x)))
              for x in _nudges(np.asarray(batch.images))]
    return dict(state0=state0, sd0=_sd(state0), batch=batch, metrics=metrics, states=states,
                nudged=nudged, jm=jm, jcfg=jcfg)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's two steps from the same state, on the same batch and draws."""
    _, cfg = _configs()
    s0 = jax_run["state0"]
    model = load_flax(_port_model(), {"params": s0.params, "batch_stats": s0.batch_stats})
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, Replay(_draws(KEYS)))
    batch = Batch.from_host(jax_run["batch"], "cpu")
    metrics, states, grads = [], [], None
    for i in range(2):
        metrics.append({k: v.numpy() for k, v in step(state, batch).items()})
        if i == 0:
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
        states.append({k: v.numpy().copy() for k, v in model.state_dict().items()
                       if not k.endswith("num_batches_tracked")})
    return dict(metrics=metrics, states=states, grads=grads, state=state, model=model)


def _distance(a: dict, b: dict, keys) -> float:
    return float(np.sqrt(sum(((a[k].astype(np.float64) - b[k]) ** 2).sum() for k in keys)))


def _within_spread(got: dict, want: dict, nudged: list, keys, what: str) -> None:
    """|got - want| <= NOISE_FACTOR max |nudged - want| + FLOOR * scale, over the keys' tree."""
    d = _distance(got, want, keys)
    spread = max(_distance(n, want, keys) for n in nudged)
    scale = _distance(want, {k: np.zeros_like(want[k]) for k in keys}, keys)
    assert d <= NOISE_FACTOR * spread + FLOOR * max(scale, 1.0), (what, d, spread, scale)


def test_bridge_loads_train_model_strict(jax_run):
    """The tiny model's flax tree, the train step's initial state, loads into
    the port with strict=True: training adds no parameter and no buffer."""
    s0 = jax_run["state0"]
    model = _port_model()
    sd = state_dict_from_flax(model, s0.params, s0.batch_stats)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(to_numpy_tree(s0.params)))
    assert sum(p.numel() for p in model.parameters()) == n_flax


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_metrics_match_jax(jax_run, port_run, i):
    got, want = port_run["metrics"][i], jax_run["metrics"][i]
    assert METRIC_KEYS <= set(got) and set(got) == set(want)
    assert got["grads_finite"] == want["grads_finite"] == 1.0
    for k in sorted(want):
        spread = max(abs(float(n[0][i][k]) - float(want[k])) for n in jax_run["nudged"])
        tol = NOISE_FACTOR * spread + FLOOR * max(abs(float(want[k])), 1.0)
        assert abs(float(got[k]) - float(want[k])) <= tol, (i, k, got[k], want[k], spread)
    assert float(got["backbone_loss"]) == pytest.approx(
        sum(float(got[k]) for k in ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                                    "loss_box_reg", "loss_mask")), rel=1e-6)


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_updates_and_statistics_match_jax(jax_run, port_run, i):
    """Step i's SGD update of every parameter (the gradient times the Pix3D
    schedule's lr, plus weight decay), the detection stack and the mesh
    branch apart, and the BN statistics after it."""
    before = jax_run["sd0"] if i == 0 else jax_run["states"][0]
    port_before = jax_run["sd0"] if i == 0 else port_run["states"][0]
    stats = [k for k in before if "running_" in k]
    params = [k for k in before if "running_" not in k]

    def update(after, start):
        return {k: after[k].astype(np.float64) - start[k] for k in params}
    want = update(jax_run["states"][i], before)
    got = update(port_run["states"][i], port_before)
    nudged = [update(n[1][i], jax_run["sd0"] if i == 0 else n[1][0]) for n in jax_run["nudged"]]
    for name, keys in (("detection stack", [k for k in params if k.startswith("backbone.")]),
                       ("mesh branch", [k for k in params if not k.startswith("backbone.")])):
        _within_spread(got, want, nudged, keys, f"step {i} update, {name}")
        assert _distance(want, {k: np.zeros_like(want[k]) for k in keys}, keys) > 0.0
    _within_spread(port_run["states"][i], jax_run["states"][i],
                   [n[1][i] for n in jax_run["nudged"]], stats, f"step {i} BN statistics")


def test_first_gradients_are_the_first_update(jax_run, port_run):
    """SGD without momentum: the first update is -lr (g + wd p) at the
    schedule's lr of step 0, 0.002, so the port's gradients, read off its
    parameters, agree with its update to float32 rounding."""
    sd0, after = jax_run["sd0"], port_run["states"][0]
    for name, g in port_run["grads"].items():
        want = sd0[name] - 0.002 * (g + 1e-4 * sd0[name])
        np.testing.assert_allclose(after[name], want, rtol=0, atol=1e-6 * max(
            np.abs(sd0[name]).max(), 1.0) + 1e-7, err_msg=name)
    assert port_run["state"].step == 2


def test_skip_nonfinite_update(jax_run):
    """A NaN image gives a non-finite loss: params, optimizer state, schedule
    and BN buffers stay as they were and grads_finite reads 0; a healthy batch
    then updates every part and reads 1 (as tests/test_torch_train_step.py
    checks for ShapeNet)."""
    _, cfg = _configs()
    s0 = jax_run["state0"]
    model = load_flax(_port_model(), {"params": s0.params, "batch_stats": s0.batch_stats})
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, lambda shape: torch.rand(shape))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = Batch.from_host(jax_run["batch"], "cpu")
    bad.images[0, 0, 0, 0] = float("nan")
    m = step(state, bad)
    assert float(m["grads_finite"]) == 0.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not state.optimizer.state and state.step == 1
    assert state.scheduler.last_epoch == 0
    m = step(state, Batch.from_host(jax_run["batch"], "cpu"))
    assert float(m["grads_finite"]) == 1.0 and state.scheduler.last_epoch == 1
    for k in ("backbone.backbone.conv1.weight", "backbone.roi_heads.mask_head.mask_fcn1.weight",
              "voxelBranch.conv0.weight", "refine0.graphConv0.w0.weight",
              "backbone.backbone.bn1.running_mean"):
        assert not torch.equal(model.state_dict()[k], before[k]), k


def test_pix3d_schedule_lr_matches_optax(jax_run):
    """The lr the port's optimizer applies at steps 0, 1 and 1000 of the
    Pix3D schedule (LambdaLR) against the optax chain's, read off its SGD
    update of a unit gradient."""
    jcfg, cfg = _configs()
    tx = jts.make_optimizer(jcfg, {"w": jnp.zeros(())})
    update = jax.jit(lambda s: tx.update({"w": jnp.ones(())}, s, {"w": jnp.zeros(())}))
    opt_state = tx.init({"w": jnp.zeros(())})
    want = {}
    for k in range(1001):
        upd, opt_state = update(opt_state)
        if k in (0, 1, 1000):
            want[k] = -float(upd["w"])
    state = create_train_state(_port_model(), cfg)
    for k in range(1001):
        if k in want:
            np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], want[k], rtol=1e-6)
        state.optimizer.step()            # no gradients: moves nothing
        state.scheduler.step()
    assert want[0] == pytest.approx(0.002) and want[1000] == pytest.approx(0.02)


def test_train_epoch_runs_pix3d_batches(jax_run, port_run):
    """``train_epoch`` takes the Pix3D numpy batches unchanged (boxes and masks
    copied by ``Batch.from_host``): its meters' first step equals the step
    above, from the same state and draws."""
    _, cfg = _configs()
    s0 = jax_run["state0"]
    model = load_flax(_port_model(), {"params": s0.params, "batch_stats": s0.batch_stats})
    loader = [jax.tree_util.tree_map(np.asarray, jax_run["batch"])]
    state, meters = train_epoch(0, make_train_step(cfg, Replay(_draws(KEYS[:1]))),
                                create_train_state(model, cfg), loader, gcn_metrics(), "cpu")
    assert state.step == 1 and METRIC_KEYS <= set(meters)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(meters[k].history, [port_run["metrics"][0][k]], rtol=1e-5,
                                   err_msg=k)
