"""The port's ShapeNet train step (parallel/train_step.py) against the JAX package's
``make_train_step``, at ``__graft_entry__._tiny_model`` / ``_tiny_batch(2)`` shapes
(48x48 images, capacities 512/1024/2048) with a float32 backbone on both sides.

Two recipes: (a) the bench recipe (Adam lr 1e-4, no weight decay, frozen
backbone, weights voxel 1 / chamfer 1 / normal 0 / edge 0.5); (b) normal 0.1
with the kNN + PCA normal estimator (the JAX side under
``MESHRCNN_FACE_NORMALS=0``, the port with ``face_normals=False``) and weight
decay 5e-6, at 256 points (exact kNN) and at 1536 (K3's candidate path).

Tolerances and why. In train mode the tiny model is ill-conditioned: BatchNorm
normalises c5 over 2x2x2 = 8 values, and each refine stage moves its vertices
through ``vert_align`` of those features, so a change of 1e-6 in the input
images moves JAX's own stage-3 vertices by ~3% and its refine gradients by
tens of percent. So each quantity is held to the port within
``NOISE_FACTOR`` times the distance between JAX's result and JAX's result on
images scaled by 1 + 1e-6 (its own rounding-level spread), plus a floor of
1e-4 of scale (1e-3 for the normal term and the total, whose estimated
normals differ where Gram- and difference-form distances order a near-tie of
neighbours otherwise, as in tests/test_torch_normals.py):
  * the metrics of steps 1 and 2;
  * every trainable and every frozen parameter's gradient (norm of the
    difference over the whole tree);
  * BatchNorm ``running_mean`` / ``running_var`` after each step;
  * updated parameters: within the spread above, and within 2 lr per step
    taken (Adam's first update is ~lr sign(g), so a gradient near 0 may flip).
The estimator recipe's steps are in tests/test_torch_train_estimator.py.
The backward is held tightly piece by piece instead: the K1 sums and the
backbone in train mode here, every other module the step differentiates
through in tests/test_torch_backward.py (1e-4 of scale), the estimator in
tests/test_torch_normals.py.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from meshrcnn_tpu.core.config import LossWeights as JaxLossWeights
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.models.resnet import ResNet50 as JaxResNet50
from meshrcnn_tpu.ops.chamfer_pallas import _bwd_batched, _exact_sums_batched
from meshrcnn_tpu.parallel import train_step as jts
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.harness import train_epoch
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.ops import chamfer_cuda
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_train_step, pix3d_lr)
from meshrcnn_tpu_torch.utils.meters import gcn_metrics
from tests.torch_parity import (Replay, load_flax, rel_err, state_dict_from_flax, t,
                                to_numpy_tree, train_step_draws)

B = 2
LR = 1e-4
NOISE_FACTOR = 4.0
FLOOR = 1e-4
NORMAL_FLOOR = 1e-3     # estimated normals: neighbour sets differ at near-ties
KEYS = (jax.random.PRNGKey(1), jax.random.PRNGKey(2))
RECIPES = {
    "bench": dict(weights=dict(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5),
                  weight_decay=0.0, face_normals=True),
    "estimator": dict(weights=dict(voxel=1.0, chamfer=1.0, normal=0.1, edge=0.5),
                      weight_decay=5e-6, face_normals=False),
}


def _configs(recipe: str, pcs: int):
    r = RECIPES[recipe]
    kw = dict(optimizer="adam", lr=LR, weight_decay=r["weight_decay"], batch_size=B,
              point_cloud_size=pcs, normal_k=10, distance_tile=2048, train_backbone=False)
    return (JaxTrainConfig(loss_weights=JaxLossWeights(**r["weights"]), **kw),
            TrainConfig(loss_weights=LossWeights(**r["weights"]),
                        face_normals=r["face_normals"], **kw))


def _tiny_port_model() -> ShapeNetModel:
    return ShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                         voxel_out_channels=8, vert_capacity=512, face_capacity=1024,
                         edge_capacity=2048, num_refinement_stages=3)


def _grads_sd(grads) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(_tiny_port_model(), grads).items()}


def _state_sd(state) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_flax(_tiny_port_model(), state.params,
                                                          state.batch_stats).items()
            if not k.endswith("num_batches_tracked")}


@functools.lru_cache(maxsize=None)
def _jax_run(recipe: str, pcs: int):
    """Two JAX train steps and the gradients of the first, and the same from
    images scaled by 1 + 1e-6 in the first step; every result as numpy, keyed
    like the port's state_dict."""
    jcfg, _ = _configs(recipe, pcs)
    old = os.environ.get("MESHRCNN_FACE_NORMALS")
    os.environ["MESHRCNN_FACE_NORMALS"] = "1" if RECIPES[recipe]["face_normals"] else "0"
    try:
        jm = graft._tiny_model().clone(backbone_dtype="float32")
        batch = graft._tiny_batch(B)
        state0 = jts.create_train_state(jm, jcfg, jax.random.PRNGKey(0), batch.images)
        step = jax.jit(jts.make_train_step(jm, jcfg))
        grad = jax.jit(jax.grad(lambda p, b, k: jts.shapenet_loss_fn(
            jm, jcfg, p, state0.batch_stats, b, k)[0]))
        nudged = batch.replace(images=batch.images * (1.0 + 1e-6))
        s1, m1 = step(state0, batch, KEYS[0])
        s2, m2 = step(s1, batch, KEYS[1])
        s1n, m1n = step(state0, nudged, KEYS[0])
        s2n, m2n = step(s1n, batch, KEYS[1])
        out = dict(
            state0=state0, batch=batch,
            metrics=[jax.device_get(m1), jax.device_get(m2)],
            metrics_nudged=[jax.device_get(m1n), jax.device_get(m2n)],
            states=[_state_sd(s1), _state_sd(s2)],
            states_nudged=[_state_sd(s1n), _state_sd(s2n)],
            grads=_grads_sd(grad(state0.params, batch, KEYS[0])),
            grads_nudged=_grads_sd(grad(state0.params, nudged, KEYS[0])))
    finally:
        if old is None:
            os.environ.pop("MESHRCNN_FACE_NORMALS")
        else:
            os.environ["MESHRCNN_FACE_NORMALS"] = old
    return out


def _port_run(recipe: str, pcs: int):
    ref = _jax_run(recipe, pcs)
    _, cfg = _configs(recipe, pcs)
    model = load_flax(_tiny_port_model(), {"params": ref["state0"].params,
                                           "batch_stats": ref["state0"].batch_stats})
    state = create_train_state(model, cfg)
    draws = [d for k in KEYS for d in train_step_draws(k, B, pcs)]
    step = make_train_step(cfg, Replay(draws))
    batch = Batch.from_host(ref["batch"], "cpu")
    metrics, states, grads = [], [], None
    for i in range(2):
        metrics.append({k: v.numpy() for k, v in step(state, batch).items()})
        if i == 0:
            grads = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
                     for n, p in model.named_parameters()}
        states.append({k: v.numpy().copy() for k, v in model.state_dict().items()
                       if not k.endswith("num_batches_tracked")})
    return ref, metrics, states, grads, state


def _within_spread(got: dict, want: dict, nudged: dict, keys) -> None:
    """|got - want| <= NOISE_FACTOR |nudged - want| + FLOOR * scale, over the keys' tree."""
    d = np.sqrt(sum(((got[k] - want[k]).astype(np.float64) ** 2).sum() for k in keys))
    spread = np.sqrt(sum(((nudged[k] - want[k]).astype(np.float64) ** 2).sum() for k in keys))
    scale = np.sqrt(sum((want[k].astype(np.float64) ** 2).sum() for k in keys))
    assert d <= NOISE_FACTOR * spread + FLOOR * max(scale, 1.0), (d, spread, scale)


def check_train_steps(recipe: str, pcs: int) -> None:
    """Two port train steps against two JAX steps (see the module note)."""
    ref, metrics, states, grads, state = _port_run(recipe, pcs)
    assert state.step == 2
    for i, (got, want, nudged) in enumerate(zip(metrics, ref["metrics"],
                                                ref["metrics_nudged"])):
        assert set(got) == set(want)
        assert got["grads_finite"] == want["grads_finite"] == 1.0
        assert got["overflow"] == want["overflow"]
        for k in ("loss", "voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
            spread = abs(float(nudged[k]) - float(want[k]))
            floor = NORMAL_FLOOR if k in ("loss", "normal_loss") else FLOOR
            tol = NOISE_FACTOR * spread + floor * max(abs(float(want[k])), 1.0)
            assert abs(float(got[k]) - float(want[k])) <= tol, (i, k, got[k], want[k], spread)
    if RECIPES[recipe]["weights"]["normal"]:
        assert metrics[0]["normal_loss"] < 0.0
    else:
        assert metrics[0]["normal_loss"] == 0.0
    # gradients of the first step: trainable and frozen parts
    trainable = [k for k in grads if not k.startswith("backbone.")]
    frozen = [k for k in grads if k.startswith("backbone.")]
    for keys in (trainable, frozen):
        _within_spread(grads, ref["grads"], ref["grads_nudged"], keys)
    # BN statistics and parameters after each step
    stats = [k for k in states[0] if "running_" in k]
    params = [k for k in states[0] if "running_" not in k]
    for i in range(2):
        _within_spread(states[i], ref["states"][i], ref["states_nudged"][i], stats)
        _within_spread(states[i], ref["states"][i], ref["states_nudged"][i], params)
        for k in params:
            assert np.abs(states[i][k] - ref["states"][i][k]).max() <= 2 * LR * (i + 1) * 1.001, k
    # the frozen backbone did not move; the rest did
    sd0 = state_dict_from_flax(_tiny_port_model(), ref["state0"].params)
    assert all(np.array_equal(states[1][k], sd0[k].numpy()) for k in params
               if k.startswith("backbone."))
    assert not np.array_equal(states[1]["refine0.graphConv0.w0.weight"],
                              sd0["refine0.graphConv0.w0.weight"].numpy())


def test_train_steps_match_jax_bench_recipe():
    check_train_steps("bench", 256)


def test_bn_running_var_is_flax_biased_variance():
    """After one train-mode forward, ``running_var`` is flax's update with the
    biased batch variance. B=3 at 64x64: 1e-4 relative (the forward's f32
    rounding). torch's own BatchNorm2d folds in the unbiased variance, n/(n-1)
    larger: at c5 (n = 3*2*2 = 12) that update would be off by ~1%."""
    x = np.random.RandomState(0).rand(3, 64, 64, 3).astype(np.float32)
    jm = JaxResNet50(num_classes=13, dtype=jnp.float32)
    variables = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(x)
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, x)
    want = state_dict_from_flax(ResNet50(num_classes=13), variables["params"],
                                upd["batch_stats"])
    tm = load_flax(ResNet50(num_classes=13), variables).train()
    with torch.no_grad():
        tm(t(x))
    got = tm.state_dict()
    for k in want:
        if "running_" in k:
            assert rel_err(got[k].numpy(), want[k].numpy()) < 1e-4, k
    assert int(got["bn1.num_batches_tracked"]) == 1
    c5 = got["layer4_2.bn3.running_var"].numpy()         # 0.9 * 1 + 0.1 * var
    unbiased = 0.9 + (c5 - 0.9) * 12.0 / 11.0
    assert rel_err(unbiased, want["layer4_2.bn3.running_var"].numpy()) > 1e-3


def test_resnet_train_mode_vjp_matches_flax():
    """Train-mode forward and VJP of the backbone, with a random cotangent on
    every pyramid level, at B=3, 64x64. Random-init ResNet-50 in train mode
    amplifies f32 rounding ~100x by c5 (BatchNorm divides near-constant
    channels by sqrt(var + eps)), so feature maps are held to 1e-3 of scale and
    gradients to the spread test of this module."""
    x = np.random.RandomState(1).rand(3, 64, 64, 3).astype(np.float32)
    jm = JaxResNet50(num_classes=13, dtype=jnp.float32)
    variables = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(x)

    def maps(params, a):
        (_, fm), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              a, train=True, mutable=["batch_stats"])
        return fm
    fm = jax.jit(maps)(variables["params"], x)
    cots = [np.random.RandomState(i).randn(*m.shape).astype(np.float32) for i, m in enumerate(fm)]
    grad = jax.jit(jax.grad(lambda p, a: sum((m * c).sum() for m, c in zip(maps(p, a), cots))))
    want = _grads_sd(grad(variables["params"], x))
    nudged = _grads_sd(grad(variables["params"], x * (1.0 + 1e-6)))
    tm = load_flax(ResNet50(num_classes=13), variables).train()
    _, tfm = tm(t(x))
    for a, b in zip(tfm, fm):
        assert rel_err(a.detach().numpy(), b) < 1e-3
    sum((m * t(c)).sum() for m, c in zip(tfm, cots)).backward()
    got = {n: p.grad.numpy() for n, p in tm.named_parameters() if not n.startswith("fc.")}
    _within_spread(got, want, nudged, list(got))


@pytest.mark.parametrize("ties", [False, True])
def test_k1_sum_gradients_equal_jax_closed_form(ties):
    """Autograd of ``chamfer_sums_batched`` (gathers at the kernel's indices)
    against ``_bwd_batched``, the JAX package's closed form, with the same
    indices and cotangents: 1e-5 of scale (summation order only)."""
    rng = np.random.RandomState(3)
    if ties:
        p = rng.randint(0, 4, (2, 90, 3)).astype(np.float32)
        q = rng.randint(0, 4, (2, 70, 3)).astype(np.float32)
    else:
        p = rng.uniform(-1, 1, (2, 90, 3)).astype(np.float32)
        q = rng.uniform(-1, 1, (2, 70, 3)).astype(np.float32)
    g1, g2 = rng.rand(2).astype(np.float32), rng.rand(2).astype(np.float32)
    tp, tq = t(p).requires_grad_(True), t(q).requires_grad_(True)
    s_p, i_p, s_q, i_q = chamfer_cuda.chamfer_sums_batched(tp, tq)
    dp, dq = torch.autograd.grad((s_p * t(g1)).sum() + (s_q * t(g2)).sum(), (tp, tq))
    res = (jnp.asarray(p), jnp.asarray(q), jnp.asarray(i_p.numpy()), jnp.asarray(i_q.numpy()))
    want_dp, want_dq = _bwd_batched(res, (jnp.asarray(g1), None, jnp.asarray(g2), None))
    want_sums = _exact_sums_batched(*res)
    assert rel_err(dp.numpy(), want_dp) < 1e-5
    assert rel_err(dq.numpy(), want_dq) < 1e-5
    np.testing.assert_allclose(s_p.detach().numpy(), np.asarray(want_sums[0]), rtol=1e-6)
    np.testing.assert_allclose(s_q.detach().numpy(), np.asarray(want_sums[1]), rtol=1e-6)


def _small_tree():
    rng = np.random.RandomState(4)
    return {"backbone": {"w": rng.randn(4, 3).astype(np.float32)},
            "head": {"w": rng.randn(3, 2).astype(np.float32),
                     "b": rng.randn(2).astype(np.float32)}}


class _Small(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.backbone = torch.nn.ParameterDict({"w": torch.nn.Parameter(t(tree["backbone"]["w"]))})
        self.head = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v))
                                            for k, v in tree["head"].items()})


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam", lr=1e-3, weight_decay=5e-6),
    dict(optimizer="adam", lr=1e-2, weight_decay=0.1, grad_clip=0.5),
    dict(optimizer="sgd", lr=0.1, weight_decay=1e-2),
    dict(optimizer="sgd", lr=0.1, weight_decay=0.0, train_backbone=True, grad_clip=1.0),
    dict(optimizer="adam", lr=0.0, weight_decay=1e-4, pix3d_schedule=True, train_backbone=True),
])
def test_optimizer_mapping_matches_optax(kw):
    """Five updates of a small tree with fixed gradient draws: the port's
    optimizer (clip, then Adam/SGD with L2 in the gradient, frozen backbone,
    Pix3D schedule) against ``make_optimizer``'s optax chain. 1e-6 of scale:
    f32 rounding of the same arithmetic."""
    from meshrcnn_tpu_torch.parallel.train_step import (clip_by_global_norm, make_optimizer,
                                                        trainable_parameters)
    tree = _small_tree()
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    tx = jts.make_optimizer(jcfg, tree)
    opt_state = tx.init(tree)
    model = _Small(tree)
    opt, sched = make_optimizer(tcfg, model)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.RandomState(5)
    for _ in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * 3, tree)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)
        model.backbone["w"].grad = t(g["backbone"]["w"])
        for k in ("w", "b"):
            model.head[k].grad = t(g["head"][k])
        if tcfg.grad_clip:
            clip_by_global_norm([p.grad for p in trainable_parameters(model, tcfg)],
                                tcfg.grad_clip)
        opt.step()
        if sched is not None:
            sched.step()
    got = {"backbone": {"w": model.backbone["w"]}, "head": dict(model.head)}
    for path, want in jax.tree_util.tree_leaves_with_path(to_numpy_tree(params)):
        node = got
        for p in path:
            node = node[p.key]
        assert rel_err(node.detach().numpy(), want) < 1e-6, jax.tree_util.keystr(path)
    if not tcfg.train_backbone:
        np.testing.assert_array_equal(model.backbone["w"].detach().numpy(), tree["backbone"]["w"])


def test_pix3d_schedule_matches_jax():
    for step in (0, 1, 500, 999, 1000, 7999, 8000, 9999, 10000, 20000):
        warm = 0.002 + (0.02 - 0.002) * min(step / 1000.0, 1.0)
        decay = float(np.where(step >= 10000, 0.01, np.where(step >= 8000, 0.1, 1.0)))
        np.testing.assert_allclose(pix3d_lr(step), warm * decay, rtol=1e-12)


@pytest.fixture(scope="module")
def tiny():
    jm = graft._tiny_model().clone(backbone_dtype="float32")
    batch = graft._tiny_batch(B)
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(batch.images)
    return variables, batch


def test_skip_nonfinite_update(tiny):
    """A NaN image gives a NaN loss: params, optimizer state and BN buffers
    stay as they were and grads_finite reads 0; a healthy batch then updates
    and reads 1 (mirrors tests/test_train_step.py::test_skip_nonfinite_update)."""
    variables, batch = tiny
    _, cfg = _configs("bench", 64)
    model = load_flax(_tiny_port_model(), variables)
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, lambda shape: torch.rand(shape))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = Batch.from_host(batch, "cpu")
    bad.images[0, 0, 0, 0] = float("nan")
    m = step(state, bad)
    assert float(m["grads_finite"]) == 0.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not state.optimizer.state and state.step == 1
    m = step(state, Batch.from_host(batch, "cpu"))
    assert float(m["grads_finite"]) == 1.0
    assert not torch.equal(model.refine0.graphConv0.w0.weight, before["refine0.graphConv0.w0.weight"])
    assert not torch.equal(model.backbone.bn1.running_mean, before["backbone.bn1.running_mean"])


def test_zero_weight_normal_elided(tiny, monkeypatch):
    """With normal weight 0 the normal term is not computed (it reads 0, K3 and
    the estimator never run) and every other metric and every gradient equal
    the force-reported variant's (mirrors tests/test_train_step.py::
    test_zero_weight_normal_elided)."""
    variables, batch = tiny
    from meshrcnn_tpu_torch.ops import chamfer as port_chamfer
    calls = []
    real = port_chamfer.batched_compute_normals
    monkeypatch.setattr(port_chamfer, "batched_compute_normals",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    results = []
    for report in (False, True):
        _, cfg = _configs("bench", 1200)
        cfg.face_normals = False
        cfg.report_unweighted_losses = report
        model = load_flax(_tiny_port_model(), variables)
        state = create_train_state(model, cfg)
        gen = torch.Generator().manual_seed(0)
        m = make_train_step(cfg, lambda shape: torch.rand(shape, generator=gen))(
            state, Batch.from_host(batch, "cpu"))
        results.append((m, {n: p.grad.numpy() for n, p in model.named_parameters()
                            if p.grad is not None}))
        assert len(calls) == (6 if report else 0)
    (m_e, g_e), (m_r, g_r) = results
    assert float(m_e["normal_loss"]) == 0.0 and float(m_r["normal_loss"]) != 0.0
    for k in ("loss", "voxel_loss", "chamfer_loss", "edge_loss"):
        assert float(m_e[k]) == float(m_r[k]), k
    # the CPU backward sums scatter-adds in a thread-dependent order: two runs
    # of one config differ by ~1e-7 of scale; the normal term adds nothing
    assert set(g_e) == set(g_r)
    for k in g_e:
        assert rel_err(g_e[k], g_r[k]) < 1e-5, k


def test_train_epoch_matches_jax(tiny):
    """Two batches through ``train_epoch`` against the JAX harness's, keys
    fold_in(rng, epoch * 100000 + i) replayed, at lr 0 so that each step's
    metrics are those of one forward: the meters' epoch averages (history)
    agree to 5e-3 relative, the forward's spread on this model (module note)."""
    from meshrcnn_tpu.harness import train_epoch as jax_train_epoch
    from meshrcnn_tpu.utils.meters import gcn_metrics as jax_gcn_metrics
    variables, batch = tiny
    jcfg, cfg = _configs("bench", 128)
    jcfg.lr = cfg.lr = 0.0
    jm = graft._tiny_model().clone(backbone_dtype="float32")
    flipped = batch.replace(images=batch.images[:, ::-1])
    loader = [jax.tree_util.tree_map(np.asarray, b) for b in (batch, flipped)]
    state0 = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jts.make_optimizer(jcfg, variables["params"]).init(
                                variables["params"]))
    rng = jax.random.PRNGKey(7)
    _, want = jax_train_epoch(0, jax.jit(jts.make_train_step(jm, jcfg)), state0, loader,
                              jax_gcn_metrics(), rng)
    draws = [d for i in range(2)
             for d in train_step_draws(jax.random.fold_in(rng, i), B, 128)]
    model = load_flax(_tiny_port_model(), variables)
    state, got = train_epoch(0, make_train_step(cfg, Replay(draws)),
                             create_train_state(model, cfg), loader, gcn_metrics(), "cpu")
    assert state.step == 2
    assert set(got) == set(want)
    for k in ("loss", "voxel_loss", "chamfer_loss", "edge_loss", "normal_loss", "overflow",
              "grads_finite"):
        np.testing.assert_allclose(got[k].history, want[k].history, rtol=5e-3, err_msg=k)
    assert got["warmup_time"].history and got["batch_time"].history
