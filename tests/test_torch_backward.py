"""The train step's backward, piece by piece, against JAX's VJPs.

The tiny model's whole step is too ill-conditioned to hold a gradient
tightly: a change of 1e-6 in the input images moves JAX's own parameter
gradients by ~1e-3 of their scale even with BatchNorm on running statistics
and fixed cotangents on the outputs (chained refine stages sample their
features at the vertices the stage before moved), and by tens of percent in
train mode (tests/test_torch_train_step.py). So every module the step
differentiates through is held here on its own, on fixed random inputs and
cotangents, with the parameter and input gradients of each within 1e-4 of
their scale (f32 on both sides; only summation order differs). JAX's
neighbour sums are differences of prefix sums, which lose ~eps * E of scale
(tests/test_torch_graph_conv.py): its aggregation's VJP is held on its own,
and the flax refine cells sum neighbours by scatter-add instead.
  * ``vert_align`` (the port's gathers, whose backward is a scatter-add) and
    ``aggregate_neighbours`` (``index_select`` / ``index_add_``);
  * the refine cells, plain and residual, with and without input features;
  * the ResNet-50 backbone on running statistics, and the voxel branch;
  * ``mesh_loss`` with the sampled faces' normals (the bench recipe's) wrt the
    predicted vertices.
The K1 sums' backward is in tests/test_torch_train_step.py, the normal
estimator's in tests/test_torch_normals.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.core.mesh import MeshBatch as JaxMeshBatch
from meshrcnn_tpu.models import layers as jl
from meshrcnn_tpu.models.resnet import ResNet50 as JaxResNet50
from meshrcnn_tpu.ops.graph_conv import aggregate_neighbours as jax_aggregate
from meshrcnn_tpu.ops.graph_conv import precompute_adjacency as jax_adjacency
from meshrcnn_tpu.ops.losses import mesh_loss as jax_mesh_loss
from meshrcnn_tpu.ops.vert_align import vert_align as jax_vert_align
from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.models import layers as tl
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.ops.graph_conv import aggregate_neighbours, precompute_adjacency
from meshrcnn_tpu_torch.ops.losses import mesh_loss
from meshrcnn_tpu_torch.ops.vert_align import vert_align
from tests.test_torch_modules import _cell_inputs
from tests.torch_parity import Replay, load_flax, rel_err, sampler_draws, state_dict_from_flax, t

TOL = 1e-4


def _cots(seed, *arrays):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(a)).astype(np.float32) for a in arrays]


def _leaf(x) -> torch.Tensor:
    return t(x).requires_grad_(True)


def _assert_param_grads(module: torch.nn.Module, jax_grads) -> None:
    want = state_dict_from_flax(module, jax_grads)
    got = dict(module.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        assert rel_err(p.grad.numpy(), want[name].numpy()) < TOL, name


def test_vert_align_and_aggregation_vjp_match_jax():
    rng = np.random.RandomState(20)
    B, V, E = 2, 60, 200
    verts = rng.uniform(-1, 1, (B, V, 3)).astype(np.float32)
    verts[..., 2] -= 2.0
    maps = [rng.randn(B, s, s, c).astype(np.float32) for s, c in ((12, 3), (6, 5), (3, 5))]
    for combine, fms in (("concat", maps), ("sum", maps[1:])):
        out, vjp = jax.vjp(lambda m, v: jax_vert_align(m, v, (48, 48), combine=combine),
                           [jnp.asarray(m) for m in fms], jnp.asarray(verts))
        (cot,) = _cots(21, out)
        want_maps, want_verts = vjp(jnp.asarray(cot))
        tm, tv = [_leaf(m) for m in fms], _leaf(verts)
        got = vert_align(tm, tv, (48, 48), combine=combine)
        got.backward(t(cot))
        for a, b in zip(tm, want_maps):
            assert rel_err(a.grad.numpy(), b) < TOL, combine
        assert rel_err(tv.grad.numpy(), want_verts) < TOL, combine

    a, b = rng.randint(0, V, (2, B, E))
    edges = np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(np.int32)
    mask = rng.rand(B, E) > 0.3
    feats = rng.randn(B, V, 8).astype(np.float32)
    out, vjp = jax.vjp(lambda f: jax_aggregate(f, jnp.asarray(edges), jnp.asarray(mask)),
                       jnp.asarray(feats))
    (cot,) = _cots(22, out)
    (want,) = vjp(jnp.asarray(cot))
    tf = _leaf(feats)
    aggregate_neighbours(tf, precompute_adjacency(t(edges), t(mask), V)).backward(t(cot))
    assert rel_err(tf.grad.numpy(), want) < TOL


def _scatter_aggregate(edges, mask):
    """JAX neighbour sums by scatter-add over the edge list: exact, where the
    JAX package's prefix-sum differences lose ~eps * E of scale (its own VJP
    is held to the port's above)."""
    lo, hi = jnp.asarray(edges[..., 0]), jnp.asarray(edges[..., 1])

    def aggregate(feats, topo):
        m = jnp.asarray(mask)[..., None].astype(feats.dtype)
        b = jnp.arange(feats.shape[0])[:, None]
        out = jnp.zeros_like(feats).at[b, lo].add(feats[b, hi] * m)
        return out.at[b, hi].add(feats[b, lo] * m)
    return aggregate


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("use_input_features", [False, True])
def test_refine_cell_vjp_matches_flax(monkeypatch, residual, use_input_features):
    """Gradients of a refine cell's (verts, features) wrt its parameters, the
    feature maps, the vertices and the input features; the flax cell sums
    neighbours with ``_scatter_aggregate``."""
    F = 12
    maps, verts, edges, mask, feats = _cell_inputs(10 + int(residual) + 2 * use_input_features)
    monkeypatch.setattr(jl, "aggregate_neighbours", _scatter_aggregate(edges, mask))
    jcls = jl.ResVertixRefineShapenet if residual else jl.VertixRefineShapeNet
    tcls = tl.ResVertixRefineShapenet if residual else tl.VertixRefineShapeNet
    jm = jcls(use_input_features=use_input_features, num_features=F)
    topo = jax_adjacency(jnp.asarray(edges), jnp.asarray(mask), verts.shape[1])
    jmaps, jverts, jfeats = [jnp.asarray(m) for m in maps], jnp.asarray(verts), jnp.asarray(feats)
    variables = jm.init(jax.random.PRNGKey(4), jmaps, jverts, topo, (32, 32),
                        vert_feats=jfeats if use_input_features else None)

    def fwd(params, m, v, f):
        return jm.apply({"params": params}, m, v, topo, (32, 32),
                        vert_feats=f if use_input_features else None)
    out, vjp = jax.vjp(fwd, variables["params"], jmaps, jverts, jfeats)
    cots = _cots(23, *out)
    w_params, w_maps, w_verts, w_feats = vjp(tuple(jnp.asarray(c) for c in cots))

    tm = load_flax(tcls(use_input_features=use_input_features, num_features=F,
                        levels=(4, 6)), variables)
    t_maps, t_verts, t_feats = [_leaf(m) for m in maps], _leaf(verts), _leaf(feats)
    got_v, got_f = tm(t_maps, t_verts, precompute_adjacency(t(edges), t(mask), verts.shape[1]),
                      (32, 32), vert_feats=t_feats if use_input_features else None)
    ((got_v * t(cots[0])).sum() + (got_f * t(cots[1])).sum()).backward()
    _assert_param_grads(tm, w_params)
    for a, b in zip(t_maps, w_maps):
        assert rel_err(a.grad.numpy(), b) < TOL
    assert rel_err(t_verts.grad.numpy(), w_verts) < TOL
    if use_input_features:
        assert rel_err(t_feats.grad.numpy(), w_feats) < TOL


def test_resnet50_vjp_on_running_stats_matches_flax():
    """The backbone in eval mode, a cotangent on the logits and every pyramid
    level: parameter and image gradients."""
    x = np.random.RandomState(24).rand(2, 40, 40, 3).astype(np.float32)
    jm = JaxResNet50(num_classes=13, dtype=jnp.float32)
    variables = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(x)

    def fwd(params, a):
        return jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, a,
                        train=False)
    (logits, maps), vjp = jax.vjp(fwd, variables["params"], jnp.asarray(x))
    cots = _cots(25, logits, *maps)
    w_params, w_x = jax.jit(vjp)((jnp.asarray(cots[0]), [jnp.asarray(c) for c in cots[1:]]))
    tm = load_flax(ResNet50(num_classes=13), variables)
    tx = _leaf(x)
    t_logits, t_maps = tm(tx)
    (sum((o * t(c)).sum() for o, c in zip([t_logits, *t_maps], cots))).backward()
    _assert_param_grads(tm, w_params)
    assert rel_err(tx.grad.numpy(), w_x) < TOL


def test_voxel_branch_vjp_matches_flax():
    x = np.random.RandomState(26).randn(2, 5, 5, 16).astype(np.float32)
    jm = jl.VoxelBranch(out_channels=6, hidden_channels=8)
    variables = jm.init(jax.random.PRNGKey(1), x)
    out, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a), variables["params"],
                       jnp.asarray(x))
    (cot,) = _cots(27, out)                                   # NHWC, as flax's output
    w_params, w_x = vjp(jnp.asarray(cot))
    tm = load_flax(tl.VoxelBranch(16, 6, hidden_channels=8), variables)
    tx = _leaf(x)
    tm(tx).backward(t(cot.transpose(0, 3, 1, 2)))
    _assert_param_grads(tm, w_params)
    assert rel_err(tx.grad.numpy(), w_x) < TOL


def test_mesh_loss_with_face_normals_vjp_matches_jax(monkeypatch):
    """One refinement stage of the bench recipe's mesh loss (normals of the
    sampled faces): the weighted chamfer + normal + edge gradient wrt the
    predicted vertices, with the JAX package's draws replayed."""
    monkeypatch.setenv("MESHRCNN_FACE_NORMALS", "1")
    rng = np.random.RandomState(28)
    B, V, F, n = 2, 60, 90, 512
    verts = (rng.randn(B, V, 3) * 0.5).astype(np.float32)
    faces = rng.randint(0, V, (B, F, 3)).astype(np.int32)
    fmask = rng.rand(B, F) > 0.1
    edges = rng.randint(0, V, (B, 100, 2)).astype(np.int32)
    emask = rng.rand(B, 100) > 0.2
    gt_v = (rng.randn(B, 40, 3) * 0.5).astype(np.float32)
    gt_f = rng.randint(0, 40, (B, 50, 3)).astype(np.int32)
    gt_m = np.ones((B, 50), bool)
    key = jax.random.PRNGKey(29)
    jmesh = JaxMeshBatch(verts=jnp.asarray(verts), verts_mask=jnp.ones((B, V), bool),
                         faces=jnp.asarray(faces), faces_mask=jnp.asarray(fmask),
                         edges=jnp.asarray(edges), edges_mask=jnp.asarray(emask))
    w = np.array([1.0, 0.7, 0.3], np.float32)

    def jax_fn(v):
        c, nrm, e = jax_mesh_loss(key, v, jmesh, jnp.asarray(gt_v), jnp.asarray(gt_f),
                                  jnp.asarray(gt_m), point_cloud_size=n)
        return w[0] * c + w[1] * nrm + w[2] * e
    want = jax.grad(jax_fn)(jnp.asarray(verts))

    k_pred, k_gt = jax.random.split(key)
    tmesh = MeshBatch(verts=t(verts), verts_mask=torch.ones((B, V), dtype=torch.bool),
                      faces=t(faces), faces_mask=t(fmask), edges=t(edges),
                      edges_mask=t(emask))
    tv = _leaf(verts)
    got = mesh_loss(tv, tmesh, t(gt_v), t(gt_f), t(gt_m),
                    Replay(sampler_draws(k_pred, B, n) + sampler_draws(k_gt, B, n)),
                    point_cloud_size=n, face_normals=True)
    sum(float(wi) * g for wi, g in zip(w, got)).backward()
    assert rel_err(tv.grad.numpy(), want) < TOL
