"""The port's nn.Modules against the flax modules, weights carried by the bridge
(utils/jax_params.py). Tolerance 1e-4 relative to each output's scale: f32 on
both sides, only the summation order of convolutions and matmuls differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.models import layers as jl
from meshrcnn_tpu.models.resnet import ResNet50 as JaxResNet50
from meshrcnn_tpu.ops.graph_conv import precompute_adjacency as jax_adjacency
from meshrcnn_tpu_torch.models import layers as tl
from meshrcnn_tpu_torch.models.resnet import ResNet50
from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency
from meshrcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.torch_parity import load_flax, rel_err, t, to_numpy_tree

TOL = 1e-4


def test_resnet50_matches_flax_with_running_stats():
    x = np.random.RandomState(0).rand(2, 40, 40, 3).astype(np.float32)
    jm = JaxResNet50(num_classes=13, dtype=jnp.float32)
    variables = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(x)
    # non-trivial running statistics, so the BN mapping is exercised
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape).astype(np.float32) + 0.5) if a.ndim else a,
        to_numpy_tree(variables["batch_stats"]))
    variables = {"params": variables["params"], "batch_stats": stats}
    logits, maps = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    tm = load_flax(ResNet50(num_classes=13), variables)
    with torch.no_grad():
        tlogits, tmaps = tm(t(x))
    assert rel_err(tlogits.numpy(), logits) < TOL
    for a, b in zip(tmaps, maps):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) < TOL


@pytest.mark.parametrize("logit_scale", [1.0, 200.0])
def test_voxel_branch_matches_flax(logit_scale):
    """Includes logits far beyond the soft clamp's +-8 knee (scale 200), and
    pins the ConvTranspose layout: flax applies its kernel flipped."""
    x = np.random.RandomState(2).randn(2, 5, 5, 16).astype(np.float32)
    jm = jl.VoxelBranch(out_channels=6, hidden_channels=8)
    variables = jm.init(jax.random.PRNGKey(1), x)
    params = to_numpy_tree(variables["params"])
    params["conv2"]["kernel"] = params["conv2"]["kernel"] * logit_scale
    want = np.asarray(jm.apply({"params": params}, x)).transpose(0, 3, 1, 2)
    tm = load_flax(tl.VoxelBranch(16, 6, hidden_channels=8), {"params": params})
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert got.shape == (2, 6, 10, 10)
    assert rel_err(got, want) < TOL
    if logit_scale > 1:
        assert (got.min() < 1e-5) and (got.max() > 1 - 1e-5)
    # without the spatial flip the deconv would disagree
    sd = state_dict_from_jax(tm, params, {})
    sd["deconv.weight"] = sd["deconv.weight"].flip(2, 3)
    tm.load_state_dict(sd)
    with torch.no_grad():
        assert rel_err(tm(t(x)).numpy(), want) > 1e-2


def test_soft_clamp_matches_flax():
    x = np.array([-1e4, -100.0, -8.5, -8.0, -1.0, 0.0, 3.0, 8.0, 8.0001, 9.0, 1e4],
                 dtype=np.float32)
    np.testing.assert_allclose(tl._soft_clamp_logits(t(x)).numpy(),
                               np.asarray(jl._soft_clamp_logits(jnp.asarray(x))),
                               rtol=1e-6)


def _cell_inputs(seed, B=2, V=40, E=120, F=12):
    rng = np.random.RandomState(seed)
    maps = [rng.randn(B, s, s, c).astype(np.float32) for s, c in ((8, 4), (4, 6))]
    verts = rng.uniform(-0.8, 0.8, (B, V, 3)).astype(np.float32)
    verts[..., 2] -= 2.0
    a, b = rng.randint(0, V, (2, B, E))
    edges = np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(np.int32)
    mask = rng.rand(B, E) > 0.2
    feats = rng.randn(B, V, F).astype(np.float32)
    return maps, verts, edges, mask, feats


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("use_input_features", [False, True])
def test_refine_cells_match_flax(residual, use_input_features):
    F = 12
    maps, verts, edges, mask, feats = _cell_inputs(int(residual) + 2 * use_input_features)
    jcls = jl.ResVertixRefineShapenet if residual else jl.VertixRefineShapeNet
    tcls = tl.ResVertixRefineShapenet if residual else tl.VertixRefineShapeNet
    jm = jcls(use_input_features=use_input_features, num_features=F)
    topo = jax_adjacency(jnp.asarray(edges), jnp.asarray(mask), verts.shape[1])
    vf = jnp.asarray(feats) if use_input_features else None
    args = ([jnp.asarray(m) for m in maps], jnp.asarray(verts), topo, (32, 32))
    variables = jm.init(jax.random.PRNGKey(3), *args, vert_feats=vf)
    want_v, want_f = jm.apply(variables, *args, vert_feats=vf)
    tm = load_flax(tcls(use_input_features=use_input_features, num_features=F,
                        levels=(4, 6)), variables)
    with torch.no_grad():
        got_v, got_f = tm([t(m) for m in maps], t(verts),
                          precompute_adjacency(t(edges), t(mask), verts.shape[1]),
                          (32, 32), vert_feats=t(feats) if use_input_features else None)
    assert rel_err(got_v.numpy(), want_v) < TOL
    assert rel_err(got_f.numpy(), want_f) < TOL
