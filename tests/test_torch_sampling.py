"""ops/sampling.py and ops/losses.py of the port against the JAX package.

The JAX sampler's draws (u, xi1, xi2 from ``jax.random.split(key, 3)``) are
reproduced and injected, so both sides sample the same points. Tolerance
1e-5 absolute on points and normals: the cumsum, barycentric sum and
normalisation round in another order, nothing more. The face choice itself
must agree exactly (a flip would show as an O(1) error).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.core.mesh import MeshBatch as JaxMeshBatch
from meshrcnn_tpu.ops.losses import edge_loss as jax_edge_loss
from meshrcnn_tpu.ops.losses import mesh_loss as jax_mesh_loss
from meshrcnn_tpu.ops.losses import voxel_loss as jax_voxel_loss
from meshrcnn_tpu.ops.sampling import batched_sample_points as jax_sample
from meshrcnn_tpu_torch.core.mesh import MeshBatch, normalize_verts
from meshrcnn_tpu_torch.ops.losses import edge_loss, mesh_loss, voxel_loss
from meshrcnn_tpu_torch.ops.sampling import batched_sample_points, uniform_from
from tests.torch_parity import Replay, sampler_draws, t

TOL = 1e-5


def _meshes(seed, B=3, V=40, F=60, scale=2.0):
    """Random padded meshes; sample 1 has no faces at all (an invalid mesh)."""
    rng = np.random.RandomState(seed)
    verts = (rng.randn(B, V, 3) * scale).astype(np.float32)
    faces = rng.randint(0, V, (B, F, 3)).astype(np.int32)
    mask = np.zeros((B, F), dtype=bool)
    mask[0, :45] = True
    mask[2, :] = True
    return verts, faces, mask


@pytest.mark.parametrize("normalize,return_normals", [(True, True), (False, True),
                                                      (True, False)])
def test_sampler_matches_jax_with_injected_draws(normalize, return_normals):
    verts, faces, mask = _meshes(0)
    key = jax.random.PRNGKey(3)
    n = 500
    want = jax_sample(key, jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(mask),
                      n, normalize=normalize, return_normals=return_normals)
    got = batched_sample_points(t(verts), t(faces), t(mask), n,
                                Replay(sampler_draws(key, 3, n)), normalize=normalize,
                                return_normals=return_normals)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [True, False, True]
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    assert not got[0][1].any()


def test_sampler_generator_draws_are_reproducible():
    verts, faces, mask = _meshes(1)
    runs = [batched_sample_points(t(verts), t(faces), t(mask), 64,
                                  uniform_from(torch.Generator().manual_seed(9)))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_normalize_verts_matches_jax_with_mask():
    from meshrcnn_tpu.core.mesh import normalize_verts as jax_normalize
    rng = np.random.RandomState(2)
    v = (rng.randn(30, 3) * 3).astype(np.float32)
    m = rng.rand(30) > 0.3
    np.testing.assert_allclose(normalize_verts(t(v), t(m)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(v), jnp.asarray(m))),
                               atol=TOL)
    np.testing.assert_allclose(normalize_verts(t(v)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(v))), atol=TOL)


def test_voxel_and_edge_losses_match_jax():
    rng = np.random.RandomState(4)
    pred = rng.rand(2, 6, 6, 6).astype(np.float32)
    pred[0, 0, 0, :2] = [0.0, 1.0]            # exercises the clamp
    gt = (rng.rand(2, 6, 6, 6) > 0.5).astype(np.float32)
    np.testing.assert_allclose(voxel_loss(t(pred), t(gt)).item(),
                               float(jax_voxel_loss(jnp.asarray(pred), jnp.asarray(gt))),
                               rtol=1e-6)
    verts = rng.randn(2, 20, 3).astype(np.float32)
    edges = rng.randint(0, 20, (2, 30, 2)).astype(np.int32)
    emask = rng.rand(2, 30) > 0.4
    np.testing.assert_allclose(
        edge_loss(t(verts), t(edges), t(emask)).item(),
        float(jax_edge_loss(jnp.asarray(verts), jnp.asarray(edges), jnp.asarray(emask))),
        rtol=1e-6)


def test_mesh_loss_matches_jax_with_injected_draws():
    """One refinement stage: chamfer (rtol 1e-4, Gram vs difference form),
    normal (rtol 1e-4) and edge (rtol 1e-6) terms."""
    verts, faces, mask = _meshes(6, V=50, F=80, scale=0.5)
    gt_v, gt_f, gt_m = _meshes(7, V=30, F=40, scale=0.5)
    gt_m[1] = True                            # sample 1 is invalid on one side only
    rng = np.random.RandomState(8)
    edges = rng.randint(0, 50, (3, 90, 2)).astype(np.int32)
    emask = rng.rand(3, 90) > 0.2
    n = 400
    key = jax.random.PRNGKey(11)
    jmesh = JaxMeshBatch(verts=jnp.asarray(verts), verts_mask=jnp.ones((3, 50), bool),
                         faces=jnp.asarray(faces), faces_mask=jnp.asarray(mask),
                         edges=jnp.asarray(edges), edges_mask=jnp.asarray(emask))
    want = jax_mesh_loss(key, jnp.asarray(verts), jmesh, jnp.asarray(gt_v),
                         jnp.asarray(gt_f), jnp.asarray(gt_m), point_cloud_size=n,
                         tile=128)
    k_pred, k_gt = jax.random.split(key)
    tmesh = MeshBatch(verts=t(verts), verts_mask=torch.ones((3, 50), dtype=torch.bool),
                      faces=t(faces), faces_mask=t(mask), edges=t(edges),
                      edges_mask=t(emask))
    got = mesh_loss(t(verts), tmesh, t(gt_v), t(gt_f), t(gt_m),
                    Replay(sampler_draws(k_pred, 3, n) + sampler_draws(k_gt, 3, n)),
                    point_cloud_size=n)
    for g, w, rtol in zip(got, want, (1e-4, 1e-4, 1e-6)):
        np.testing.assert_allclose(g.item(), float(w), rtol=rtol)
