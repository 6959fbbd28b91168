"""ops/graph_conv.py, ops/vert_align.py and utils/image.py of the port against the JAX package.

Aggregation tolerance: the JAX package sums each vertex's neighbours as a
difference of two prefix sums over all E edges, which loses about eps * |prefix|
to cancellation; the port's ``index_add_`` sums only the vertex's own edges.
Both are held to a float64 reference: the port to 1e-5 relative, JAX to its
own cancellation bound, and the two to each other at 1e-4 of the feature scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.ops.graph_conv import aggregate_neighbours as jax_aggregate
from meshrcnn_tpu.ops.vert_align import project_verts as jax_project
from meshrcnn_tpu.ops.vert_align import vert_align as jax_vert_align
from meshrcnn_tpu.utils.image import resize_bilinear_align_corners as jax_resize
from meshrcnn_tpu_torch.ops.graph_conv import aggregate_neighbours, precompute_adjacency
from meshrcnn_tpu_torch.ops.vert_align import project_verts, vert_align
from meshrcnn_tpu_torch.utils.image import resize_bilinear_align_corners, scaled_size
from tests.torch_parity import rel_err, t


def _edges(seed, B, V, E, masked=0.3):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, V, (B, E))
    b = rng.randint(0, V, (B, E))
    edges = np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(np.int32)
    mask = rng.rand(B, E) > masked
    # padded rows hold junk that must not count: out-of-place vertex ids too
    edges[~mask] = rng.randint(0, V, (int((~mask).sum()), 2))
    return edges, mask


def _reference(feats, edges, mask):
    out = np.zeros(feats.shape, dtype=np.float64)
    for b in range(feats.shape[0]):
        for (lo, hi), m in zip(edges[b], mask[b]):
            if m:
                out[b, lo] += feats[b, hi]
                out[b, hi] += feats[b, lo]
    return out


@pytest.mark.parametrize("B,V,E,C", [(2, 50, 300, 4), (3, 128, 700, 16)])
def test_aggregation_matches_jax_and_ignores_padded_edges(B, V, E, C):
    edges, mask = _edges(B * V + E, B, V, E)
    feats = np.random.RandomState(C).randn(B, V, C).astype(np.float32)
    topo = precompute_adjacency(t(edges), t(mask), V)
    got = aggregate_neighbours(t(feats), topo).numpy()
    want = np.asarray(jax_aggregate(jnp.asarray(feats), jnp.asarray(edges),
                                    jnp.asarray(mask)))
    ref = _reference(feats, edges, mask)
    assert rel_err(got, ref) < 1e-5
    assert rel_err(want, ref) < 1e-6 * E
    assert rel_err(got, want) < 1e-4
    # an all-padded batch aggregates to zero
    none = precompute_adjacency(t(edges), torch.zeros_like(t(mask)), V)
    assert not aggregate_neighbours(t(feats), none).any()


def test_vert_align_matches_jax():
    rng = np.random.RandomState(0)
    B, V = 2, 60
    verts = rng.uniform(-1, 1, (B, V, 3)).astype(np.float32)
    verts[..., 2] -= 2.0                      # in front of the camera
    verts[0, 0, 2] = 0.0                      # hits safe_z
    maps = [rng.randn(B, s, s, c).astype(np.float32) for s, c in ((12, 3), (6, 5), (3, 5))]
    for combine, fms in (("concat", maps), ("sum", maps[1:])):
        got = vert_align([t(m) for m in fms], t(verts), (48, 48), combine=combine)
        want = jax_vert_align([jnp.asarray(m) for m in fms], jnp.asarray(verts), (48, 48),
                              combine=combine)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(project_verts(t(verts), (48, 40)),
                    jax_project(jnp.asarray(verts), (48, 40))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("in_hw,scale", [((5, 5), 4.8), ((2, 3), 4.8), ((4, 4), 0.25)])
def test_resize_bilinear_align_corners_matches_jax(in_hw, scale):
    x = np.random.RandomState(1).randn(2, *in_hw, 3).astype(np.float32)
    out_hw = (scaled_size(in_hw[0], scale), scaled_size(in_hw[1], scale))
    got = resize_bilinear_align_corners(t(x), out_hw)
    want = jax_resize(jnp.asarray(x), out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
