"""ops/cubify.py of the port against the JAX package: exact equality of verts,
faces, edges, masks and overflow counts, slot by slot (grids like those of
tests/test_cubify.py plus random batches and overflowing capacities)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.ops.cubify import batched_edges_from_faces as jax_edges
from meshrcnn_tpu.ops.cubify import cubify as jax_cubify
from meshrcnn_tpu_torch.ops.cubify import batched_edges_from_faces, cubify


def _grid(name):
    g = np.zeros((1, 4, 4, 4), dtype=np.float32)
    if name == "single":
        g[0, 1, 2, 1] = 1.0
    elif name == "adjacent":
        g[0, 1, 1, 1] = g[0, 1, 1, 2] = 1.0
    elif name == "empty":
        pass
    elif name == "random":
        g = np.random.RandomState(0).rand(3, 5, 6, 7).astype(np.float32)
    elif name == "batch_mixed":
        g = np.zeros((3, 4, 5, 4), dtype=np.float32)
        g[0, 1:3, 1:4, 1:3] = 0.9
        g[2] = np.random.RandomState(1).rand(4, 5, 4)
    return g


def _assert_same(got_mesh, got_ovf, want_mesh, want_ovf):
    for k in ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask"):
        np.testing.assert_array_equal(getattr(got_mesh, k).numpy(),
                                      np.asarray(getattr(want_mesh, k)), err_msg=k)
    for k in ("verts", "faces", "edges"):
        np.testing.assert_array_equal(getattr(got_ovf, k).numpy(),
                                      np.asarray(getattr(want_ovf, k)), err_msg=k)


@pytest.mark.parametrize("name,threshold,caps", [
    ("single", 0.5, (16, 24, 32)),
    ("adjacent", 0.5, (32, 48, 64)),
    ("empty", 0.5, (8, 8, 8)),
    ("random", 0.6, (256, 512, 1024)),
    ("random", 0.3, (64, 100, 150)),          # every capacity overflows
    ("batch_mixed", 0.5, (128, 256, 400)),
])
def test_cubify_matches_jax_slot_by_slot(name, threshold, caps):
    g = _grid(name)
    kw = dict(vert_capacity=caps[0], face_capacity=caps[1], edge_capacity=caps[2])
    want = jax_cubify(jnp.asarray(g), threshold, **kw)
    got = cubify(torch.from_numpy(g), threshold, **kw)
    _assert_same(*got, *want)


def test_single_voxel_golden():
    mesh, ovf = cubify(torch.from_numpy(_grid("single")), 0.5, vert_capacity=16,
                       face_capacity=24, edge_capacity=32)
    assert (mesh.num_verts().item(), mesh.num_faces().item(),
            mesh.num_edges().item()) == (8, 12, 23)
    assert not ovf.any().item()


def test_edges_from_faces_matches_jax():
    rng = np.random.RandomState(3)
    faces = rng.randint(0, 40, (2, 70, 3)).astype(np.int32)
    mask = rng.rand(2, 70) > 0.3
    for cap in (300, 60):
        got = batched_edges_from_faces(torch.from_numpy(faces), torch.from_numpy(mask), cap)
        want = jax_edges(jnp.asarray(faces), jnp.asarray(mask), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
