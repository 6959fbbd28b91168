"""K1 (ops/chamfer_cuda.py) and ops/chamfer.py of the port against the JAX package.

On the CPU the K1 wrapper runs its plain twin; the JAX side is its CPU
reference, ``nearest_neighbor`` (Gram form) plus ``_exact_sums_batched``.
Tolerances (from the K1 contract):
  * argmin agreement >= 99.9%; where indices differ, the two chosen points'
    exact distances agree to 1e-6 (Gram and difference form round differently,
    so near-ties may go either way);
  * sums recomputed from the same indices match ``_exact_sums_batched`` to
    rtol 1e-5, and JAX's ``chamfer_distance`` (Gram-form minima) to rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.ops.chamfer import batched_normal_distance as jax_normal_distance
from meshrcnn_tpu.ops.chamfer import chamfer_distance as jax_chamfer_distance
from meshrcnn_tpu.ops.chamfer import nearest_neighbor as jax_nearest_neighbor
from meshrcnn_tpu.ops.chamfer_pallas import _exact_sums_batched
from meshrcnn_tpu_torch.ops import chamfer_cuda
from meshrcnn_tpu_torch.ops.chamfer import (batched_normal_distance, chamfer_distance,
                                            nearest_neighbor)

ARGMIN_AGREEMENT = 0.999
DIST_TOL = 1e-6


def _clouds(seed, B, N, M, ties):
    rng = np.random.RandomState(seed)
    if ties:   # small integers: every distance exact, many exact ties
        return (rng.randint(0, 4, (B, N, 3)).astype(np.float32),
                rng.randint(0, 4, (B, M, 3)).astype(np.float32))
    return (rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
            rng.uniform(-1, 1, (B, M, 3)).astype(np.float32))


def _check_side(x, y, idx_port, idx_jax):
    agree = np.mean(idx_port == idx_jax)
    assert agree >= ARGMIN_AGREEMENT, agree
    diff = idx_port != idx_jax
    if diff.any():
        d_port = ((x[diff] - y[idx_port[diff]]) ** 2).sum(-1)
        d_jax = ((x[diff] - y[idx_jax[diff]]) ** 2).sum(-1)
        assert np.abs(d_port - d_jax).max() <= DIST_TOL


@pytest.mark.parametrize("B,N,M,ties", [(2, 300, 211, False), (1, 517, 1030, False),
                                        (3, 100, 77, True), (2, 64, 700, True)])
def test_k1_matches_jax_nearest_neighbor(B, N, M, ties):
    p, q = _clouds(B * N + M, B, N, M, ties)
    d_p, i_p, d_q, i_q = [x.numpy() for x in chamfer_cuda.nn_bidir(torch.from_numpy(p),
                                                                   torch.from_numpy(q))]
    assert d_p.shape == (B, N) and d_q.shape == (B, M)
    assert i_p.dtype == np.int32 and i_q.dtype == np.int32
    for b in range(B):
        jd_p, ji_p = jax_nearest_neighbor(jnp.asarray(p[b]), jnp.asarray(q[b]), 256)
        jd_q, ji_q = jax_nearest_neighbor(jnp.asarray(q[b]), jnp.asarray(p[b]), 256)
        _check_side(p[b], q[b], i_p[b], np.asarray(ji_p))
        _check_side(q[b], p[b], i_q[b], np.asarray(ji_q))
        if ties:   # exact arithmetic: the lowest-index rule alone decides
            np.testing.assert_array_equal(i_p[b], np.asarray(ji_p))
            np.testing.assert_array_equal(i_q[b], np.asarray(ji_q))
        # the returned minima are the difference-form distances at the indices
        np.testing.assert_array_equal(d_p[b], ((p[b] - q[b][i_p[b]]) ** 2).sum(-1))


@pytest.mark.parametrize("B,N,M", [(2, 400, 333), (3, 128, 1000)])
def test_chamfer_sums_match_jax(B, N, M):
    p, q = _clouds(7 + N, B, N, M, ties=False)
    s_p, i_p, s_q, i_q = chamfer_cuda.chamfer_sums_batched(torch.from_numpy(p),
                                                           torch.from_numpy(q))
    ref_p, ref_q = _exact_sums_batched(jnp.asarray(p), jnp.asarray(q),
                                       jnp.asarray(i_p.numpy()), jnp.asarray(i_q.numpy()))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(ref_p), rtol=1e-5)
    np.testing.assert_allclose(s_q.numpy(), np.asarray(ref_q), rtol=1e-5)
    for b in range(B):
        jp, _, jq, _ = jax_chamfer_distance(jnp.asarray(p[b]), jnp.asarray(q[b]), 256)
        np.testing.assert_allclose(s_p[b].item(), float(jp), rtol=1e-4)
        np.testing.assert_allclose(s_q[b].item(), float(jq), rtol=1e-4)


def test_single_sample_forms_match_jax():
    p, q = _clouds(3, 1, 250, 190, ties=False)
    d, idx = nearest_neighbor(torch.from_numpy(p[0]), torch.from_numpy(q[0]))
    jd, jidx = jax_nearest_neighbor(jnp.asarray(p[0]), jnp.asarray(q[0]), 64)
    _check_side(p[0], q[0], idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=DIST_TOL)
    s_p, _, s_q, _ = chamfer_distance(torch.from_numpy(p[0]), torch.from_numpy(q[0]))
    jp, _, jq, _ = jax_chamfer_distance(jnp.asarray(p[0]), jnp.asarray(q[0]))
    np.testing.assert_allclose([s_p.item(), s_q.item()], [float(jp), float(jq)], rtol=1e-4)


def test_plain_tile_size_does_not_change_the_result(monkeypatch):
    p, q = _clouds(11, 2, 300, 700, ties=True)
    p, q = torch.from_numpy(p), torch.from_numpy(q)
    monkeypatch.setattr(chamfer_cuda, "PLAIN_TILE", 4096)
    ref = chamfer_cuda.nn_bidir_plain(p, q)
    for tile in (1, 7, 256):
        monkeypatch.setattr(chamfer_cuda, "PLAIN_TILE", tile)
        for a, b in zip(chamfer_cuda.nn_bidir_plain(p, q), ref):
            assert torch.equal(a, b)


def test_normal_distance_matches_jax_given_normals():
    rng = np.random.RandomState(5)
    B, N, M = 2, 90, 70
    n_p = rng.randn(B, N, 3).astype(np.float32)
    n_q = rng.randn(B, M, 3).astype(np.float32)
    n_p /= np.linalg.norm(n_p, axis=-1, keepdims=True)
    n_q /= np.linalg.norm(n_q, axis=-1, keepdims=True)
    i_p = rng.randint(0, M, (B, N)).astype(np.int32)
    i_q = rng.randint(0, N, (B, M)).astype(np.int32)
    got = batched_normal_distance(torch.zeros((B, N, 3)), torch.zeros((B, M, 3)),
                                  torch.from_numpy(i_p), torch.from_numpy(i_q),
                                  normals_p=torch.from_numpy(n_p),
                                  normals_q=torch.from_numpy(n_q))
    want = jax_normal_distance(jnp.zeros((B, N, 3)), jnp.zeros((B, M, 3)),
                               jnp.asarray(i_p), jnp.asarray(i_q),
                               normals_p=jnp.asarray(n_p), normals_q=jnp.asarray(n_q))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


@pytest.mark.parametrize("case", ["dtype", "rank", "width", "contiguous", "batch", "empty"])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(case):
    p = torch.zeros((2, 5, 3))
    q = torch.zeros((2, 4, 3))
    bad = {"dtype": (p.double(), q), "rank": (p[0], q), "width": (p[..., :2], q),
           "contiguous": (torch.zeros((2, 3, 5)).transpose(1, 2), q),
           "batch": (p, q[:1]), "empty": (p[:, :0], q)}[case]
    with pytest.raises((TypeError, ValueError)):
        chamfer_cuda.nn_bidir(*bad)


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    before = chamfer_cuda.nn_bidir.launches
    p, q = _clouds(1, 1, 20, 30, ties=False)
    chamfer_cuda.nn_bidir(torch.from_numpy(p), torch.from_numpy(q))
    assert chamfer_cuda.nn_bidir.launches == before
    with pytest.raises(ValueError):
        chamfer_cuda._launch(torch.from_numpy(p), torch.from_numpy(q))
