"""K3 / K4 (ops/knn_cuda.py), K2 and the kNN of ops/chamfer.py against the JAX package.

On the CPU the K3 wrapper runs its plain twin, whose candidate stage is
``knn_candidates_plain``. The JAX side is the Pallas
kernel itself, run in interpret mode (``pl.pallas_call(..., interpret=True)``,
patched in for the test), and its CPU path, ``knn`` / ``batched_knn``.
Tolerances and why:
  * candidates against a numpy first-minimum brute force: exact (both are
    difference form on lattice points, where every distance is exact);
  * candidates against the Pallas kernel: indices equal in >= 99.9% of entries,
    values to 1e-5 absolute (its Gram form |p|^2 + |q|^2 - 2 p.q rounds
    otherwise, so near-ties may go either way);
  * kNN against JAX's: neighbour sets equal in >= 99% of rows (top-k may order
    and break equal distances differently, and PCA is invariant to the order),
    distances rtol 1e-5 / atol 1e-5 (Gram against difference form).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from meshrcnn_tpu.ops import chamfer_pallas
from meshrcnn_tpu.ops.chamfer import batched_knn as jax_batched_knn
from meshrcnn_tpu.ops.chamfer import knn as jax_knn
from meshrcnn_tpu_torch.ops import chamfer_cuda, knn_cuda
from meshrcnn_tpu_torch.ops.chamfer import batched_knn, knn, knn_subtile

SET_AGREEMENT = 0.99


def _cloud(seed, *shape, lattice=False):
    rng = np.random.RandomState(seed)
    if lattice:
        return rng.randint(0, 5, shape + (3,)).astype(np.float32)
    return rng.uniform(-1, 1, shape + (3,)).astype(np.float32)


def _brute_force(p, q, s):
    """First-minimum candidates of every run of s points, in numpy."""
    d = ((p[:, :, None] - q[:, None]) ** 2).sum(-1)             # [B, N, M]
    M = q.shape[1]
    C = -(-M // s)
    d = np.concatenate([d, np.full(d.shape[:2] + (C * s - M,), np.inf, np.float32)], 2)
    d = d.reshape(d.shape[:2] + (C, s))
    arg = d.argmin(-1)
    return np.take_along_axis(d, arg[..., None], -1)[..., 0], arg + s * np.arange(C)


def _set_agreement(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return np.mean([set(x) == set(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("N,M,s", [(100, 77, 8), (300, 1000, 16), (64, 700, 64)])
def test_k3_twin_is_the_first_minimum_of_each_run(N, M, s):
    p, q = _cloud(0, 2, N, lattice=True), _cloud(1, 2, M, lattice=True)
    vals, idx = knn_cuda.knn_candidates_plain(torch.from_numpy(p), torch.from_numpy(q), s)
    want_v, want_i = _brute_force(p, q, s)
    assert vals.shape == (2, N, -(-M // s)) and idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), want_v)
    np.testing.assert_array_equal(idx.numpy(), want_i)


@pytest.mark.parametrize("N,M,s", [(1000, 900, 16), (600, 1100, 64)])
def test_k3_twin_matches_the_pallas_kernel_interpreted(monkeypatch, N, M, s):
    monkeypatch.setattr(chamfer_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    p, q = _cloud(2, 2, N), _cloud(3, 2, M)
    jv, ji = chamfer_pallas.knn_candidates_pallas_batched(jnp.asarray(p), jnp.asarray(q),
                                                          subtile=s)
    vals, idx = knn_cuda.knn_candidates_plain(torch.from_numpy(p), torch.from_numpy(q), s)
    C = vals.shape[-1]
    jv, ji = np.asarray(jv), np.asarray(ji)
    # the kernel's extra candidates come from its padding of q and never win
    assert (jv[..., C:] > 1e6).all()
    assert np.mean(idx.numpy() == ji[..., :C]) >= 0.999
    np.testing.assert_allclose(vals.numpy(), jv[..., :C], atol=1e-5)


def test_k4_is_a_b1_launch_of_k3_and_k2_of_k1():
    p, q = _cloud(4, 3, 200), _cloud(5, 3, 300)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    vals, idx = knn_cuda.knn_topk_batched(tp, tq, 16, 10)
    sums = chamfer_cuda.chamfer_sums_batched(tp, tq)
    for b in range(3):
        v1, i1 = knn_cuda.knn_topk(tp[b], tq[b], 16, 10)
        assert torch.equal(v1, vals[b]) and torch.equal(i1, idx[b])
        for one, batched in zip(chamfer_cuda.chamfer_sums_fused(tp[b], tq[b]), sums):
            assert torch.equal(one, batched[b])


def test_plain_tile_size_does_not_change_the_candidates(monkeypatch):
    p, q = torch.from_numpy(_cloud(6, 2, 150, lattice=True)), torch.from_numpy(_cloud(7, 2, 700))
    ref = knn_cuda.knn_candidates_plain(p, q, 8)
    for tile in (1, 24, 256):
        monkeypatch.setattr(knn_cuda, "PLAIN_TILE", tile)
        for a, b in zip(knn_cuda.knn_candidates_plain(p, q, 8), ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["subtile", "zero_subtile", "dtype", "width", "batch"])
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(case):
    p, q = torch.zeros((2, 5, 3)), torch.zeros((2, 4, 3))
    args = {"subtile": (p, q, 48, 3), "zero_subtile": (p, q, 0, 3),
            "dtype": (p.double(), q, 8, 3), "width": (p[..., :2], q, 8, 3),
            "batch": (p, q[:1], 8, 3)}[case]
    with pytest.raises((TypeError, ValueError)):
        knn_cuda.knn_topk_batched(*args)


@pytest.mark.parametrize("s,k", [(2, 3), (8, 0), (8, knn_cuda.MAX_K + 1)])
def test_k3_wrapper_names_the_limits_of_subtile_and_k(s, k):
    p = torch.zeros((1, 5, 3))
    with pytest.raises(ValueError, match=f"{knn_cuda.MAX_K}|at least 4"):
        knn_cuda.knn_topk_batched(p, p, s, k)


def test_cpu_tensors_take_the_k3_twin_and_count_no_launch():
    counts = (knn_cuda.knn_topk_batched.launches, knn_cuda.knn_topk.launches,
              chamfer_cuda.chamfer_sums_fused.launches)
    p = torch.from_numpy(_cloud(8, 1, 40))
    knn_cuda.knn_topk(p[0], p[0], 8, 10)
    chamfer_cuda.chamfer_sums_fused(p[0], p[0])
    assert counts == (knn_cuda.knn_topk_batched.launches,
                      knn_cuda.knn_topk.launches,
                      chamfer_cuda.chamfer_sums_fused.launches)
    with pytest.raises(ValueError):
        knn_cuda._launch(p, p, 8, 10)


@pytest.mark.parametrize("M,want", [(700, 8), (1500, 8), (2500, 16), (10000, 64),
                                    (20000, 64)])
def test_subtile_follows_the_kernel_rule(M, want):
    assert knn_subtile(M, 10) == want


@pytest.mark.parametrize("M", [700, 1500, 2500])
def test_knn_matches_jax(M):
    """M=700 takes the exact path; 1500 (s=8, ragged last run) and 2500 (s=16)
    the candidate path."""
    p = _cloud(9, 2, M)
    jd, ji = jax_batched_knn(jnp.asarray(p), jnp.asarray(p), 10)
    d, i = batched_knn(torch.from_numpy(p), torch.from_numpy(p), 10)
    assert i.dtype == torch.int32 and d.shape == (2, M, 10)
    assert _set_agreement(i.numpy(), np.asarray(ji)) >= SET_AGREEMENT
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    q = _cloud(10, M // 2)
    jd1, ji1 = jax_knn(jnp.asarray(p[0]), jnp.asarray(q), 10)
    d1, i1 = knn(torch.from_numpy(p[0]), torch.from_numpy(q), 10)
    assert _set_agreement(i1.numpy(), np.asarray(ji1)) >= SET_AGREEMENT
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd1), rtol=1e-5, atol=1e-5)


def test_knn_with_fewer_points_than_k_repeats_the_last():
    p = _cloud(11, 6)
    jd, ji = jax_knn(jnp.asarray(p), jnp.asarray(p), 10)
    d, i = knn(torch.from_numpy(p), torch.from_numpy(p), 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
