"""The kNN + PCA normal estimator of the port (ops/chamfer.py) against the JAX package.

``smallest_eigenvector`` is compared on random, planar, isotropic and
duplicated-point scatter matrices, values and VJP; the estimator, the
estimated-normals ``batched_normal_distance`` and ``mesh_loss`` with
``face_normals=False`` (the JAX side under ``MESHRCNN_FACE_NORMALS=0``) values
and gradients. Tolerances and why:
  * eigenvector values and VJP: 1e-4 of scale where the two smallest
    eigenvalues are apart by >= 1% of the largest. Closer, the eigenvector
    moves by ~eps/gap: the determinant is a cofactor expansion here and an LU
    in JAX, and arccos amplifies its rounding near +-1. There the directions
    agree to 1e-3 in |cos| and the VJP is finite;
  * normals of clouds: a row whose neighbour set differs (Gram- against
    difference-form distances at a near-tie) may get another normal, so
    >= 99% of rows agree to 1e-4 in |cos|; sums of |cos| to 1e-3 relative;
  * gradients through the estimator: 1e-3 of scale, for the same near-tie
    rows and the eigensolver's conditioning.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshrcnn_tpu.core.mesh import MeshBatch as JaxMeshBatch
from meshrcnn_tpu.ops import chamfer as jch
from meshrcnn_tpu.ops.losses import mesh_loss as jax_mesh_loss
from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.ops import chamfer as tch
from meshrcnn_tpu_torch.ops.losses import mesh_loss
from tests.torch_parity import Replay, rel_err, sampler_draws, t

ROW_AGREEMENT = 0.99


def _scatter(kind: str, n: int = 96) -> np.ndarray:
    rng = np.random.RandomState({"random": 0, "planar": 1, "isotropic": 2,
                                 "duplicated": 3}[kind])
    if kind == "isotropic":
        return (np.eye(3) * rng.uniform(0.1, 2.0, (n, 1, 1))).astype(np.float32)
    if kind == "duplicated":
        # ten neighbours that are copies of 1, 2, 3 or 4 distinct points:
        # S = 0, collinear (rank 1), planar (rank 2) and full-rank neighbourhoods
        base = rng.randn(n, 4, 3).astype(np.float32)
        distinct = np.arange(n) % 4 + 1
        pick = (rng.randint(0, 4, (n, 10)) % distinct[:, None])
        Y = np.take_along_axis(base, pick[..., None], 1)
    else:
        Y = rng.randn(n, 10, 3).astype(np.float32)
    if kind == "planar":
        Y[..., 2] = 0.0
        Y = Y @ np.linalg.qr(rng.randn(n, 3, 3))[0].astype(np.float32)
    Y = Y - Y.mean(1, keepdims=True)
    return np.einsum("nkd,nke->nde", Y, Y).astype(np.float32)


def _relative_gap(S):
    ev = np.linalg.eigvalsh(S.astype(np.float64))
    return (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30)


@pytest.mark.parametrize("kind", ["random", "planar", "isotropic", "duplicated"])
def test_smallest_eigenvector_values_and_vjp_match_jax(kind):
    """Rows whose two smallest eigenvalues are apart by >= 1% of the largest
    match to 1e-4 of scale, values and VJP. Closer ones are ill-conditioned:
    the eigenvector moves by ~eps/gap, and JAX's own result moves by as much
    when its LU determinant is swapped for a cofactor one; there the two agree
    in direction (|cos| >= 0.999) and the VJP is finite. Degenerate rows take
    the +z fallback on both sides."""
    S = _scatter(kind)
    cot = np.random.RandomState(9).randn(S.shape[0], 3).astype(np.float32)
    want, vjp = jax.vjp(jch.smallest_eigenvector, jnp.asarray(S))
    (want_grad,) = vjp(jnp.asarray(cot))
    want, want_grad = np.asarray(want), np.asarray(want_grad)
    St = t(S).requires_grad_(True)
    got = tch.smallest_eigenvector(St)
    (got_grad,) = torch.autograd.grad(got, St, t(cot))
    got, got_grad = got.detach().numpy(), got_grad.numpy()

    well = _relative_gap(S) >= 1e-2
    if well.any():
        assert rel_err(got[well], want[well]) < 1e-4
        assert rel_err(got_grad[well], want_grad[well]) < 1e-4
    assert _rows_agree(got, want, 1e-3) == 1.0
    assert np.isfinite(got_grad).all()
    fallback = (want == [0.0, 0.0, 1.0]).all(-1)
    np.testing.assert_array_equal(got[fallback], want[fallback])
    if kind == "isotropic":
        assert fallback.all()
    if kind == "duplicated":                     # S = 0 rows fall back, with no gradient
        zero = np.arange(S.shape[0]) % 4 == 0
        assert fallback[zero].all() and not got_grad[zero].any()
    if kind in ("random", "planar"):
        assert well.mean() > 0.5


def test_collinear_neighbourhoods_escape_the_degenerate_fallback():
    """A fault of the reference, reproduced: a rank-1 scatter (collinear
    neighbours) has a repeated smallest eigenvalue, which the solver means to
    catch as degenerate, but the arccos clip of r to +-(1 - 1e-6) opens a gap
    of ~5e-4 of the largest eigenvalue, above the 1e-4 threshold. Both
    packages then return a non-fallback vector with a gradient in the
    thousands."""
    S = _scatter("duplicated")[1::4]                  # two distinct points each
    cot = np.random.RandomState(9).randn(S.shape[0], 3).astype(np.float32)
    want, vjp = jax.vjp(jch.smallest_eigenvector, jnp.asarray(S))
    St = t(S).requires_grad_(True)
    got = tch.smallest_eigenvector(St)
    (got_grad,) = torch.autograd.grad(got, St, t(cot))
    for v in (np.asarray(want), got.detach().numpy()):
        assert not (v == [0.0, 0.0, 1.0]).all(-1).any()
    assert np.abs(np.asarray(vjp(jnp.asarray(cot))[0])).max() > 1e2
    assert np.abs(got_grad.numpy()).max() > 1e2


def _rows_agree(a, b, tol=1e-4):
    cos = np.abs((a * b).sum(-1)) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)
    return np.mean(cos > 1.0 - tol)


def _surface_cloud(seed, B, N):
    """Points on a bumpy sheet: a surface, as sampled clouds are."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1, 1, (B, N, 2))
    z = 0.3 * np.sin(2.0 * xy[..., :1]) * np.cos(3.0 * xy[..., 1:]) + 0.01 * rng.randn(B, N, 1)
    return np.concatenate([xy, z], -1).astype(np.float32)


@pytest.mark.parametrize("N", [600, 1500])
def test_batched_compute_normals_matches_jax(N):
    pts = _surface_cloud(N, 2, N)
    want = np.asarray(jch.batched_compute_normals(jnp.asarray(pts), k=10))
    got = tch.batched_compute_normals(t(pts), k=10).numpy()
    assert _rows_agree(got, want) >= ROW_AGREEMENT
    single = tch.compute_normals(t(pts[1]), k=10).numpy()
    assert _rows_agree(single, want[1]) >= ROW_AGREEMENT


@pytest.mark.parametrize("N", [500, 1300])
def test_estimated_normal_distance_and_its_gradient_match_jax(N):
    p, q = _surface_cloud(11, 2, N), _surface_cloud(12, 2, N - 100)
    rng = np.random.RandomState(13)
    i_p = rng.randint(0, N - 100, (2, N)).astype(np.int32)
    i_q = rng.randint(0, N, (2, N - 100)).astype(np.int32)
    cot = rng.rand(2, 2).astype(np.float32)

    def jax_fn(a, b):
        return jnp.stack(jch.batched_normal_distance(a, b, jnp.asarray(i_p),
                                                     jnp.asarray(i_q), k=10), 1)
    want, vjp = jax.vjp(jax_fn, jnp.asarray(p), jnp.asarray(q))
    want_grads = vjp(jnp.asarray(cot))
    tp, tq = t(p).requires_grad_(True), t(q).requires_grad_(True)
    got = torch.stack(tch.batched_normal_distance(tp, tq, t(i_p), t(i_q), k=10), 1)
    got_grads = torch.autograd.grad(got, (tp, tq), t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-3)
    for g, w in zip(got_grads, want_grads):
        assert rel_err(g.numpy(), w) < 1e-3
    single = tch.normal_distance(tp[0].detach(), tq[0].detach(), t(i_p[0]), t(i_q[0]), k=10)
    np.testing.assert_allclose([v.item() for v in single], np.asarray(want)[0], rtol=1e-3)


def test_mesh_loss_with_estimated_normals_matches_jax(monkeypatch):
    """One refinement stage with ``face_normals=False``: chamfer, normal and
    edge values and the gradient wrt the predicted vertices. The 1500-point
    clouds take the candidate path (s=8, C=188)."""
    monkeypatch.setenv("MESHRCNN_FACE_NORMALS", "0")
    rng = np.random.RandomState(14)
    B, V, F, n = 2, 60, 90, 1500
    verts = (rng.randn(B, V, 3) * 0.5).astype(np.float32)
    faces = rng.randint(0, V, (B, F, 3)).astype(np.int32)
    fmask = rng.rand(B, F) > 0.1
    edges = rng.randint(0, V, (B, 100, 2)).astype(np.int32)
    emask = rng.rand(B, 100) > 0.2
    gt_v = (rng.randn(B, 40, 3) * 0.5).astype(np.float32)
    gt_f = rng.randint(0, 40, (B, 50, 3)).astype(np.int32)
    gt_m = np.ones((B, 50), bool)
    key = jax.random.PRNGKey(15)
    jmesh = JaxMeshBatch(verts=jnp.asarray(verts), verts_mask=jnp.ones((B, V), bool),
                         faces=jnp.asarray(faces), faces_mask=jnp.asarray(fmask),
                         edges=jnp.asarray(edges), edges_mask=jnp.asarray(emask))
    w = np.array([1.0, 0.7, 0.3], np.float32)

    def jax_fn(v):
        c, nrm, e = jax_mesh_loss(key, v, jmesh, jnp.asarray(gt_v), jnp.asarray(gt_f),
                                  jnp.asarray(gt_m), point_cloud_size=n)
        return w[0] * c + w[1] * nrm + w[2] * e, (c, nrm, e)
    (_, want), want_grad = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(verts))

    k_pred, k_gt = jax.random.split(key)
    tmesh = MeshBatch(verts=t(verts), verts_mask=torch.ones((B, V), dtype=torch.bool),
                      faces=t(faces), faces_mask=t(fmask), edges=t(edges),
                      edges_mask=t(emask))
    tv = t(verts).requires_grad_(True)
    got = mesh_loss(tv, tmesh, t(gt_v), t(gt_f), t(gt_m),
                    Replay(sampler_draws(k_pred, B, n) + sampler_draws(k_gt, B, n)),
                    point_cloud_size=n, face_normals=False)
    (got_grad,) = torch.autograd.grad(sum(float(wi) * g for wi, g in zip(w, got)), tv)
    for g, wv, rtol in zip(got, want, (1e-4, 1e-3, 1e-6)):
        np.testing.assert_allclose(g.item(), float(wv), rtol=rtol)
    assert rel_err(got_grad.numpy(), want_grad) < 1e-3
