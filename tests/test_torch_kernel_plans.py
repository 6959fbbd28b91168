"""What the CPU can reach of the K1 and K3 kernels' designs (ops/chamfer_cuda.py,
ops/knn_cuda.py; the kernels themselves run only on a card).

  * the packed key of K1, (float bits << 32) | index, in numpy: its minimum is
    the first-minimum argmin for non-negative float32;
  * K1's scheme end to end in numpy (per tile pair a minimum and a tile number,
    the minimum key over tiles, a rescan of the winning tile) against the plain
    twin, bit for bit;
  * the launch plans the wrappers compute: every (i, j) pair in exactly one
    block, no run of s points over two spans, the scratch sizes;
  * K3's plain twin against a numpy stable sort of brute-force run minima, and
    K3's scheme (the k best of each span, merged in span order) against it.
All comparisons are exact: lattice clouds make every distance exact, and the
numpy models repeat the twins' float32 operations in the same order.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from meshrcnn_tpu_torch.ops import chamfer_cuda, knn_cuda

INF_BITS = np.uint64(0x7F800000)


def _keys(d, index):
    """(bits(d) << 32) | index for non-negative float32 d."""
    bits = np.ascontiguousarray(d, np.float32).view(np.uint32).astype(np.uint64)
    return (bits << np.uint64(32)) | np.asarray(index, np.uint64)


_nonneg = st.one_of(
    st.floats(0.0, 16.0, width=32),
    st.floats(0.0, 2.0 ** -126, width=32),                 # denormals among them
    st.sampled_from([0.0, float("inf"), 1e-45, 3.4028234663852886e38]))


@settings(max_examples=200, deadline=None)
@given(hnp.arrays(np.float32, st.integers(1, 40), elements=_nonneg), st.randoms())
def test_min_of_packed_keys_is_the_first_minimum(d, rnd):
    keys = _keys(d, np.arange(d.size))
    order = list(range(d.size))
    rnd.shuffle(order)                                  # atomics arrive in any order
    best = np.uint64(0xFFFFFFFFFFFFFFFF)
    for t in order:
        best = min(best, keys[t])
    assert int(best & np.uint64(0xFFFFFFFF)) == int(np.argmin(d))
    assert np.uint32(best >> np.uint64(32)).view(np.float32) == d.min()


def test_packed_keys_order_exact_ties_zero_denormals_and_inf():
    d = np.float32([np.inf, 1e-45, 0.0, 2.0, 0.0, 1e-45, np.inf])
    keys = _keys(d, np.arange(d.size))
    assert [int(k & np.uint64(0xFFFFFFFF)) for k in np.sort(keys)] == [2, 4, 1, 5, 3, 0, 6]
    assert keys.max() < np.uint64(0xFFFFFFFFFFFFFFFF)   # the empty key loses to every offer


def _sqdist(p, q):
    """[N, M] float32 difference-form distances in the twins' operation order."""
    dx = p[:, None, 0] - q[None, :, 0]
    dy = p[:, None, 1] - q[None, :, 1]
    dz = p[:, None, 2] - q[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _k1_model(p, q):
    """K1's scheme for one sample: fmin over each tile pair, keys (bits, tile
    number) reduced by min, the winning tile rescanned for the first equal."""
    N, M = len(p), len(q)
    tile_p, tile_q = chamfer_cuda.TILE_P, chamfer_cuda.TILE_Q
    grid, _ = chamfer_cuda.sweep_plan(1, N, M)
    d = _sqdist(p, q)
    key_p = np.full(N, 0xFFFFFFFFFFFFFFFF, np.uint64)
    key_q = np.full(M, 0xFFFFFFFFFFFFFFFF, np.uint64)
    for a in range(grid[0]):
        for b in range(grid[1]):
            rows, cols = slice(a * tile_p, (a + 1) * tile_p), slice(b * tile_q, (b + 1) * tile_q)
            block = d[rows, cols]
            block = np.where(np.isnan(block), np.inf, block)   # fminf drops a NaN
            for keys, mins, number in ((key_p[rows], block.min(1), b),
                                       (key_q[cols], block.min(0), a)):
                offer = _keys(mins, number)
                offer[mins.view(np.uint32) >= INF_BITS] = 0xFFFFFFFFFFFFFFFF
                np.minimum(keys, offer, out=keys)

    def resolve(keys, dist, tile):
        best = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
        out_d, out_i = np.full(len(keys), np.inf, np.float32), np.zeros(len(keys), np.int32)
        for r, key in enumerate(keys):
            if key != np.uint64(0xFFFFFFFFFFFFFFFF):
                lo = int(key & np.uint64(0xFFFFFFFF)) * tile
                out_d[r] = best[r]
                out_i[r] = lo + np.flatnonzero(dist[r, lo:lo + tile] == best[r])[0]
        return out_d, out_i

    return (*resolve(key_p, d, tile_q), *resolve(key_q, d.T, tile_p))


@pytest.mark.parametrize("N,M,case", [(1, 1, "lattice"), (255, 257, "lattice"),
                                      (600, 256, "lattice"), (513, 300, "same"),
                                      (300, 700, "one point"), (257, 520, "nan")])
def test_k1_scheme_equals_the_plain_twin(N, M, case):
    rng = np.random.RandomState(N + M)
    p = rng.randint(0, 4, (N, 3)).astype(np.float32)
    q = rng.randint(0, 4, (M, 3)).astype(np.float32)
    if case == "same":
        q = np.concatenate([p, p])[:M]
    elif case == "one point":
        p[:], q[:] = 1.0, 1.0
    elif case == "nan":
        p[3, 1] = np.nan
        q[[0, 300], 2] = np.nan
    want = chamfer_cuda.nn_bidir_plain(torch.from_numpy(p)[None], torch.from_numpy(q)[None])
    got = _k1_model(p, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[0].numpy())
    if case == "nan":   # a NaN point is nobody's neighbour and has none itself
        assert got[0][3] == np.inf and got[1][3] == 0
        assert not np.isin(got[1], [0, 300])[np.isfinite(got[0])].any()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N,M", [(1, 1), (255, 1025), (256, 257), (10000, 777)])
def test_k1_plan_covers_every_pair_once(B, N, M):
    grid, words = chamfer_cuda.sweep_plan(B, N, M)
    TP, TQ = chamfer_cuda.TILE_P, chamfer_cuda.TILE_Q
    rows = np.zeros(N, int)
    cols = np.zeros(M, int)
    for a in range(grid[0]):
        rows[a * TP:(a + 1) * TP] += 1
    for b in range(grid[1]):
        cols[b * TQ:(b + 1) * TQ] += 1
    # blocks are the product of row tiles and column tiles: each pair lies in
    # rows[i] * cols[j] blocks
    assert (rows == 1).all() and (cols == 1).all()
    assert (grid[0] - 1) * TP < N <= grid[0] * TP and (grid[1] - 1) * TQ < M <= grid[1] * TQ
    assert grid[2] == B and words == B * (N + M)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("N,M,k", [(10000, 10000, 10), (100, 1025, 16), (257, 255, 64),
                                   (3000, 20000, 1)])
@pytest.mark.parametrize("sms", [1, 132])
def test_k3_plan_covers_every_pair_once_and_splits_no_run(B, N, M, k, sms):
    plan = knn_cuda.topk_plan(B, N, M, k, sms)
    per_block = 64 if k > 16 else 128
    assert (plan.grid[0] - 1) * per_block < N <= plan.grid[0] * per_block
    seen = np.zeros(M, int)
    for sp in range(plan.grid[1]):
        lo, hi = sp * plan.span, min((sp + 1) * plan.span, M)
        assert lo < hi                                   # no empty span
        seen[lo:hi] += 1
        for s in (4, 8, 16, 32, 64, 128, 256):           # a span starts on a run boundary
            assert lo % s == 0
    assert (seen == 1).all()
    assert plan.span % knn_cuda.TILE == 0 and plan.grid[2] == B
    assert plan.scratch == plan.grid[1] * B * k * N
    # q is cut no finer than the blocks the plan aims at need
    blocks = plan.grid[0] * plan.grid[1] * B
    assert plan.grid[1] == 1 or blocks < 2 * knn_cuda.BLOCKS_PER_SM * sms + plan.grid[0] * B


def test_k3_plan_fills_the_card_at_the_estimator_shapes():
    """Self-kNN of 10,000 points on 132 SMs, at B=3 and at B=1: at least
    ``BLOCKS_PER_SM`` blocks an SM, and at most 20 spans of partial lists."""
    for B in (1, 3):
        plan = knn_cuda.topk_plan(B, 10000, 10000, 10, 132)
        assert plan.grid[0] * plan.grid[1] * B >= knn_cuda.BLOCKS_PER_SM * 132
        assert plan.grid[1] <= 20


def _brute_force_topk(p, q, s, k):
    """numpy: first-minimum run minima, then a stable ascending sort, the last
    entry repeated where there are fewer than k runs."""
    d = ((p[:, :, None] - q[:, None]) ** 2).sum(-1)
    M = q.shape[1]
    C = -(-M // s)
    d = np.concatenate([d, np.full(d.shape[:2] + (C * s - M,), np.inf, np.float32)], 2)
    d = d.reshape(d.shape[:2] + (C, s))
    arg = d.argmin(-1)
    vals = np.take_along_axis(d, arg[..., None], -1)[..., 0]
    cand = arg + s * np.arange(C)
    order = np.argsort(vals, axis=-1, kind="stable")[..., :k]
    order = np.concatenate([order] + [order[..., -1:]] * (k - order.shape[-1]), -1)
    return np.take_along_axis(vals, order, -1), np.take_along_axis(cand, order, -1)


@pytest.mark.parametrize("M,s,k", [(777, 8, 10), (777, 64, 10), (777, 64, 13),
                                   (777, 64, 16), (100, 32, 10), (64, 64, 3), (1000, 16, 1)])
def test_k3_twin_is_a_stable_sort_of_the_run_minima(M, s, k):
    """k below (10 of 98 or 13), at (13 of 13) and above (16 of 13, 10 of 4, 3 of
    1) the number of runs, on lattice clouds full of ties."""
    rng = np.random.RandomState(M + s + k)
    p = rng.randint(0, 5, (2, 150, 3)).astype(np.float32)
    q = rng.randint(0, 5, (2, M, 3)).astype(np.float32)
    dists, idx = knn_cuda.knn_topk_plain(torch.from_numpy(p), torch.from_numpy(q), s, k)
    want_d, want_i = _brute_force_topk(p, q, s, k)
    assert dists.shape == (2, 150, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(dists.numpy(), want_d)
    np.testing.assert_array_equal(idx.numpy(), want_i)


@pytest.mark.parametrize("M,s,k,sms", [(3000, 8, 10, 132), (5000, 64, 16, 132),
                                       (1500, 16, 10, 1)])
def test_k3_scheme_of_spans_equals_the_plain_twin(M, s, k, sms):
    """The kernel keeps the k best of each span and merges the spans' lists in
    span order behind their equals: a stable sort of the concatenated lists."""
    rng = np.random.RandomState(M)
    p = torch.from_numpy(rng.randint(0, 6, (1, 90, 3)).astype(np.float32))
    q = torch.from_numpy(rng.randint(0, 6, (1, M, 3)).astype(np.float32))
    plan = knn_cuda.topk_plan(1, 90, M, k, sms)
    assert plan.grid[1] > 1
    lists = [knn_cuda.knn_topk_plain(p, q[:, lo:lo + plan.span], s, min(k, -(-min(plan.span, M - lo) // s)))
             for lo in range(0, M, plan.span)]
    vals = torch.cat([v for v, _ in lists], -1)
    cand = torch.cat([i + sp * plan.span for sp, (_, i) in enumerate(lists)], -1)
    top, pos = knn_cuda.smallest_k_stable(vals, k)
    want = knn_cuda.knn_topk_plain(p, q, s, k)
    assert torch.equal(top, want[0]) and torch.equal(torch.gather(cand, -1, pos), want[1])
