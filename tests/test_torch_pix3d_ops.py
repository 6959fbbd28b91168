"""The port's detection ops against the JAX package on the same numpy inputs:
box math, greedy NMS, RoIAlign, anchors, proposal selection, mask pasting and
the numpy AP metrics.

Tolerances and why:
  * box IoU, encode / decode, clipping: 1e-6 (the same float32 formulas);
  * NMS: identical order and keep mask, to the JAX package and to a
    sequential greedy reference, ties included;
  * RoIAlign: 1e-5 relative (the same corner-gather arithmetic; the JAX side
    runs its corner-gather path, MESHRCNN_MATMUL_ROIALIGN=0);
  * anchors: 1e-5; select_proposals on JAX's own logits and deltas: validity
    and scores identical, boxes within 1e-4 px;
  * mask pasting: bit-equal; AP metrics: equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshrcnn_tpu.models import rpn as jrpn
from meshrcnn_tpu.ops import boxes as jboxes
from meshrcnn_tpu.ops import nms as jnms
from meshrcnn_tpu.ops import roi_align as jroi
from meshrcnn_tpu.utils import metrics as jmetrics
from meshrcnn_tpu_torch.models import rpn
from meshrcnn_tpu_torch.ops import boxes, nms, roi_align
from meshrcnn_tpu_torch.utils import metrics
from tests.torch_parity import rel_err, t


def _random_boxes(rng, shape, lo=-20.0, hi=140.0, min_side=0.0, max_side=80.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_side, max_side, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_math_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _random_boxes(rng, (30,)), _random_boxes(rng, (20,))
    a[3] = a[4]                                       # a duplicate and a degenerate box
    a[5, 2:] = a[5, :2]
    np.testing.assert_allclose(boxes.box_iou(t(a), t(b)).numpy(),
                               np.asarray(jboxes.box_iou(a, b)), atol=1e-6)
    # batched form equals the per-set one
    ab = np.stack([a[:20], b])
    np.testing.assert_array_equal(boxes.box_iou(t(ab), t(ab)).numpy()[1],
                                  boxes.box_iou(t(b), t(b)).numpy())
    deltas = rng.randn(30, 4).astype(np.float32) * np.float32([1, 1, 3, 3])   # past the clamp
    for w in ((1.0, 1.0, 1.0, 1.0), boxes.BOX_REG_WEIGHTS):
        np.testing.assert_allclose(boxes.decode_boxes(t(deltas), t(a), w).numpy(),
                                   np.asarray(jboxes.decode_boxes(deltas, a, w)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(boxes.encode_boxes(t(b), t(a[:20]), w).numpy(),
                                   np.asarray(jboxes.encode_boxes(b, a[:20], w)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(boxes.clip_boxes_to_image(t(a), (100, 120)).numpy(),
                               np.asarray(jboxes.clip_boxes_to_image(a, (100, 120))), atol=1e-6)
    np.testing.assert_array_equal(boxes.small_box_mask(t(a), 1.0).numpy(),
                                  np.asarray(jboxes.small_box_mask(a, 1.0)))


def _greedy(bx, sc, vd, thr, max_keep):
    """Sequential greedy NMS: repeatedly take the best remaining valid box
    (lower index on ties) and drop the boxes it overlaps beyond thr."""
    alive = vd.copy()
    order = []
    s = np.where(vd, sc, -np.inf)
    iou = metrics.box_iou(bx, bx).astype(np.float32)
    while alive.any() and len(order) < max_keep:
        i = int(np.argmax(np.where(alive, s, -np.inf)))
        order.append(i)
        alive &= ~(iou[i] > thr)
        alive[i] = False
    return order + [-1] * (max_keep - len(order))


def _nms_sets(seed, S=6, N=60):
    """S sets of N boxes in clusters, scores on a coarse grid (exact ties),
    the last rows of each set invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 100, (S, 6, 2))
    pick = rng.randint(0, 6, (S, N))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(S, N, 2) * 4
    wh = rng.uniform(10, 30, (S, N, 2))
    bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    sc = (rng.randint(0, 12, (S, N)) / 12.0).astype(np.float32)
    vd = np.ones((S, N), bool)
    vd[:, -7:] = False
    vd[1] = False                          # one set with nothing valid
    labels = rng.randint(1, 4, (S, N)).astype(np.int32)
    return bx, sc, vd, labels


@pytest.mark.parametrize("seed,max_keep", [(0, 5), (1, 40), (2, 60)])
def test_nms_is_greedy_and_matches_jax(seed, max_keep):
    bx, sc, vd, labels = _nms_sets(seed)
    order, keep = nms.nms_mask(t(bx), t(sc), t(vd), 0.3, max_keep)
    order_cls, keep_cls = nms.batched_nms_mask(t(bx), t(sc), t(labels), t(vd), 0.3, max_keep)
    for s in range(bx.shape[0]):
        want_o, want_k = jnms.nms_mask(bx[s], sc[s], vd[s], 0.3, max_keep)
        np.testing.assert_array_equal(order[s].numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(keep[s].numpy(), np.asarray(want_k))
        assert order[s].tolist() == _greedy(bx[s], sc[s], vd[s], 0.3, max_keep)
        want_o, want_k = jnms.batched_nms_mask(bx[s], sc[s], labels[s], vd[s], 0.3, max_keep)
        np.testing.assert_array_equal(order_cls[s].numpy(), np.asarray(want_o))
        np.testing.assert_array_equal(keep_cls[s].numpy(), np.asarray(want_k))
    assert not keep[1].any()
    if max_keep == 5:                      # fewer slots than kept boxes
        assert keep[0].all()


def test_roi_align_matches_jax_corner_gather(monkeypatch):
    monkeypatch.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
    rng = np.random.RandomState(1)
    B, C, H = 2, 8, 128
    maps = [rng.randn(B, H // s, H // s, C).astype(np.float32) for s in (4, 8, 16, 32)]
    # level boundaries at sqrt(area) = 112, 224, 448; boxes partly outside the image
    edge = np.float32([[0, 0, 112, 112], [10, 20, 122, 132], [-50, -40, 174, 184],
                       [-100, -100, 348, 348], [5, 5, 117, 117.0001], [60, 60, 61, 61],
                       [100, 90, 300, 200], [-30, 0, 10, 5]])
    bx = np.stack([np.concatenate([edge, _random_boxes(rng, (8,), -30, 150, 1, 160)])
                   for _ in range(B)])
    k = roi_align.fpn_levels(t(bx), 4).numpy()
    assert set(k[0, :4].tolist()) == {1, 2, 3}        # 112 -> P3, 224 -> P4, 448 -> P5
    levels = roi_align.flatten_levels([t(m).permute(0, 3, 1, 2) for m in maps])
    for out_size, ratio in ((12, 1), (14, 2)):
        want = jroi.multiscale_roi_align([jnp.asarray(m) for m in maps], bx, (H, H),
                                         out_size, ratio)
        got = roi_align.multiscale_roi_align(levels, t(bx), (H, H), out_size, ratio)
        assert got.shape == want.shape
        assert rel_err(got.numpy(), want) < 1e-5
    want = jroi.roi_align(maps[0], bx, 0.25, 7, 2)
    assert rel_err(roi_align.roi_align(t(maps[0]), t(bx), 0.25, 7, 2).numpy(), want) < 1e-5


@pytest.mark.parametrize("size", [64, 224])
def test_anchors_match_jax(size):
    shapes = [(-(-size // s), -(-size // s)) for s in (4, 8, 16, 32, 64)]
    for a, b in zip(rpn.generate_anchors(shapes, (size, size), "cpu"),
                    jrpn.generate_anchors(shapes, (size, size))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("size,pre,post", [(64, 64, 32), (128, 300, 128)])
def test_select_proposals_matches_jax(size, pre, post):
    rng = np.random.RandomState(size)
    B = 2
    shapes = [(-(-size // s), -(-size // s)) for s in (4, 8, 16, 32, 64)]
    anchors = jrpn.generate_anchors(shapes, (size, size))
    n = [a.shape[0] for a in anchors]
    # logits on a grid of 64 values: many exact ties for the stable top-k
    logits = [(rng.randint(-32, 32, (B, m)) / 8.0).astype(np.float32) for m in n]
    deltas = [(rng.randn(B, m, 4) * 0.5).astype(np.float32) for m in n]
    want = jrpn.select_proposals(logits, deltas, anchors, (size, size), pre, post)
    got = rpn.select_proposals([t(x) for x in logits], [t(x) for x in deltas],
                               [t(a) for a in anchors], (size, size), pre, post)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert got[2].any(1).all()


def test_paste_masks_bit_equal_to_jax():
    rng = np.random.RandomState(2)
    B, D, H, W = 3, 4, 64, 80
    masks = rng.rand(B, D, 28, 28).astype(np.float32)
    bx = _random_boxes(rng, (B, D), -10, 70, 0, 60)
    bx[0, 0] = [10.5, 11.5, 12.5, 40.5]            # half-integers round to even
    bx[0, 1] = [30, 30, 30.2, 30.1]                # smaller than one pixel
    bx[0, 2] = [-20, -20, 100, 100]                # covers the image
    bx[1, 0] = [75, 60, 90, 70]                    # partly outside
    paste = jax.jit(jax.vmap(jax.vmap(
        lambda m, b: jmetrics.paste_mask_in_image_jax(m, b, H, W))))
    want = np.asarray(paste(masks, bx))
    got = metrics.paste_masks(t(masks), t(bx), H, W).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_ap_metrics_equal_jax():
    rng = np.random.RandomState(3)
    n_img, n_det = 40, 110
    gt = {i: int(rng.randint(1, 6)) for i in range(n_img)}
    scores = np.round(rng.rand(n_det), 2)            # ties in score
    labels = rng.randint(1, 6, n_det)
    ids = rng.randint(0, n_img, n_det)
    crit = rng.rand(n_det)
    for thr in (0.3, 0.5):
        a = metrics.detection_map(scores, labels, ids, crit, gt, thr)
        b = jmetrics.detection_map(scores, labels, ids, crit, gt, thr)
        assert a == b
    match = crit > 0.4
    assert (metrics.ranked_average_precision(scores, match, ids, 17)
            == jmetrics.ranked_average_precision(scores, match, ids, 17))
    for seed in range(4):
        cm = np.random.RandomState(seed).randint(0, 6, (10, 10))
        f = jmetrics.f_score(cm, 0.3)
        assert metrics.mesh_precision_recall(cm, f) == jmetrics.mesh_precision_recall(cm, f)
    cm = np.eye(10, dtype=np.int64) * 3                # all recalls equal: the mean branch
    f = jmetrics.f_score(cm, 0.3)
    assert metrics.mesh_precision_recall(cm, f) == jmetrics.mesh_precision_recall(cm, f)
