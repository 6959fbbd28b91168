"""The Mask R-CNN training pieces of the port against the JAX package's, at
fixed inputs: the matcher and the balanced sampler (ops/matcher.py), the RPN
loss, the RoI heads' sampling, box losses and mask loss, the RoIAlign
gradient into the level table, and ``filter_roi_input``.

Tolerances and why. Matching and sampling are discrete: on the same inputs
and the same replayed uniforms (``torch_parity.sampler_pair_draws``) every
index, label and mask is identical. Losses are float32 sums of the same
terms in another order: 1e-5 relative. Gradients (VJPs against
``jax.grad``): 1e-4 of each tensor's scale, float32 convolutions and
matmuls summed in another order. RoIAlign on the JAX side is its corner-gather
form (``MESHRCNN_MATMUL_ROIALIGN=0``), the form the port has.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshrcnn_tpu.models import roi_heads as jheads
from meshrcnn_tpu.models import rpn as jrpn
from meshrcnn_tpu.models.pix3d import filter_roi_input as jax_filter_roi_input
from meshrcnn_tpu.models.roi_heads import Detections as JaxDetections
from meshrcnn_tpu.ops import matcher as jmatcher
from meshrcnn_tpu.ops import roi_align as jroi
from meshrcnn_tpu.ops.boxes import box_iou as jax_box_iou
from meshrcnn_tpu_torch.models import roi_heads as theads
from meshrcnn_tpu_torch.models import rpn
from meshrcnn_tpu_torch.models.pix3d import filter_roi_input
from meshrcnn_tpu_torch.models.roi_heads import Detections
from meshrcnn_tpu_torch.ops import matcher, roi_align
from meshrcnn_tpu_torch.ops.boxes import box_iou
from tests.torch_parity import (Replay, load_flax, rel_err, sampler_pair_draws,
                                state_dict_from_flax, t)

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def corner_gather_roi_align(monkeypatch):
    monkeypatch.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")


def _boxes(rng, shape, lo, hi, min_wh, max_wh):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("high,low,low_quality", [(0.7, 0.3, True), (0.7, 0.3, False),
                                                  (0.5, 0.5, False), (0.5, 0.5, True)])
def test_match_boxes_matches_jax(high, low, low_quality):
    """IoUs on a grid of 0.1 (ties within a row, within a GT's column, at the
    thresholds), a padded GT column, and rows where no IoU is positive."""
    rng = np.random.RandomState(0)
    B, N, G = 3, 60, 4
    iou = (rng.randint(0, 11, (B, N, G)) / 10.0).astype(np.float32)
    iou[:, :5] = 0.0
    iou[1, 10:20, 2] = 0.9                                     # a GT's best rows tie
    gt_valid = np.array([True, True, False, True])
    want = jax.vmap(lambda x: jmatcher.match_boxes(x, jnp.asarray(gt_valid), high, low,
                                                   low_quality))(iou)
    got = matcher.match_boxes(t(iou), t(gt_valid), high, low, low_quality)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) >= {matcher.BELOW_LOW, 0, 1, 3}
    assert not (got.numpy() == 2).any()


SAMPLER_CASES = {
    "balanced": dict(n=300, p_pos=0.1, p_neg=0.6, num=64, frac=0.25),
    "positive-starved": dict(n=300, p_pos=0.005, p_neg=0.6, num=64, frac=0.5),
    "zero quota": dict(n=50, p_pos=0.3, p_neg=0.3, num=2, frac=0.25),
    "fewer rows than samples": dict(n=20, p_pos=0.2, p_neg=0.5, num=64, frac=0.25),
    "no negatives": dict(n=100, p_pos=0.1, p_neg=0.0, num=32, frac=0.5),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_balanced_sample_matches_jax(case):
    c = SAMPLER_CASES[case]
    rng = np.random.RandomState(1)
    B = 3
    r = rng.rand(B, c["n"])
    positive = r < c["p_pos"]
    negative = (r >= c["p_pos"]) & (r < c["p_pos"] + c["p_neg"])
    key = jax.random.PRNGKey(3)
    want = jax.vmap(lambda k, p, n: jmatcher.balanced_sample(k, p, n, c["num"], c["frac"]))(
        jax.random.split(key, B), positive, negative)
    got = matcher.balanced_sample(Replay(sampler_pair_draws(key, B, c["n"])), t(positive),
                                  t(negative), c["num"], c["frac"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx, is_pos, valid = (g.numpy() for g in got)
    quota = int(c["num"] * c["frac"])
    assert (is_pos.sum(1) == np.minimum(positive.sum(1), quota)).all()
    assert (valid.sum(1) == np.minimum(c["num"], is_pos.sum(1) + negative.sum(1))).all()
    if case == "zero quota":
        assert not is_pos.any()


def test_smooth_l1_and_bce_match_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(500).astype(np.float32) * 0.3
    target = rng.randn(500).astype(np.float32) * 0.3
    pred[:4] = target[:4] + np.float32([0.0, 1 / 9, -1 / 9, 0.05])
    assert rel_err(matcher.smooth_l1(t(pred), t(target)).numpy(),
                   jmatcher.smooth_l1(pred, target)) < TOL
    logits = rng.randn(500).astype(np.float32) * 20
    y = (rng.rand(500) > 0.5).astype(np.float32)
    assert rel_err(matcher.sigmoid_bce(t(logits), t(y)).numpy(),
                   jrpn.optax_sigmoid_bce(logits, y)) < TOL


@pytest.mark.parametrize("G", [1, 2])
def test_rpn_loss_matches_jax(G):
    """Over all anchors of a 96x96 image (P2..P6, 2079 anchors): the sampled
    anchors equal JAX's, the two losses 1e-5 relative, the VJP into the
    objectness logits and the deltas 1e-4 of scale."""
    rng = np.random.RandomState(3 + G)
    B, size = 2, 96
    shapes = [(-(-size // s), -(-size // s)) for s in (4, 8, 16, 32, 64)]
    anchors = jrpn.generate_anchors(shapes, (size, size))
    n = [a.shape[0] for a in anchors]
    logits = [(rng.randn(B, m) * 2).astype(np.float32) for m in n]
    deltas = [(rng.randn(B, m, 4) * 0.5).astype(np.float32) for m in n]
    gt = _boxes(rng, (B, G), 5, 40, 20, 55)
    key = jax.random.PRNGKey(7)
    ct = rng.rand(2).astype(np.float32) + 0.5

    def jax_fn(lg, dl):
        obj, box = jrpn.rpn_loss(key, lg, dl, anchors, gt)
        return obj * ct[0] + box * ct[1], (obj, box)
    (_, (obj, box)), (g_lg, g_dl) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        logits, deltas)
    N = sum(n)
    tl = [t(x).requires_grad_(True) for x in logits]
    td = [t(x).requires_grad_(True) for x in deltas]
    t_obj, t_box = rpn.rpn_loss(Replay(sampler_pair_draws(key, B, N)), tl, td,
                                [t(a) for a in anchors], t(gt))
    (t_obj * float(ct[0]) + t_box * float(ct[1])).backward()
    assert rel_err(t_obj.item(), obj) < TOL and rel_err(t_box.item(), box) < TOL
    assert float(box) > 0.0
    for a, b in zip(tl + td, list(g_lg) + list(g_dl)):
        assert rel_err(a.grad.numpy(), b) < GRAD_TOL

    # the sampled anchors themselves, per image as JAX samples them
    anc = np.concatenate([np.asarray(a) for a in anchors])
    iou = box_iou(t(anc), t(gt))
    m = matcher.match_boxes(iou, torch.ones(G, dtype=torch.bool), 0.7, 0.3, True)
    got = matcher.balanced_sample(Replay(sampler_pair_draws(key, B, N)), m >= 0,
                                  m == matcher.BELOW_LOW, 256, 0.5)
    for b, k in enumerate(jax.random.split(key, B)):
        jm = jmatcher.match_boxes(jax_box_iou(anc, gt[b]), jnp.ones((G,), bool), 0.7, 0.3, True)
        np.testing.assert_array_equal(m[b].numpy(), np.asarray(jm))
        want = jmatcher.balanced_sample(k, jm >= 0, jm == jmatcher.BELOW_LOW, 256, 0.5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    assert got[1].any(1).all()


# ---- RoI heads --------------------------------------------------------------

B, R, H, C_FEAT, NUM_CLASSES = 2, 24, 64, 16, 4
ROI_BATCH, MASK_ROIS = 32, 8


def _heads_kwargs():
    return dict(num_classes=NUM_CLASSES, detections_per_img=3, batch_size_per_image=ROI_BATCH,
                mask_rois=MASK_ROIS)


def _roi_draws(rng_key, with_mask: bool) -> list:
    draws = sampler_pair_draws(rng_key, B, R + 1)
    if with_mask:
        draws.append(np.asarray(jax.random.uniform(jax.random.fold_in(rng_key, 101),
                                                   (B, ROI_BATCH))))
    return draws


@pytest.fixture(scope="module")
def heads_case():
    """Proposals scattered around each image's GT box (so matches at 0.5 both
    ways and repeats), an FPN of 16 channels, GT masks, and the flax heads'
    parameters with sharpened class scores."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(B, H // s, H // s, C_FEAT).astype(np.float32) for s in (4, 8, 16, 32, 64)]
    gt = np.float32([[[8, 10, 40, 44]], [[20, 16, 60, 50]]])
    jitter = rng.uniform(-10, 10, (B, R, 4)).astype(np.float32)
    props = np.clip(gt + jitter, 0, H).astype(np.float32)
    props[:, ::5] = _boxes(rng, (B, (R + 4) // 5), 0, 40, 4, 24)   # some far from the GT
    props[:, 3] = props[:, 2]                                       # a repeated proposal
    props[:, 1] = [-30, -30, 90, 90]                                # pooled from P3
    props[:, 7] = [-20, -25, 84, 90]
    valid = np.ones((B, R), bool)
    valid[:, -3:] = False
    labels = np.int32([2, 3])
    masks = np.zeros((B, H, H), np.float32)
    masks[0, 12:40, 10:36] = 1.0
    masks[1, 18:48, 24:58] = 1.0
    jm = jheads.RoIHeads(**_heads_kwargs())
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(props), jnp.asarray(valid), (H, H))
    params = jax.device_get(jax.jit(lambda: jm.init(jax.random.PRNGKey(6), *args))()["params"])
    params["box_predictor"]["cls_score"]["kernel"] = params["box_predictor"]["cls_score"][
        "kernel"] * 10.0
    return dict(feats=feats, gt=gt, props=props, valid=valid, labels=labels, masks=masks, jm=jm,
                params=params, key=jax.random.PRNGKey(8))


def _port_heads(case):
    return load_flax(theads.RoIHeads(in_channels=C_FEAT, **_heads_kwargs()),
                     {"params": case["params"]})


def test_select_training_samples_matches_jax(heads_case):
    c = heads_case
    want = c["jm"]._select_training_samples(c["key"], jnp.asarray(c["props"]),
                                            jnp.asarray(c["valid"]), jnp.asarray(c["gt"]),
                                            jnp.asarray(c["labels"]))
    got = _port_heads(c)._select_training_samples(
        Replay(_roi_draws(c["key"], False)), t(c["props"]), t(c["valid"]), t(c["gt"]),
        t(c["labels"]))
    for name, g, w in zip(("proposals", "valid", "labels", "targets", "is_pos"), got, want):
        if name == "targets":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    is_pos = got[4].numpy()
    assert is_pos.any(1).all() and (~is_pos & got[1].numpy()).any(1).all()
    assert (got[2].numpy()[is_pos] == np.repeat(c["labels"], is_pos.sum(1))).all()


def _jax_losses(case, with_mask: bool):
    """The JAX heads' training losses, and the gradient of each group (box
    losses, mask loss) into the parameters and the five feature maps."""
    jm = case["jm"]
    gt_masks = jnp.asarray(case["masks"]) if with_mask else None

    def losses(params, feats):
        _, out, _ = jm.apply({"params": params}, feats, jnp.asarray(case["props"]),
                             jnp.asarray(case["valid"]), (H, H), train=True,
                             gt_boxes=jnp.asarray(case["gt"]),
                             gt_labels=jnp.asarray(case["labels"]), gt_masks=gt_masks,
                             rng=case["key"])
        return out
    names = ("loss_mask",) if with_mask else ("loss_classifier", "loss_box_reg")
    feats = [jnp.asarray(f) for f in case["feats"]]
    fn = lambda p, f: sum(losses(p, f)[k] for k in names)   # noqa: E731
    return jax.jit(losses)(case["params"], feats), jax.jit(jax.grad(fn, argnums=(0, 1)))(
        case["params"], feats), names


def _port_losses(case, with_mask: bool, names):
    heads = _port_heads(case).train()
    feats = [t(f).permute(0, 3, 1, 2).contiguous().requires_grad_(True) for f in case["feats"]]
    det, losses, mask_probs = heads(feats, t(case["props"]), t(case["valid"]), (H, H), train=True,
                                    gt_boxes=t(case["gt"]), gt_labels=t(case["labels"]),
                                    gt_masks=t(case["masks"]) if with_mask else None,
                                    uniform=Replay(_roi_draws(case["key"], with_mask)))
    assert mask_probs is None and det.valid.shape == (B, 3)
    sum(losses[k] for k in names).backward()
    return losses, heads, feats


@pytest.mark.parametrize("with_mask", [False, True])
def test_roi_head_losses_and_vjp_match_jax(heads_case, with_mask):
    """Box losses (classification over the sampled RoIs, smooth-L1 of the
    positives at their GT class), and the mask loss: values 1e-5 relative,
    gradients into every parameter and feature map 1e-4 of scale."""
    (want, (g_params, g_feats), names) = _jax_losses(heads_case, with_mask)
    got, heads, feats = _port_losses(heads_case, with_mask, names)
    assert set(got) == set(want) == set(names) | {"loss_classifier", "loss_box_reg"}
    for k in want:
        assert float(want[k]) > 0.0
        assert rel_err(got[k].item(), want[k]) < TOL, k
    want_grads = state_dict_from_flax(heads, g_params)
    for n, p in heads.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        assert rel_err(g, want_grads[n].numpy()) < GRAD_TOL, n
    used = 0
    for f, w in zip(feats, g_feats):
        g = f.grad.permute(0, 2, 3, 1).numpy() if f.grad is not None else np.zeros_like(w)
        assert rel_err(g, w) < GRAD_TOL
        used += bool(np.abs(np.asarray(w)).max() > 0)
    assert used == (1 if with_mask else 2)         # the positives pool from P2 alone


def test_multiscale_roi_align_vjp_matches_jax():
    """The gradient of the pooled features into the FPN maps (the backward
    of the level table's corner gathers), against ``jax.grad`` of the JAX
    corner-gather form: 1e-4 of scale."""
    rng = np.random.RandomState(9)
    maps = [rng.randn(2, s, s, 8).astype(np.float32) for s in (32, 16, 8, 4)]
    bx = _boxes(rng, (2, 40), -10, 100, 4, 120)
    cot = rng.randn(2, 40, 12, 12, 8).astype(np.float32)
    want = jax.grad(lambda ms: (jroi.multiscale_roi_align(ms, bx, (128, 128), 12, 1)
                                * cot).sum())([jnp.asarray(m) for m in maps])
    tm = [t(m).permute(0, 3, 1, 2).contiguous().requires_grad_(True) for m in maps]
    out = roi_align.multiscale_roi_align(roi_align.flatten_levels(tm), t(bx), (128, 128), 12, 1)
    (out * t(cot)).sum().backward()
    for m, w in zip(tm, want):
        assert rel_err(m.grad.permute(0, 2, 3, 1).numpy(), w) < GRAD_TOL


def test_bfloat16_level_table_accumulates_gradient_in_float32():
    """A bfloat16 table that needs a gradient is read as float32, so 512
    overlapping RoIs' contributions to a row are summed in float32 and
    rounded to bfloat16 once: the gradient is exactly the float32 table's
    rounded to bfloat16 (the gradient of a sum of bilinear samples does not
    depend on the table's values, so both sum the same float32 terms in the
    same order). Summing in bfloat16 misses on about a quarter of the
    entries. The forward is unchanged by the cast."""
    rng = np.random.RandomState(10)
    maps = [rng.randn(1, 8, s, s).astype(np.float32) for s in (16, 8, 4, 2)]
    bx = np.float32([[10, 12, 50, 48]]) + rng.uniform(-4, 4, (1, 512, 4)).astype(np.float32)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        tm = [t(m).to(dtype).requires_grad_(True) for m in maps]
        levels = roi_align.flatten_levels(tm)
        assert levels.flat.dtype == torch.float32
        out = roi_align.multiscale_roi_align(levels, t(bx), (64, 64), 12, 1)
        out.sum().backward()
        grads[dtype] = [m.grad.float() for m in tm]
        with torch.no_grad():
            plain = roi_align.multiscale_roi_align(roi_align.flatten_levels(tm), t(bx),
                                                   (64, 64), 12, 1)
        assert torch.equal(plain, out.detach())
    a, b = (torch.cat([g.flatten() for g in grads[d]]) for d in (torch.bfloat16, torch.float32))
    assert b.abs().max() > 100.0
    assert torch.equal(a, b.to(torch.bfloat16).float())


def _detections(rng, valid):
    Bd, D = valid.shape
    boxes = _boxes(rng, (Bd, D), 0, 40, 5, 30)
    feats = rng.randn(Bd, D, 3, 3, 4).astype(np.float32)
    return boxes, feats


def test_filter_roi_input_matches_jax():
    """Best-IoU valid detection per image: tied IoUs take the first slot, an
    image with no valid detection takes slot 0, an image whose valid
    detections miss the GT takes the first valid one; the VJP routes the
    cotangent to the chosen slot only."""
    rng = np.random.RandomState(11)
    valid = np.array([[True, True, True, True], [False, False, False, False],
                      [False, True, True, False], [True, False, True, True]])
    boxes, feats = _detections(rng, valid)
    gt = _boxes(rng, (4, 1), 0, 40, 5, 30)
    boxes[0, 1] = boxes[0, 3] = gt[0, 0]                          # a tie at IoU 1
    boxes[2, 1:3] = gt[2, 0] + 100.0                              # valid slots miss the GT
    det = JaxDetections(boxes=jnp.asarray(boxes), labels=jnp.ones((4, 4), jnp.int32),
                        scores=jnp.ones((4, 4)), valid=jnp.asarray(valid),
                        roi_features=jnp.asarray(feats))
    cot = rng.randn(4, 3, 3, 4).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jax_filter_roi_input(gt, det.replace(roi_features=f)),
                        jnp.asarray(feats))
    tf = t(feats).requires_grad_(True)
    got = filter_roi_input(t(gt), Detections(boxes=t(boxes), labels=torch.ones(4, 4).long(),
                                             scores=torch.ones(4, 4), valid=t(valid),
                                             roi_features=tf))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.detach().numpy()[[0, 1, 2]], feats[[0, 1, 2], [1, 0, 1]])
    (got * t(cot)).sum().backward()
    np.testing.assert_array_equal(tf.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]))
