"""The port's Pix3D modules against the flax modules, weights carried by the
bridge (utils/jax_params.py), at small sizes.

Tolerances and why:
  * float32 modules: 1e-4 relative to each output's scale (other summation
    order of convolutions and matmuls);
  * RoIHeads eval: validity and labels exact, the rest 1e-4 relative;
    ``_postprocess`` on JAX's own head outputs: discrete decisions exact;
  * bfloat16 backbones (FPN and the ShapeNet ResNet-50), against the JAX
    package's bfloat16 forward: BF16_TOL = 3e-2 of scale. Both round every
    conv output to bfloat16 (8 bits of mantissa, 4e-3 relative); a rounding
    that lands differently moves a value by that much, and the ~55 layers
    carry it on: at 64x64 and 96x96 the port and JAX differ by 0.7-1.3e-2,
    as much as each differs from its own float32 forward.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meshrcnn_tpu.models import layers as jl
from meshrcnn_tpu.models import roi_heads as jheads
from meshrcnn_tpu.models.fpn import ResNetFPN as JaxResNetFPN
from meshrcnn_tpu.models.resnet import ResNet50 as JaxResNet50
from meshrcnn_tpu.models.rpn import RPNHead as JaxRPNHead
from meshrcnn_tpu.ops.graph_conv import precompute_adjacency as jax_adjacency
from meshrcnn_tpu_torch.models import layers as tl
from meshrcnn_tpu_torch.models import roi_heads as theads
from meshrcnn_tpu_torch.models.fpn import ResNetFPN, upsample_nearest
from meshrcnn_tpu_torch.models.rpn import RPNHead
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency
from tests.test_torch_modules import _cell_inputs
from tests.torch_parity import load_flax, rel_err, t, to_numpy_tree

TOL = 1e-4
BF16_TOL = 3e-2


def _random_stats(variables, seed):
    """Running statistics that keep activations alive through ~55 layers
    (means near 0, variances in [0.5, 1.5]), so the BN mapping is exercised."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if "mean" in node and not isinstance(node["mean"], dict):
            return {"mean": (rng.randn(*node["mean"].shape) * 0.1).astype(np.float32),
                    "var": (rng.rand(*node["var"].shape) + 0.5).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}
    return {"params": variables["params"],
            "batch_stats": walk(to_numpy_tree(variables["batch_stats"]))}


@pytest.fixture(scope="module")
def fpn_run():
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    jm = JaxResNetFPN(dtype=jnp.float32)
    variables = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(x)
    variables = _random_stats(variables, 1)
    outs = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        want = jax.jit(lambda v, a: jm.clone(dtype=dt).apply(v, a, train=False))(variables, x)
        tm = load_flax(ResNetFPN(dtype=getattr(torch, name)), variables)
        with torch.no_grad():
            outs[name] = (tm(t(x)), want)
    return variables, outs


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", BF16_TOL)])
def test_fpn_matches_flax(fpn_run, dtype, tol):
    got, want = fpn_run[1][dtype]
    assert len(got) == 5
    for a, b in zip(got, want):
        assert a.dtype == getattr(torch, dtype)
        a = a.float().permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        assert np.abs(a).max() > 1.0                  # the pyramid is not all zeros
        assert rel_err(a, np.asarray(b, np.float32)) < tol


def test_upsample_uses_integer_source_rows():
    x = torch.arange(7 * 5, dtype=torch.float32).reshape(1, 1, 7, 5)
    got = upsample_nearest(x, 13, 9)
    rows, cols = (np.arange(13) * 7) // 13, (np.arange(9) * 5) // 9
    np.testing.assert_array_equal(got[0, 0].numpy(), x[0, 0].numpy()[rows][:, cols])


def test_rpn_head_matches_flax():
    rng = np.random.RandomState(2)
    feats = [rng.randn(2, s, s, 256).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    jm = JaxRPNHead()
    variables = jm.init(jax.random.PRNGKey(1), feats)
    want_l, want_d = jm.apply(variables, feats)
    tm = load_flax(RPNHead(), variables)
    with torch.no_grad():
        got_l, got_d = tm([t(f).permute(0, 3, 1, 2) for f in feats])
    for a, b in zip(got_l + got_d, list(want_l) + list(want_d)):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) < 1e-5


def test_box_head_reads_flax_flatten_order():
    """fc6 takes the pooled features channels-last, the (h, w, c) order of the
    flax kernel's rows; a channel-first flatten would disagree."""
    x = np.random.RandomState(3).randn(2, 5, 4, 4, 16).astype(np.float32)
    jm = jheads.TwoMLPHead(representation_size=32)
    variables = jm.init(jax.random.PRNGKey(2), x)
    want = jm.apply(variables, x)
    tm = load_flax(theads.TwoMLPHead(4 * 4 * 16, representation_size=32), variables)
    with torch.no_grad():
        assert rel_err(tm(t(x)).numpy(), want) < TOL
        wrong = tm(t(x).permute(0, 1, 4, 2, 3).contiguous()).numpy()
    assert rel_err(wrong, want) > 1e-2


def test_mask_head_and_predictor_match_flax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 14, 14, 16).astype(np.float32)
    jm = jheads.MaskHead(num_classes=5, hidden=8)
    variables = jm.init(jax.random.PRNGKey(3), x)
    tm = load_flax(theads.MaskHead(16, 5, hidden=8), variables)
    with torch.no_grad():
        got = tm(t(x)).numpy().transpose(0, 1, 3, 4, 2)
    assert rel_err(got, jm.apply(variables, x)) < TOL
    v = rng.randn(2, 7, 32).astype(np.float32)
    jp = jheads.FastRCNNPredictor(num_classes=5)
    pvars = jp.init(jax.random.PRNGKey(4), v)
    tp = load_flax(theads.FastRCNNPredictor(32, 5), pvars)
    with torch.no_grad():
        for a, b in zip(tp(t(v)), jp.apply(pvars, v)):
            assert rel_err(a.numpy(), b) < TOL


@pytest.fixture(scope="module")
def heads_run():
    rng = np.random.RandomState(5)
    B, R, H = 2, 24, 64
    feats = [rng.randn(B, H // s, H // s, 256).astype(np.float32) for s in (4, 8, 16, 32, 64)]
    xy = rng.uniform(0, 44, (B, R, 2))
    wh = rng.uniform(6, 40, (B, R, 2))
    props = np.concatenate([xy, np.minimum(xy + wh, H)], -1).astype(np.float32)
    valid = np.ones((B, R), bool)
    valid[:, -4:] = False
    jm = jheads.RoIHeads(num_classes=4, detections_per_img=3)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(props), jnp.asarray(valid), (H, H))
    variables = jax.jit(lambda: jm.init(jax.random.PRNGKey(6), *args))()
    params = to_numpy_tree(variables["params"])
    # sharper class scores than the init gives, so classes and NMS both decide
    cls = params["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] * 40.0
    det, _, mask_probs = jax.jit(lambda p: jm.apply({"params": p}, *args))(params)
    tm = load_flax(theads.RoIHeads(num_classes=4, detections_per_img=3), {"params": params})
    with torch.no_grad():
        tdet, losses, tmask = tm([t(f).permute(0, 3, 1, 2) for f in feats], t(props), t(valid),
                                 (H, H))
    assert losses == {}
    return dict(det=det, mask_probs=mask_probs, tdet=tdet, tmask=tmask, props=props,
                valid=valid)


def test_roi_heads_eval_matches_flax(heads_run):
    det, tdet = heads_run["det"], heads_run["tdet"]
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(det.valid))
    np.testing.assert_array_equal(tdet.labels.numpy(), np.asarray(det.labels))
    assert tdet.valid.sum() >= 4 and len(set(tdet.labels[tdet.valid].tolist())) > 1
    for a, b in ((tdet.boxes, det.boxes), (tdet.scores, det.scores),
                 (tdet.roi_features, det.roi_features), (heads_run["tmask"], heads_run["mask_probs"])):
        assert rel_err(a.numpy(), b) < TOL


def test_postprocess_on_jax_inputs_is_exact(heads_run):
    """``_postprocess`` of both packages fed the same head outputs (pooled
    features, logits on a coarse grid so scores tie, deltas): the prefilter
    and NMS meet identical numbers, so every decision and every gathered
    value is the same."""
    rng = np.random.RandomState(7)
    B, R, C = 2, 24, 4
    props = heads_run["props"]
    feats = rng.randn(B, R, 3, 3, 2).astype(np.float32)
    logits = (rng.randint(-8, 8, (B, R, C)) * 0.5).astype(np.float32)   # tied scores
    deltas = (rng.randn(B, R, C, 4) * 0.3).astype(np.float32)
    valid = heads_run["valid"]
    for prefilter in (576, 6):                        # K_c = 64 (capped at R) and 2
        jm = jheads.RoIHeads(num_classes=C, detections_per_img=3, post_nms_prefilter=prefilter)
        want = jm._postprocess(jnp.asarray(feats), jnp.asarray(logits), jnp.asarray(deltas),
                               jnp.asarray(props), jnp.asarray(valid), (64, 64))
        tm = theads.RoIHeads(num_classes=C, detections_per_img=3, post_nms_prefilter=prefilter)
        got = tm._postprocess(t(feats), t(logits), t(deltas), t(props), t(valid), (64, 64))
        for k in ("valid", "labels", "roi_features"):
            np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-5)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-7)


@pytest.mark.parametrize("use_input_features", [False, True])
def test_vertix_refine_pix3d_matches_flax(use_input_features):
    F = 12
    _, verts, edges, mask, feats = _cell_inputs(10 + use_input_features, F=F)
    roi = np.random.RandomState(8).randn(2, 12, 12, 16).astype(np.float32)
    jm = jl.VertixRefinePix3D(use_input_features=use_input_features, num_features=F)
    topo = jax_adjacency(jnp.asarray(edges), jnp.asarray(mask), verts.shape[1])
    vf = jnp.asarray(feats) if use_input_features else None
    args = (jnp.asarray(roi), jnp.asarray(verts), topo, (64, 64))
    variables = jm.init(jax.random.PRNGKey(9), *args, vert_feats=vf)
    want_v, want_f = jm.apply(variables, *args, vert_feats=vf)
    tm = load_flax(tl.VertixRefinePix3D(use_input_features=use_input_features, num_features=F,
                                        alignment_size=16), variables)
    with torch.no_grad():
        got_v, got_f = tm(t(roi), t(verts), precompute_adjacency(t(edges), t(mask), verts.shape[1]),
                          (64, 64), vert_feats=t(feats) if use_input_features else None)
    assert rel_err(got_v.numpy(), want_v) < TOL
    assert rel_err(got_f.numpy(), want_f) < TOL


def test_shapenet_resnet50_bfloat16_matches_flax():
    x = np.random.RandomState(11).rand(2, 48, 48, 3).astype(np.float32)
    jm = JaxResNet50(num_classes=13, dtype=jnp.bfloat16)
    variables = _random_stats(
        jax.jit(lambda a: jm.init(jax.random.PRNGKey(12), a, train=False))(x), 13)
    logits, maps = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    tm = load_flax(ShapeNetModel(num_classes=13, backbone_dtype="bfloat16").backbone, variables)
    assert tm.conv1.compute_dtype == torch.bfloat16
    with torch.no_grad():
        tlogits, tmaps = tm(t(x))
    assert tlogits.dtype == torch.float32 and all(m.dtype == torch.float32 for m in tmaps)
    assert np.abs(np.asarray(maps[-1])).max() > 1.0
    assert rel_err(tlogits.numpy(), logits) < BF16_TOL
    for a, b in zip(tmaps, maps):
        assert rel_err(a.numpy(), b) < BF16_TOL
