"""The Pix3D eval slice of the port against the JAX package, at the tiny
configuration of tests/test_pix3d.py (B=2, 64x64 images, RPN 64 / 32,
capacities 256/512/1024), float32 detection stack on both sides.

Tolerances and why:
  * detections: validity and labels exact; boxes within 1e-3 px; scores,
    RoI features, mask probabilities and voxels 1e-4 relative (f32 convs and
    matmuls, other summation order);
  * cubify mesh: exact;
  * refined stage vertices: 5e-4 relative, the bound of the JAX package's
    neighbour sums (differences of prefix sums over all edges, which cancel
    to about eps * |prefix| a GraphConv; nine stacked GraphConvs);
  * metrics on the same model output: losses 1e-4 relative, AP and IoU
    records, best labels and counts exact, F1 sums within 2 flips of a point
    a sample and tau (a near-tie at tau^2 may go either way);
  * validate_pix3d end to end (each side's own forward): losses 1e-3
    relative, AP and f-scores exact, F1 within 0.02.
Each JAX program is built once for the module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import struct

from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.harness import _pix3d_eval_metrics
from meshrcnn_tpu.harness import validate_pix3d as jax_validate_pix3d
from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu.models.roi_heads import MaskHead as JaxMaskHead
from meshrcnn_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.harness import pix3d_eval_metrics, validate_pix3d
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel, Pix3DOutput
from meshrcnn_tpu_torch.models.roi_heads import Detections
from meshrcnn_tpu_torch.parallel.train_step import make_eval_step
from meshrcnn_tpu_torch.utils.jax_params import state_dict_from_jax
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import (Replay, load_flax, pix3d_eval_metric_draws, rel_err, t,
                                to_numpy_tree)

B, D = 2, 3
PCS = 128
TAUS = (0.1, 0.3)
PORT_TINY = {k: v for k, v in TINY.items() if k not in ("roi_batch_size", "mask_rois")}


@struct.dataclass
class _State:
    """The two fields of the JAX TrainState that its eval step reads."""
    params: dict
    batch_stats: dict


def _port_model():
    return Pix3DModel(backbone_dtype="float32", **PORT_TINY)


@pytest.fixture(scope="module")
def slice_run():
    jm = JaxPix3DModel(backbone_dtype="float32", **TINY)
    batch = tiny_batch(B)
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(batch.images)
    state = _State(params=variables["params"], batch_stats=variables["batch_stats"])
    jstep = jax_make_eval_step(jm)
    jout = jstep(state, batch.images)
    tm = load_flax(_port_model(), variables)
    return dict(jm=jm, batch=batch, variables=variables, state=state, jstep=jstep,
                jout=jout, tm=tm, tout=make_eval_step(tm)(t(batch.images)))


def test_bridge_loads_pix3d_strict_and_flips_conv5_mask(slice_run):
    """The whole flax Pix3DModel tree loads with strict=True, and the mask
    head's ConvTranspose (flax name ``conv5_mask``) is flipped because its torch
    module is an nn.ConvTranspose2d: loaded unflipped, it disagrees."""
    variables = to_numpy_tree(slice_run["variables"])
    model = _port_model()
    sd = state_dict_from_jax(model, variables["params"], variables["batch_stats"])
    model.load_state_dict(sd, strict=True)
    model.eval()
    x = np.random.RandomState(3).randn(1, 2, 14, 14, 256).astype(np.float32)
    want = JaxMaskHead(num_classes=10).apply(
        {"params": variables["params"]["backbone"]["roi_heads"]["mask_head"]}, x)
    head = model.backbone.roi_heads.mask_head
    with torch.no_grad():
        got = head(t(x)).numpy().transpose(0, 1, 3, 4, 2)     # [B, R, 28, 28, C]
        assert rel_err(got, want) < 1e-4
        head.conv5_mask.weight.copy_(head.conv5_mask.weight.flip(2, 3))
        assert rel_err(head(t(x)).numpy().transpose(0, 1, 3, 4, 2), want) > 1e-2


def test_slice_forward_matches_jax(slice_run):
    jout, tout = slice_run["jout"], slice_run["tout"]
    jd, td = jout.detections, tout.detections
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(td.labels.numpy(), np.asarray(jd.labels))
    assert td.valid.any(1).all()
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), atol=1e-3)
    assert rel_err(td.scores.numpy(), jd.scores) < 1e-4
    assert rel_err(td.roi_features.numpy(), jd.roi_features) < 1e-4
    assert rel_err(tout.mask_probs.numpy(), jout.mask_probs) < 1e-4
    assert rel_err(tout.voxels.numpy(), jout.voxels) < 1e-4
    np.testing.assert_array_equal(tout.mesh_valid.numpy(), np.asarray(jout.mesh_valid))
    for k in ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask"):
        np.testing.assert_array_equal(getattr(tout.mesh, k).numpy(),
                                      np.asarray(getattr(jout.mesh, k)), err_msg=k)
    for k in ("verts", "faces", "edges"):
        np.testing.assert_array_equal(getattr(tout.overflow, k).numpy(),
                                      np.asarray(getattr(jout.overflow, k)))
    assert len(tout.stage_verts) == 4
    for a, b in zip(tout.stage_verts, jout.stage_verts):
        assert rel_err(a.numpy(), b) < 5e-4


@pytest.mark.parametrize("option", ["mesh_feature_norm", "voxel_only"])
def test_mesh_branch_options_match_jax(slice_run, option):
    """``mesh_feature_norm`` (RoI maps divided by their RMS before the voxel and
    mesh branches) and ``voxel_only`` (no cubify, no refine stages) against the
    JAX forward with the same weights; the detections do not move."""
    jm = slice_run["jm"].clone(**{option: True})
    jout = jax_make_eval_step(jm)(slice_run["state"], slice_run["batch"].images)
    tm = Pix3DModel(backbone_dtype="float32", **PORT_TINY, **{option: True})
    tm.load_state_dict({k: v for k, v in slice_run["tm"].state_dict().items()
                        if not (option == "voxel_only" and k.startswith("refine"))})
    tout = make_eval_step(tm)(t(slice_run["batch"].images))
    np.testing.assert_array_equal(tout.detections.valid.numpy(),
                                  np.asarray(jout.detections.valid))
    assert rel_err(tout.voxels.numpy(), jout.voxels) < 1e-4
    same = np.array_equal(tout.voxels.numpy(), slice_run["tout"].voxels.numpy())
    if option == "voxel_only":                 # the same voxels, and nothing after them
        assert same and tout.mesh is None and tout.stage_verts == () and jout.mesh is None
    else:                                      # the voxel head saw rescaled features
        assert not same
        for a, b in zip(tout.stage_verts, jout.stage_verts):
            assert rel_err(a.numpy(), b) < 5e-4


def _to_port_output(out) -> Pix3DOutput:
    det = out.detections
    mesh = MeshBatch(**{k: t(getattr(out.mesh, k)) for k in
                        ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask")})
    return Pix3DOutput(
        detections=Detections(boxes=t(det.boxes), labels=t(det.labels).long(),
                              scores=t(det.scores), valid=t(det.valid),
                              roi_features=t(det.roi_features)),
        mask_probs=t(out.mask_probs), backbone_losses={}, voxels=t(out.voxels), mesh=mesh,
        stage_verts=tuple(t(v) for v in out.stage_verts), mesh_valid=t(out.mesh_valid),
        overflow=None)


def _port_metrics(key, out, batch):
    m = pix3d_eval_metrics(out, t(batch.boxes), t(batch.masks), t(batch.voxels),
                           t(batch.gt_verts), t(batch.gt_faces), t(batch.gt_faces_mask), PCS,
                           Replay(pix3d_eval_metric_draws(key, B, D, PCS)), TAUS, ranked=True)
    return {k: v.numpy() for k, v in m.items()}


def test_slice_metrics_match_jax_with_ranked_records(slice_run):
    batch, jout = slice_run["batch"], slice_run["jout"]
    key = jax.random.PRNGKey(5)
    want = jax.device_get(_pix3d_eval_metrics(
        key, jout, batch.boxes, batch.masks, batch.voxels, batch.gt_verts, batch.gt_faces,
        batch.gt_faces_mask, PCS, 10, 2048, TAUS, False, True))
    got = _port_metrics(key, _to_port_output(jout), batch)
    assert set(got) == set(want)
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("best_labels", "ap_box", "ap_mask", "voxel_iou", "det_scores", "det_labels",
              "det_valid", "det_box_iou", "det_mask_iou", "f1_count"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["f1_sum"], want["f1_sum"], atol=2.0 * 2 * B / PCS)
    np.testing.assert_allclose(got["det_mesh_f1"], want["det_mesh_f1"], atol=2.0 * 2 / PCS)
    # each side's own forward: the same discrete records, losses close
    own = _port_metrics(key, slice_run["tout"], batch)
    for k in ("best_labels", "ap_box", "ap_mask", "det_valid", "det_labels"):
        np.testing.assert_array_equal(own[k], np.asarray(want[k]), err_msg=k)
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        np.testing.assert_allclose(own[k], want[k], rtol=1e-3, err_msg=k)


def test_validate_pix3d_matches_jax_over_batches(slice_run):
    batch = slice_run["batch"]
    flipped = batch.replace(images=batch.images[:, ::-1],
                            labels=jnp.asarray([3, 7], dtype=jnp.int32))
    loader = [jax.tree_util.tree_map(np.asarray, b) for b in (batch, flipped)]
    rng = jax.random.PRNGKey(9)
    want = jax_validate_pix3d(0, slice_run["jstep"], slice_run["state"], loader,
                              JaxTrainConfig(point_cloud_size=PCS), 10, rng)
    draws = [d for i in range(len(loader))
             for d in pix3d_eval_metric_draws(jax.random.fold_in(rng, i), B, D, PCS)]
    got = validate_pix3d(make_eval_step(slice_run["tm"]), loader,
                         TrainConfig(point_cloud_size=PCS), 10, Replay(draws), device="cpu")
    assert set(got) == set(want)
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    for k in ("voxel_iou", "AP_box", "AP_mask", "f0_1", "f0_3", "f0_5", "AP_mesh", "AP50_box",
              "AP50_mask"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["AP_mesh_ranked"], want["AP_mesh_ranked"], atol=0.02)
    for tau in TAUS:
        np.testing.assert_allclose(got[f"F1@{tau}"], want[f"F1@{tau}"], atol=0.02)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
