"""The whole eval slice of the port against the JAX package, at the sizes of
``__graft_entry__._tiny_model()`` / ``_tiny_batch(2)`` (48x48 images,
capacities 512/1024/2048) with a float32 backbone on both sides.

Tolerances and why:
  * logits, voxels: 1e-4 relative (f32 convolutions, other summation order);
  * cubify mesh and overflow counts: exact;
  * refined stage vertices: 5e-4 relative. The JAX package's neighbour sums
    are differences of prefix sums over all edges, which cancel to about
    eps * |prefix| per GraphConv; 21 stacked GraphConvs carry that to ~1e-4;
  * metrics on the same model output: losses 1e-4 relative (Gram- vs
    difference-form distances), voxel IoU and predictions exact, F1 sums
    within 2 flips of a point per sample and tau (a near-tie at tau^2 may go
    either way: 2 / point_cloud_size each);
  * end to end (each side's own forward into its own metrics): losses 1e-3
    relative, F1 within 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import struct

import __graft_entry__ as graft
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.harness import _shapenet_eval_metrics
from meshrcnn_tpu.harness import validate as jax_validate
from meshrcnn_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.core.mesh import MeshBatch
from meshrcnn_tpu_torch.harness import shapenet_eval_metrics, validate
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel, ShapeNetOutput
from meshrcnn_tpu_torch.ops.cubify import CubifyOverflow
from meshrcnn_tpu_torch.parallel.train_step import make_eval_step
from tests.torch_parity import Replay, eval_metric_draws, load_flax, rel_err, t

B = 2
PCS = 256
TAUS = (0.1, 0.3)


@struct.dataclass
class _State:
    """The two fields of the JAX TrainState that its eval step reads."""
    params: dict
    batch_stats: dict


def _models():
    jm = graft._tiny_model().clone(backbone_dtype="float32")
    batch = graft._tiny_batch(B)
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        batch.images)
    tm = ShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                       voxel_out_channels=8, vert_capacity=512, face_capacity=1024,
                       edge_capacity=2048, num_refinement_stages=3)
    return jm, variables, load_flax(tm, variables), batch


def _jax_metrics(key, out, batch):
    return jax.device_get(_shapenet_eval_metrics(
        key, out, batch.voxels, batch.gt_verts, batch.gt_faces, batch.gt_faces_mask,
        PCS, 10, 2048, TAUS, False))


def _port_metrics(key, out, batch):
    m = shapenet_eval_metrics(out, t(batch.voxels), t(batch.gt_verts), t(batch.gt_faces),
                              t(batch.gt_faces_mask), PCS,
                              Replay(eval_metric_draws(key, B, PCS)), TAUS)
    return {k: v.numpy() for k, v in m.items()}


def _to_port_output(out) -> ShapeNetOutput:
    mesh = MeshBatch(**{k: t(getattr(out.mesh, k)) for k in
                        ("verts", "verts_mask", "faces", "faces_mask", "edges",
                         "edges_mask")})
    return ShapeNetOutput(logits=t(out.logits), voxels=t(out.voxels), mesh=mesh,
                          stage_verts=tuple(t(v) for v in out.stage_verts),
                          overflow=CubifyOverflow(*(t(getattr(out.overflow, k))
                                                    for k in ("verts", "faces", "edges"))))


def test_slice_forward_and_metrics_match_jax():
    jm, variables, tm, batch = _models()
    jout = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, batch.images)
    tout = make_eval_step(tm)(t(batch.images))

    assert rel_err(tout.logits.numpy(), jout.logits) < 1e-4
    assert rel_err(tout.voxels.numpy(), jout.voxels) < 1e-4
    for k in ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask"):
        np.testing.assert_array_equal(getattr(tout.mesh, k).numpy(),
                                      np.asarray(getattr(jout.mesh, k)), err_msg=k)
    for k in ("verts", "faces", "edges"):
        np.testing.assert_array_equal(getattr(tout.overflow, k).numpy(),
                                      np.asarray(getattr(jout.overflow, k)))
    assert len(tout.stage_verts) == 4
    for a, b in zip(tout.stage_verts, jout.stage_verts):
        assert rel_err(a.numpy(), b) < 5e-4

    key = jax.random.PRNGKey(5)
    want = _jax_metrics(key, jout, batch)
    same_input = _port_metrics(key, _to_port_output(jout), batch)
    end_to_end = _port_metrics(key, tout, batch)
    for got, loss_rtol, f1_atol in ((same_input, 1e-4, 2.0 * 2 * B / PCS),
                                    (end_to_end, 1e-3, 0.02 * B)):
        for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=loss_rtol, err_msg=k)
        np.testing.assert_array_equal(got["preds"], want["preds"])
        np.testing.assert_allclose(got["voxel_iou"], want["voxel_iou"], rtol=1e-6)
        assert int(got["f1_count"]) == int(want["f1_count"])
        np.testing.assert_allclose(got["f1_sum"], want["f1_sum"], atol=f1_atol)
    assert all(np.isfinite(v).all() for v in end_to_end.values())


def test_validate_matches_jax_over_batches():
    jm, variables, tm, batch = _models()
    flipped = batch.replace(images=batch.images[:, ::-1],
                            labels=jnp.asarray([3, 7], dtype=jnp.int32))
    loader = [jax.tree_util.tree_map(np.asarray, b) for b in (batch, flipped)]
    rng = jax.random.PRNGKey(9)
    state = _State(params=variables["params"], batch_stats=variables["batch_stats"])
    want = jax_validate(0, jax_make_eval_step(jm), state, loader,
                        JaxTrainConfig(point_cloud_size=PCS), 13, rng)
    draws = [d for i in range(len(loader))
             for d in eval_metric_draws(jax.random.fold_in(rng, i), B, PCS)]
    got = validate(make_eval_step(tm), loader, TrainConfig(point_cloud_size=PCS), 13,
                   Replay(draws), device="cpu")
    assert set(got) == set(want)
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    for k in ("voxel_iou", "f0_1", "f0_3", "f0_5"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for tau in TAUS:
        np.testing.assert_allclose(got[f"F1@{tau}"], want[f"F1@{tau}"], atol=0.02)
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
