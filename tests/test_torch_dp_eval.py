"""The port's data-parallel eval (``make_dp_eval_step``: each of two gloo
ranks runs the eval forward on its rows, then every output field is gathered
along the batch) against the JAX package's ``make_dp_eval_step(split=False)``
on a 2-device CPU mesh, for the tiny ShapeNet model of ``__graft_entry__``
(48x48 images) and the tiny Pix3D model of tests/test_pix3d.py (64x64), a
global batch of 4, float32 backbones.

  * the gathered outputs against JAX's, at the single-device tolerances of
    tests/test_torch_slice.py and tests/test_torch_pix3d.py: logits, voxels,
    scores, RoI features and mask probabilities 1e-4 relative, boxes 1e-3 px,
    validity, labels, cubify meshes and overflow exact, refined vertices 5e-4
    relative;
  * against the port's one-process eval of the same global batch in the
    ranks' halves: 1e-6 relative (the gather is exact), and both ranks hold
    the same gathered bits; against its eval of the whole batch in one
    forward: the same but for the refined vertices, 1e-4 relative (a
    convolution over 4 images rounds otherwise than over 2, by ~1e-7, and the
    refine stages carry that to 8e-6 at stage 2 of the tiny ShapeNet model);
  * ``validate`` and ``validate_pix3d`` with a ``shard_fn`` over two global
    batches: rank 0's metrics, ranked AP included, equal the one-process
    loop's on the same draws (1e-6), and the other rank returns None.
Each JAX program is built once for the module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import struct
from jax.sharding import Mesh

import __graft_entry__ as graft
from meshrcnn_tpu.models.pix3d import Pix3DModel as JaxPix3DModel
from meshrcnn_tpu.parallel import train_step as jts
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from tests import torch_dp_ranks
from tests.test_pix3d import TINY, tiny_batch
from tests.torch_parity import host_batch, rel_err, state_dict_from_flax

WORLD = 2
B = 4
PCS = 128
PORT_TINY = {k: v for k, v in TINY.items() if k not in ("roi_batch_size", "mask_rois")}
MODELS = {
    "ShapeNet": functools.partial(ShapeNetModel, num_classes=13, residual=False,
                                  cubify_threshold=0.2, voxel_out_channels=8,
                                  vert_capacity=512, face_capacity=1024, edge_capacity=2048,
                                  num_refinement_stages=3),
    "Pix3D": functools.partial(Pix3DModel, backbone_dtype="float32", **PORT_TINY),
}


@struct.dataclass
class _State:
    """The two fields of the JAX TrainState that its eval step reads."""
    params: dict
    batch_stats: dict


def _second(batch):
    """Another global batch: the images flipped, other labels."""
    return batch.replace(images=batch.images[:, ::-1],
                         labels=jnp.asarray([3, 7, 1, 5], dtype=jnp.int32))


@pytest.fixture(scope="module")
def ref():
    """JAX's DP eval output of each model, with the weights as a state_dict."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    out = {}
    for name, jm, batch in (
            ("ShapeNet", graft._tiny_model().clone(backbone_dtype="float32"),
             graft._tiny_batch(B)),
            ("Pix3D", JaxPix3DModel(backbone_dtype="float32", **TINY), tiny_batch(B))):
        v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(batch.images)
        state = _State(params=v["params"], batch_stats=v["batch_stats"])
        jout = jts.make_dp_eval_step(jm, mesh, split=False)(state, batch.images)
        sd = {k: t.numpy() for k, t in state_dict_from_flax(
            MODELS[name](), v["params"], v["batch_stats"]).items()}
        out[name] = dict(jout=jax.tree_util.tree_map(np.asarray, jout), sd=sd, batch=batch)
    return out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Both models' DP eval and DP validate loops on two gloo ranks, one spawn."""
    jobs = []
    for name in MODELS:
        r = ref[name]
        batches = [host_batch(r["batch"]), host_batch(_second(r["batch"]))]
        jobs.append(dict(kind="eval", model=MODELS[name], state_dict=r["sd"],
                         batch=batches[0]))
        jobs.append(dict(kind="validate", model=MODELS[name], state_dict=r["sd"],
                         loader=batches, config=TrainConfig(point_cloud_size=PCS),
                         num_classes=10 if name == "Pix3D" else 13, seed=11,
                         pix3d=name == "Pix3D"))
    ranks = torch_dp_ranks.run(jobs, tmp_path_factory.mktemp("dp_eval"), WORLD)
    return {name: dict(eval=[r[2 * i] for r in ranks], validate=[r[2 * i + 1] for r in ranks],
                       jobs=jobs[2 * i:2 * i + 2])
            for i, name in enumerate(MODELS)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("chunks", [WORLD, 1])
def test_gathered_outputs_equal_one_process_eval(runs, name, chunks):
    r0, r1 = (r["out"] for r in runs[name]["eval"])
    want = dict(_leaves(torch_dp_ranks.eval_one_process(runs[name]["jobs"][0], chunks)))
    got, other = dict(_leaves(r0)), dict(_leaves(r1))
    assert set(got) == set(want) == set(other) and want
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert np.array_equal(got[k], other[k]), k
        if v.dtype.kind == "f":
            tol = 1e-4 if chunks == 1 and k.startswith("stage_verts.") and k[-1] != "0" else 1e-6
            assert rel_err(got[k], v) <= tol, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_shapenet_gathered_outputs_match_jax(ref, runs):
    got, jout = runs["ShapeNet"]["eval"][0]["out"], ref["ShapeNet"]["jout"]
    assert rel_err(got["logits"], jout.logits) < 1e-4
    assert rel_err(got["voxels"], jout.voxels) < 1e-4
    for k in ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask"):
        np.testing.assert_array_equal(got["mesh"][k], np.asarray(getattr(jout.mesh, k)),
                                      err_msg=k)
    for k in ("verts", "faces", "edges"):
        np.testing.assert_array_equal(got["overflow"][k], getattr(jout.overflow, k))
    assert len(got["stage_verts"]) == 4
    for a, b in zip(got["stage_verts"], jout.stage_verts):
        assert rel_err(a, b) < 5e-4


def test_pix3d_gathered_outputs_match_jax(ref, runs):
    got, jout = runs["Pix3D"]["eval"][0]["out"], ref["Pix3D"]["jout"]
    gd, jd = got["detections"], jout.detections
    np.testing.assert_array_equal(gd["valid"], jd.valid)
    np.testing.assert_array_equal(gd["labels"], jd.labels)
    assert gd["valid"].any(1).all()
    np.testing.assert_allclose(gd["boxes"], jd.boxes, atol=1e-3)
    assert rel_err(gd["scores"], jd.scores) < 1e-4
    assert rel_err(gd["roi_features"], jd.roi_features) < 1e-4
    assert rel_err(got["mask_probs"], jout.mask_probs) < 1e-4
    assert rel_err(got["voxels"], jout.voxels) < 1e-4
    np.testing.assert_array_equal(got["mesh_valid"], jout.mesh_valid)
    for k in ("verts", "verts_mask", "faces", "faces_mask", "edges", "edges_mask"):
        np.testing.assert_array_equal(got["mesh"][k], getattr(jout.mesh, k), err_msg=k)
    for a, b in zip(got["stage_verts"], jout.stage_verts):
        assert rel_err(a, b) < 5e-4


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_validate_equals_one_process(runs, name):
    """Rank 0's metrics of the DP loop, ranked AP included, against the
    one-process loop over the same global batches and draws."""
    r0, r1 = (r["results"] for r in runs[name]["validate"])
    assert r1 is None
    want = torch_dp_ranks.validate_one_process(runs[name]["jobs"][1])
    assert set(r0) == set(want)
    for k, v in want.items():
        if k.endswith("_time") or k == "data_loading":
            continue
        if k == "confusion":
            np.testing.assert_array_equal(r0[k], v)
        else:
            assert rel_err(r0[k], v) <= 1e-6, (k, r0[k], v)
    if name == "Pix3D":
        assert {"AP50_box", "AP50_mask", "AP_mesh_ranked"} <= set(r0)
