"""The port's copies of numpy-level helpers against the JAX package's originals:
config defaults, shape arithmetic, confusion F-beta and the meters (exact)."""
import dataclasses

import numpy as np
import pytest

from meshrcnn_tpu.core import config as jax_config
from meshrcnn_tpu.utils import shapes as jax_shapes
from meshrcnn_tpu.utils.meters import AverageMeter as JaxAverageMeter
from meshrcnn_tpu.utils.metrics import f_score as jax_f_score
from meshrcnn_tpu_torch.core import config
from meshrcnn_tpu_torch.utils import shapes
from meshrcnn_tpu_torch.utils.meters import AverageMeter
from meshrcnn_tpu_torch.utils.metrics import f_score


@pytest.mark.parametrize("name", ["CapacityConfig", "ShapeNetConfig", "Pix3DConfig",
                                  "TrainConfig", "LossWeights"])
def test_config_defaults_match_jax(name):
    """Every field the port shares with the JAX package has its default; the
    port's own field is the normal estimator switch, which the JAX package
    reads from MESHRCNN_FACE_NORMALS (default on)."""
    ours = dataclasses.asdict(getattr(config, name)())
    theirs = dataclasses.asdict(getattr(jax_config, name)())
    own = {"face_normals": True} if name == "TrainConfig" else {}
    assert {k: v for k, v in ours.items() if k not in own} == {
        k: theirs[k] for k in ours if k not in own}
    assert {k: ours[k] for k in own} == own


def test_pix3d_model_from_config():
    """``Pix3DModel.from_config`` takes each Pix3DConfig field the JAX
    package's ``Pix3DAPI`` passes to its model; keywords set the rest."""
    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    cfg = config.Pix3DConfig(num_classes=4, cubify_threshold=0.3, vertex_feature_dim=16,
                             num_refinement_stages=2, detections_per_img=2,
                             capacities=config.CapacityConfig(verts=64, faces=128, edges=256))
    m = Pix3DModel.from_config(cfg, rpn_post_nms_top_n=32, backbone_dtype="float32")
    assert (m.cubify_threshold, m.detections_per_img, m.num_refinement_stages) == (0.3, 2, 2)
    assert (m.vert_capacity, m.face_capacity, m.edge_capacity) == (64, 128, 256)
    assert m.backbone.roi_heads.num_classes == 4
    assert m.refine1.graphConv0.w0.out_features == 16
    assert not hasattr(m, "refine2") and not m.voxel_only
    assert m.backbone.rpn_post_nms_top_n == 32


@pytest.mark.parametrize("kw", [dict(kernel=3, padding=1), dict(kernel=7, padding=3, stride=2),
                                dict(kernel=(3, 1), padding=(1, 0), dilation=2)])
def test_shape_arithmetic_matches_jax(kw):
    for h, w in ((137, 137), (5, 9), (48, 17)):
        assert shapes.conv_output(h, w, **kw) == jax_shapes.conv_output(h, w, **kw)
        assert shapes.convT_output(h, w, **kw) == jax_shapes.convT_output(h, w, **kw)


def test_f_score_and_meter_match_jax():
    cm = np.random.RandomState(0).randint(0, 9, (13, 13))
    cm[3] = 0                                            # a class never seen
    for beta in (0.1, 0.3, 0.5, 1.0):
        np.testing.assert_array_equal(f_score(cm, beta), jax_f_score(cm, beta))
    ours, theirs = AverageMeter("x"), JaxAverageMeter("x")
    for v, n in ((1.5, 1), (float("nan"), 2), (2.0, 3), (float("inf"), 1)):
        ours.update(v, n)
        theirs.update(v, n)
    assert (ours.avg, ours.sum, ours.count) == (theirs.avg, theirs.sum, theirs.count)
