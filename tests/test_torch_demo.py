"""The port's demo (``python -m meshrcnn_tpu_torch.demo``) against the JAX
package's ``demo.main`` on the same PNG, for both models, each loading its own
package's checkpoint saved from the same flax parameters.

Sizes: ShapeNet at 48x48 with 16 vertex features and capacities
512/1024/2048; Pix3D at 64x64 (``--img_size``) with tests/test_pix3d.py's
tiny RPN and RoI sizes and capacities 256/512/1024. Both packages' demos build
their backbones in bfloat16; the test builds them in float32 on both sides
(the JAX model classes wrapped with ``backbone_dtype="float32"``, the port's
``demo.BACKBONE_DTYPE``), so that the comparison can be tight, and the JAX
Pix3D RoIAlign by corner gathers (``MESHRCNN_MATMUL_ROIALIGN=0``).

Tolerances and why: the artifact names and each OBJ's faces exact (cubify of
the same voxels); OBJ vertices 5e-4 relative, the refine stages' bound in
tests/test_torch_slice.py (the JAX neighbour sums); the voxel grids exact
(binarised occupancy away from the threshold; each probability is 1e-4 from
JAX's).
"""
import functools
import os
import shutil
import sys

import jax
import numpy as np
import PIL.Image
import pytest
import torch

import demo as jax_demo
import meshrcnn_tpu.models.pix3d as jax_pix3d
import meshrcnn_tpu.models.shapenet as jax_shapenet
import meshrcnn_tpu.utils.cache as jax_cache
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.parallel.train_step import create_train_state as jax_create_train_state
from meshrcnn_tpu.utils.checkpoint import save_state as jax_save_state
from meshrcnn_tpu_torch import demo
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.data.serialization import load_mesh
from meshrcnn_tpu_torch.parallel.train_step import create_train_state
from meshrcnn_tpu_torch.utils.checkpoint import save_state
from tests.test_pix3d import TINY
from tests.torch_parity import load_flax, rel_err

SIZES = {"ShapeNet": ["--featDim", "16", "--vert_capacity", "512", "--face_capacity", "1024",
                      "--edge_capacity", "2048"],
         "Pix3D": ["--img_size", "64", "--vert_capacity", "256", "--face_capacity", "512",
                   "--edge_capacity", "1024"]}
PIX3D_HEADS = {k: v for k, v in TINY.items()
               if k in ("voxel_out_channels", "rpn_pre_nms_top_n", "rpn_post_nms_top_n",
                        "roi_batch_size", "mask_rois", "detections_per_img")}


@pytest.fixture
def float32_models(monkeypatch):
    """Both packages' demo models in float32, Pix3D at the tiny RPN / RoI sizes."""
    import meshrcnn_tpu_torch.models.pix3d as port_pix3d
    monkeypatch.setenv("MESHRCNN_MATMUL_ROIALIGN", "0")
    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_shapenet, "ShapeNetModel",
                        functools.partial(jax_shapenet.ShapeNetModel, backbone_dtype="float32"))
    monkeypatch.setattr(jax_pix3d, "Pix3DModel",
                        functools.partial(jax_pix3d.Pix3DModel, backbone_dtype="float32",
                                          **PIX3D_HEADS))
    monkeypatch.setattr(demo, "BACKBONE_DTYPE", "float32")
    monkeypatch.setattr(port_pix3d, "Pix3DModel",
                        functools.partial(port_pix3d.Pix3DModel, **PIX3D_HEADS))
    return port_pix3d


def _image(tmp_path, size: int) -> str:
    rng = np.random.RandomState(5)
    path = str(tmp_path / "chair.png")
    PIL.Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(path)
    return path


def _checkpoints(tmp_path, model: str, flags: list, port_pix3d):
    """(JAX orbax checkpoint, port .pt) of one set of flax parameters for the
    demo model of ``flags``."""
    options = demo.parser.parse_args(["--model", model, "--imagePath", "x.png"] + flags)
    settings = demo._settings(options)
    kwargs = {k: v for k, v in settings.items() if k not in ("model", "voxel_only")}
    jax_kwargs = {k: v for k, v in kwargs.items() if k != "backbone_dtype"}
    if model == "Pix3D":
        jm = jax_pix3d.Pix3DModel(**jax_kwargs)
        tm = port_pix3d.Pix3DModel(**kwargs)
    else:
        jm = jax_shapenet.ShapeNetModel(**jax_kwargs)
        from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
        tm = ShapeNetModel(**kwargs)
    size = 64 if model == "Pix3D" else 48
    state = jax_create_train_state(jm, JaxTrainConfig(), jax.random.PRNGKey(11),
                                   np.zeros((1, size, size, 3), np.float32))
    jpath = jax_save_state(state, str(tmp_path / "jax_ckpt"))
    load_flax(tm, {"params": state.params, "batch_stats": state.batch_stats})
    tpath = save_state(create_train_state(tm, TrainConfig()), str(tmp_path / "port_ckpt"),
                       settings)
    return jpath, tpath


@pytest.mark.parametrize("model", ["ShapeNet", "Pix3D"])
def test_demo_matches_jax_artifacts(tmp_path, monkeypatch, float32_models, model):
    image = _image(tmp_path, 80 if model == "Pix3D" else 48)    # Pix3D resizes to 64
    jpath, tpath = _checkpoints(tmp_path, model, SIZES[model], float32_models)
    common = ["--model", model, "--imagePath", image] + SIZES[model]
    monkeypatch.setattr(sys, "argv", ["demo.py"] + common + ["--modelPath", jpath,
                                                             "--savePath", str(tmp_path / "j")])
    jax_demo.main()
    out = demo.main(common + ["--modelPath", tpath, "--savePath", str(tmp_path / "p"),
                              "--device", "cpu"])

    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    objects = [n for n in names if n.endswith(".npy")]
    assert objects and len(names) == 5 * len(objects)     # a grid and 4 stage meshes each
    assert sorted(os.path.join(str(tmp_path / "p"), n) for n in names) == sorted(
        out["voxels"] + out["meshes"])
    for n in names:
        got, want = tmp_path / "p" / n, tmp_path / "j" / n
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(got), np.load(want))
            continue
        g, w = load_mesh(str(got)), load_mesh(str(want))
        np.testing.assert_array_equal(g.faces, w.faces)
        assert g.vertices.shape == w.vertices.shape and rel_err(g.vertices, w.vertices) < 5e-4
    shutil.rmtree(tmp_path)          # two packages' checkpoints of a ResNet-50 model


def test_demo_refuses_a_checkpoint_with_nothing_to_load(tmp_path, float32_models):
    image = _image(tmp_path, 48)
    flags = ["--model", "ShapeNet", "--imagePath", image, "--device", "cpu"] + SIZES["ShapeNet"]
    settings = demo._settings(demo.parser.parse_args(flags))
    bad = str(tmp_path / "bad.pt")
    torch.save({"model": {"unrelated.weight": torch.zeros(1)}, "settings": settings}, bad)
    with pytest.raises(SystemExit, match="no parameters could be loaded"):
        demo.main(flags + ["--modelPath", bad, "--savePath", str(tmp_path / "p")])


def test_demo_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        demo.main(["--model", "ShapeNet", "--imagePath", str(tmp_path / "none.png")])
