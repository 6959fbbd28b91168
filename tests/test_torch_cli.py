"""The port's entry points, ``python -m meshrcnn_tpu_torch.train`` and
``eval_model``, on the CPU at tiny sizes (a 16-feature, one- or two-stage
model, capacities 512/1024/2048, 256-point clouds, 64x64 Pix3D images).

  * both models train, checkpoint, resume and evaluate through the port's
    data layer; the stats files load with the JAX package's ``load_stats``
    (``plot_stats.py`` reads them so);
  * ``--device`` defaults to the card and raises without one;
  * the eval CLI on a checkpoint holding a JAX model's weights, with JAX's
    draws handed in through ``uniform``, gives JAX ``harness.validate``'s
    metrics over the same loader: losses within 1e-4 of scale, voxel IoU and
    the confusion exactly. F1 within 2 points a sample and tau (2 /
    point_cloud_size each): the JAX neighbour sums cancel to ~1e-4 relative
    over the refine stages (tests/test_torch_slice.py), so a sampled point
    within that of tau may land on the other side.
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from flax import struct

from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.core.config import TrainConfig as JaxTrainConfig
from meshrcnn_tpu.data.datasets import SyntheticDataset as JaxSyntheticDataset
from meshrcnn_tpu.data.datasets import dataLoader as jax_data_loader
from meshrcnn_tpu.harness import validate as jax_validate
from meshrcnn_tpu.models.shapenet import ShapeNetModel as JaxShapeNetModel
from meshrcnn_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from meshrcnn_tpu.utils.meters import load_stats as jax_load_stats
from meshrcnn_tpu_torch import eval_model, train
from meshrcnn_tpu_torch.core.config import TrainConfig
from meshrcnn_tpu_torch.parallel.train_step import create_train_state
from meshrcnn_tpu_torch.utils import cli
from meshrcnn_tpu_torch.utils.checkpoint import save_state
from tests.torch_parity import Replay, eval_metric_draws, load_flax

PCS = 256
SMALL = ["--featDim", "16", "--vert_capacity", "512", "--face_capacity", "1024",
         "--edge_capacity", "2048", "--point_cloud_size", str(PCS), "--device", "cpu",
         "--workers", "2", "--print_freq", "1"]
PIX3D = ["--img_size", "64", "--rpn_post_nms_top_n", "32"]
PIX3D_TRAIN = ["--rpn_pre_nms_top_n", "64", "--roi_batch_size", "32", "--optim", "SGD",
               "--lr", "0.01"]


@struct.dataclass
class _State:
    """The two fields of the JAX TrainState that its eval step reads."""
    params: dict
    batch_stats: dict


@pytest.mark.parametrize("model", ["ShapeNet", "Pix3D"])
def test_train_resume_and_eval_on_cpu(tmp_path, capsys, model):
    common = ["--model", model, "-b", "2", "-nr", "2", "--synthetic_size", "8"] + SMALL
    if model == "Pix3D":
        common += PIX3D
    extra = PIX3D_TRAIN if model == "Pix3D" else []
    out = train.main(common + extra + ["--num_sampels", "2", "--nEpoch", "2",
                                       "--checkpoint_root", str(tmp_path / "ck")])
    assert out["dir"].startswith(str(tmp_path / "ck" / model / "GCN"))
    assert [os.path.basename(p) for p in out["checkpoints"]] == ["model_0.pt", "model_1.pt"]
    assert all(os.path.isfile(p) for p in out["checkpoints"] + out["stats"] + [out["final"]])
    assert out["state"].step == 2
    stats = jax_load_stats(out["stats"][1])          # what plot_stats.py reads
    assert stats["voxel_loss"]["name"] == "voxel_loss"
    assert len(stats["chamfer_loss"]["history"]) == 2
    assert all(type(h) is float and np.isfinite(h) for v in stats.values() for h in v["history"])

    assert "Epoch: [1][0/1]\tbatch_time " in capsys.readouterr().out   # ProgressMeter's line

    resumed = train.main(common + extra + ["--num_sampels", "2", "--nEpoch", "1",
                                           "--model_path", out["final"],
                                           "--checkpoint_root", str(tmp_path / "resumed")])
    assert resumed["state"].step == 3
    if model == "Pix3D":                               # the Pix3D schedule continues
        assert resumed["state"].scheduler.last_epoch == 3

    res = eval_model.main(common + ["--model_path", out["final"], "--test_ratio", "0.5",
                                    "--output_path", str(tmp_path / "ev")])
    assert res["path"] == str(tmp_path / "ev" / f"metrics_{model}.st")
    with open(res["path"], "rb") as f:
        saved = pickle.load(f)
    assert saved["confusion"].shape == ((10, 10) if model == "Pix3D" else (13, 13))
    assert saved["confusion"].sum() == 4                  # 2 batches of the held-out half
    scalars = {k: v for k, v in saved.items() if k != "confusion"}
    assert all(np.isfinite(v) for v in scalars.values())
    want = {"voxel_loss", "chamfer_loss", "normal_loss", "edge_loss", "voxel_iou", "f0_1",
            "f0_3", "f0_5", "F1@0.1", "F1@0.3", "batch_time", "data_loading", "warmup_time"}
    if model == "Pix3D":
        want |= {"AP_box", "AP_mask", "AP_mesh", "AP50_box", "AP50_mask", "AP_mesh_ranked"}
    assert set(scalars) == want


def test_eval_default_test_ratio_takes_every_sample(tmp_path):
    """With ``--test_ratio`` at its default 1 the test side is the whole dataset."""
    res = eval_model.main(["--model", "ShapeNet", "-b", "2", "-nr", "1", "--synthetic_size",
                           "4", "--output_path", str(tmp_path)] + SMALL)
    assert res["confusion"].sum() == 4
    assert all(np.isfinite(v) for k, v in res.items() if k not in ("confusion", "path"))


def test_device_defaults_to_the_card_and_raises_without_one(monkeypatch, tmp_path):
    assert train.parser.parse_args(["--model", "ShapeNet"]).device == "cuda"
    assert eval_model.parser.parse_args(["--model", "Pix3D"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train.main, eval_model.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--model", "ShapeNet", "--checkpoint_root", str(tmp_path)]
                 if main is train.main else ["--model", "ShapeNet"])
    assert not (tmp_path / "ShapeNet").exists()


def test_eval_cli_on_jax_weights_matches_jax_validate(tmp_path):
    B, size, test_ratio = 2, 8, 0.5
    flags = ["--model", "ShapeNet", "-b", str(B), "-nr", "1", "--synthetic_size", str(size),
             "--test_ratio", str(test_ratio)] + SMALL
    options = eval_model.parser.parse_args(flags)
    settings = cli.model_settings(options, torch.device("cpu"))
    assert settings["backbone_dtype"] == "float32"      # "auto" on the CPU

    jm = JaxShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                          vertex_feature_dim=16, num_refinement_stages=1, vert_capacity=512,
                          face_capacity=1024, edge_capacity=2048, backbone_dtype="float32")
    caps = JaxCapacityConfig(verts=512, faces=1024, edges=2048)
    loader = jax_data_loader(JaxSyntheticDataset(n=size, image_size=137, num_voxels=32,
                                                 num_classes=13),
                             B, 48, caps, test=True, train_ratio=max(1e-9, 1.0 - test_ratio))
    first = next(iter(loader))                # the JAX CLI's initialising batch
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(3), x, train=False))(first.images)
    rng = jax.random.PRNGKey(0)
    want = jax_validate(0, jax_make_eval_step(jm), _State(variables["params"],
                                                          variables["batch_stats"]),
                        loader, JaxTrainConfig(point_cloud_size=PCS), 13, rng)

    model = load_flax(cli.build_model(settings, torch.device("cpu")), variables)
    path = save_state(create_train_state(model, TrainConfig()), str(tmp_path / "jax"), settings)
    draws = [d for i in range(len(loader)) for d in
             eval_metric_draws(jax.random.fold_in(rng, i), B, PCS, num_stages=1)]
    got = eval_model.main(flags + ["--model_path", path, "--output_path", str(tmp_path)],
                          uniform=Replay(draws))
    assert set(got) == set(want) | {"path"}
    for k in ("voxel_loss", "chamfer_loss", "normal_loss", "edge_loss"):
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), (k, got[k], want[k])
    for k in ("voxel_iou", "f0_1", "f0_3", "f0_5"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for tau in (0.1, 0.3):
        assert abs(got[f"F1@{tau}"] - want[f"F1@{tau}"]) <= 2.0 / PCS, tau
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
