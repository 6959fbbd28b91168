"""Data parallelism through the port's entry points and checkpoints, on the
CPU with gloo ranks, at tiny sizes (a 16-feature one-stage model,
capacities 512/1024/2048, 256-point clouds):

  * ``python -m meshrcnn_tpu_torch.train --device cpu --num_devices 2`` trains
    on the synthetic dataset: one checkpoint and one stats file an epoch, the
    checkpoint recording both ranks' generators; it loads into a one-process
    ``eval_model``, and resuming it at another world size raises;
  * under ``save_state`` rank 0 alone writes, and two DP steps, a save, a load
    into a fresh state and a third step equal three uninterrupted steps in
    every bit on both ranks (parameters, buffers, optimizer state, step and
    each rank's generator);
  * ``--num_devices`` above the visible cards raises, as does a global batch
    that does not split over the ranks or a loader that keeps a short last
    batch under a ``shard_fn``.
"""
import functools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from meshrcnn_tpu_torch import eval_model, harness, train
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.utils.checkpoint import WorldSizeError
from meshrcnn_tpu_torch.utils.meters import load_stats
from tests import torch_dp_ranks
import tests.torch_parity  # noqa: F401  (its import shares the cores among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--model", "ShapeNet", "--featDim", "16", "-nr", "1", "--vert_capacity", "512",
         "--face_capacity", "1024", "--edge_capacity", "2048", "--point_cloud_size", "256",
         "--device", "cpu", "--workers", "0", "--synthetic_size", "12"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two DP steps of 4 (2 a rank) through the CLI, in a process of its own."""
    root = tmp_path_factory.mktemp("dp_cli")
    cmd = [sys.executable, "-m", "meshrcnn_tpu_torch.train", *SMALL, "-b", "4",
           "--num_sampels", "8", "--nEpoch", "1", "--num_devices", "2", "--print_freq", "1",
           "--checkpoint_root", str(root / "ck")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (day,) = os.listdir(root / "ck" / "ShapeNet" / "GCN")
    return dict(root=root, out=proc.stdout, dir=root / "ck" / "ShapeNet" / "GCN" / day)


def test_cli_trains_on_two_ranks_and_rank0_writes_once(trained):
    assert sorted(os.listdir(trained["dir"])) == ["final.pt", "model_0.pt", "stats_0.st"]
    out = trained["out"]
    assert "2 rank(s)" in out and out.count("training done") == 1
    assert out.count("Epoch: [0][0/2]") == 1 and out.count("Epoch: [0][1/2]") == 1
    ckpt = torch.load(trained["dir"] / "final.pt", weights_only=True)
    assert ckpt["world_size"] == 2 and ckpt["step"] == 2
    g0, g1 = ckpt["generators"]
    assert not torch.equal(g0, g1)
    stats = load_stats(str(trained["dir"] / "stats_0.st"))
    assert stats["voxel_loss"]["history"] and np.isfinite(stats["loss"]["history"]).all()


def test_dp_checkpoint_loads_into_one_process_eval(trained, tmp_path):
    res = eval_model.main(SMALL + ["-b", "2", "--test_ratio", "0.34",
                                   "--model_path", str(trained["dir"] / "final.pt"),
                                   "--output_path", str(tmp_path)])
    assert os.path.exists(res["path"]) and np.isfinite(res["chamfer_loss"])


def test_resume_at_another_world_size_raises(trained, tmp_path):
    with pytest.raises(WorldSizeError, match="2 ranks, this run has 1"):
        train.main(SMALL + ["-b", "2", "--num_sampels", "2", "--nEpoch", "1",
                            "--num_devices", "1", "--checkpoint_root", str(tmp_path),
                            "--model_path", str(trained["dir"] / "final.pt")])


def test_save_and_resume_on_two_ranks_equal_three_steps(tmp_path):
    torch.manual_seed(3)
    model = functools.partial(ShapeNetModel, num_classes=13, residual=False,
                              cubify_threshold=0.2, voxel_out_channels=8, vert_capacity=512,
                              face_capacity=1024, edge_capacity=2048, num_refinement_stages=1,
                              vertex_feature_dim=16)
    sd = {k: v.numpy() for k, v in model().state_dict().items()}
    batches = [_host_batch(4, seed) for seed in range(3)]
    job = dict(kind="resume", model=model, state_dict=sd, seed=5,
               config=TrainConfig(optimizer="adam", lr=1e-3, point_cloud_size=128,
                                  loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.1,
                                                           edge=0.5)),
               settings={"model": "ShapeNet", "voxel_only": False, "backbone_dtype": "float32"},
               path=str(tmp_path / "mid"), batches=batches)
    r0, r1 = (r[0] for r in torch_dp_ranks.run([job], tmp_path))
    assert (r0["saves"], r1["saves"]) == (1, 0)
    for r in (r0, r1):
        a, b = r["whole"], r["resumed"]
        assert a["step"] == b["step"] == 3
        assert np.array_equal(a["generator"], b["generator"])
        for what in ("state", "optimizer"):
            assert set(a[what]) == set(b[what])
            for k in a[what]:
                assert np.array_equal(a[what][k], b[what][k]), (what, k)
    for k in r0["whole"]["state"]:
        assert np.array_equal(r0["whole"]["state"][k], r1["whole"]["state"][k]), k
    assert not np.array_equal(r0["whole"]["generator"], r1["whole"]["generator"])


def _host_batch(B: int, seed: int) -> types.SimpleNamespace:
    """A tiny numpy ShapeNet batch: 48x48 images, 8 ground-truth verts and 6 faces."""
    rng = np.random.RandomState(seed)
    faces = np.zeros((B, 12, 3), np.int32)
    faces[:, :6] = rng.randint(0, 8, (B, 6, 3))
    mask = np.zeros((B, 12), bool)
    mask[:, :6] = True
    return types.SimpleNamespace(
        images=rng.rand(B, 48, 48, 3).astype(np.float32),
        voxels=(rng.rand(B, 8, 18, 18) > 0.5).astype(np.float32),
        gt_verts=rng.randn(B, 8, 3).astype(np.float32), gt_faces=faces, gt_faces_mask=mask,
        labels=rng.randint(0, 13, (B,)).astype(np.int32))


def test_num_devices_above_the_visible_cards_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = [a if a != "cpu" else "cuda" for a in SMALL] + ["-b", "4", "--num_devices", "2"]
    with pytest.raises(ValueError, match="1 cuda devices are visible"):
        train.main(argv + ["--checkpoint_root", str(tmp_path)])
    with pytest.raises(ValueError, match="1 cuda devices are visible"):
        eval_model.main(argv + ["--output_path", str(tmp_path)])
    with pytest.raises(ValueError, match="devices are visible"):
        train.main(SMALL + ["-b", "4", "--num_devices", str((os.cpu_count() or 1) + 1)])


def test_batch_that_does_not_split_raises(tmp_path):
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        train.main(SMALL + ["-b", "3", "--num_devices", "2", "--checkpoint_root",
                            str(tmp_path)])


def test_short_last_batch_under_a_shard_fn_raises():
    class Loader(list):
        drop_last = False
    with pytest.raises(ValueError, match="drop_last=True"):
        harness.train_epoch(0, None, None, Loader([None]), {}, "cpu",
                            shard_fn=lambda b: b)
    with pytest.raises(ValueError, match="drop_last=True"):
        harness.validate(None, Loader([None]), TrainConfig(), 13, None, "cpu",
                         shard_fn=lambda b: b)
