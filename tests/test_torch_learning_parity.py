"""The port's learning-parity protocol (``python -m
meshrcnn_tpu_torch.learning_parity``) against the baseline arm of the JAX
package's tools/agg_bf16_parity.py.

The protocol's train and held-out batches equal, bit for bit, those of the
JAX tool's ``batches_of`` (numpy only, no JAX program built). The JAX tool's
``main`` runs with its model, steps and metrics stubbed, which gives the keys
of the JSON lines it prints; a one-epoch port run at a tiny width patched in
here (one refinement stage of 16 features, 64-point clouds, float32
backbone) prints the same keys, each line naming its seed, and a summary.
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax
import pytest
import torch

import meshrcnn_tpu.harness as jax_harness
import meshrcnn_tpu.parallel.train_step as jax_train_step
import meshrcnn_tpu.utils.cache as jax_cache
from meshrcnn_tpu.core.config import CapacityConfig as JaxCapacityConfig
from meshrcnn_tpu.data import datasets as jd
from meshrcnn_tpu_torch import learning_parity
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from tests.test_torch_data import _equal

ROOT = Path(__file__).resolve().parent.parent


def _jax_batches(n, batch):
    """The JAX tool's ``batches_of`` (tools/agg_bf16_parity.py:86-98)."""
    caps = JaxCapacityConfig(verts=2048, faces=4096, edges=8192)
    n_train = n - n // 6
    ds = jd.SyntheticDataset(n=n, image_size=137, num_voxels=32, num_classes=13, pix3d=False)

    def batches_of(lo, hi):
        return [jd.collate([ds[j] for j in range(i, i + batch)], 48, caps)
                for i in range(lo, hi - batch + 1, batch)]
    return batches_of(0, n_train), batches_of(n_train, n)


@pytest.mark.parametrize("n,batch", [(240, 4), (50, 3)])
def test_protocol_batches_equal_the_jax_tools(n, batch):
    got_train, got_test = learning_parity.protocol_batches(n, batch)
    want_train, want_test = _jax_batches(n, batch)
    assert (len(got_train), len(got_test)) == (len(want_train), len(want_test))
    for i, (a, b) in enumerate(zip(got_train + got_test, want_train + want_test)):
        _equal(a, b, f"batch {i}")
    if (n, batch) == (240, 4):
        assert (len(got_train), len(got_test)) == (50, 10)


def _lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def _jax_lines(monkeypatch, capsys) -> list:
    """The JSON lines of the JAX tool's baseline arm, everything heavy stubbed."""
    spec = importlib.util.spec_from_file_location("agg_bf16_parity",
                                                  ROOT / "tools" / "agg_bf16_parity.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    metrics = {"voxel_loss": 1.0, "chamfer_loss": 1.0, "edge_loss": 1.0, "loss": 1.0}
    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: fn)
    monkeypatch.setattr(jax_train_step, "create_train_state", lambda *a, **k: None)
    monkeypatch.setattr(jax_train_step, "make_train_step",
                        lambda *a, **k: lambda state, b, key: (state, metrics))
    monkeypatch.setattr(jax_train_step, "make_eval_step", lambda *a, **k: lambda s, im: None)
    monkeypatch.setattr(jax_harness, "_shapenet_eval_metrics", lambda *a: {
        "voxel_loss": 1.0, "voxel_iou": 1.0, "chamfer_loss": 1.0, "f1_sum": [1.0, 1.0],
        "f1_count": 1})
    monkeypatch.setattr(sys, "argv", ["agg_bf16_parity.py", "--epochs", "1", "--n", "12",
                                      "--batch", "2", "--arms", "baseline"])
    capsys.readouterr()
    tool.main()
    return _lines(capsys.readouterr().out)


def _tiny(batch, device):
    torch.manual_seed(0)
    model = ShapeNetModel(num_classes=13, residual=True, vertex_feature_dim=16,
                          num_refinement_stages=1, vert_capacity=512, face_capacity=1024,
                          edge_capacity=2048).to(device)
    config = TrainConfig(optimizer="adam", lr=1e-4, weight_decay=0.0, batch_size=batch,
                         point_cloud_size=64, normal_k=4, distance_tile=32, train_backbone=True,
                         loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5))
    return model, config


def test_one_tiny_epoch_prints_the_jax_tools_json_keys(monkeypatch, capsys):
    want = _jax_lines(monkeypatch, capsys)
    monkeypatch.setattr(learning_parity, "_setup", _tiny)
    results = learning_parity.main(["--device", "cpu", "--seeds", "3", "--epochs", "1",
                                    "--n", "12", "--batch", "2"])
    got = _lines(capsys.readouterr().out)
    device, epoch, heldout, summary = got
    assert device["device"] == "cpu" and device["power_limit_w"] is None
    assert [set(line) for line in want] == [set(epoch) - {"seed"}, set(heldout) - {"seed"}]
    assert set(heldout["heldout"]) == set(want[1]["heldout"])
    assert epoch["arm"] == heldout["arm"] == "baseline" and epoch["seed"] == 3
    assert results[3]["heldout"] == heldout["heldout"]
    assert set(summary["summary"]["3"]) == {"finite", "voxel_loss_fell", "chamfer_loss_fell",
                                            "F1@0.1", "F1@0.3"}
    assert summary["summary"]["3"]["finite"] is True
    assert 0.0 <= heldout["heldout"]["F1@0.1"] <= heldout["heldout"]["F1@0.3"] <= 1.0


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        learning_parity.main(["--epochs", "1"])
