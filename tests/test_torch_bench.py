"""The port's bench (``python -m meshrcnn_tpu_torch.bench``) on the CPU, with
tiny recipes patched in for the full-width ones (the tiny ShapeNet model of
tests/test_train_step.py and the tiny Pix3D model of tests/test_pix3d.py,
64-point clouds) and windows of 2 steps or batches.

Its record against the JAX package's ``bench.py``: the JAX bench's ``main``
runs with its measurements stubbed (``measure``, ``_measure_eval`` and the
recipes return at once), which gives the exact keys it prints. The port's
record has the same keys less ``pix3d_eval_vs_prefusion_record`` (a record
of another device) plus ``device`` and ``power_limit_w``, under the default
budget and under ``--budget 0`` (every secondary ``*_skipped``).
"""
import json
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
import meshrcnn_tpu.parallel.train_step as jax_train_step
import meshrcnn_tpu.utils.cache as jax_cache
from meshrcnn_tpu_torch import bench
from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
from meshrcnn_tpu_torch.parallel import train_step
from tests.test_pix3d import TINY
from tests.test_pix3d import tiny_batch as pix3d_tiny_batch
from tests.test_train_step import tiny_batch
from tests.torch_parity import host_batch

PCS = 64
WINDOWS, N_STEPS, EVAL_BATCHES = 2, 2, 2


def _tiny_shapenet(B, device, report_unweighted=False):
    torch.manual_seed(0)
    model = ShapeNetModel(num_classes=13, residual=True, voxel_out_channels=8,
                          vert_capacity=512, face_capacity=1024, edge_capacity=2048,
                          backbone_dtype="bfloat16").to(device)
    config = TrainConfig(optimizer="adam", lr=1e-4, weight_decay=0.0, batch_size=B,
                         point_cloud_size=PCS, normal_k=4, distance_tile=32,
                         report_unweighted_losses=report_unweighted,
                         loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0, edge=0.5))
    return model, config, host_batch(tiny_batch(B))


def _tiny_pix3d(B, device):
    torch.manual_seed(0)
    model = Pix3DModel(**TINY).to(device).train()
    config = TrainConfig(optimizer="sgd", lr=0.02, weight_decay=1e-4, batch_size=B,
                         point_cloud_size=PCS, normal_k=4, distance_tile=32,
                         train_backbone=True, pix3d_schedule=True,
                         loss_weights=LossWeights(voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5))
    return model, config, host_batch(pix3d_tiny_batch(B))


@pytest.fixture
def tiny(monkeypatch):
    """Tiny recipes and short windows; counts of train steps and eval forwards."""
    monkeypatch.setattr(bench, "_shapenet_setup", _tiny_shapenet)
    monkeypatch.setattr(bench, "_pix3d_setup", _tiny_pix3d)
    for name, value in (("WINDOWS", WINDOWS), ("N_STEPS", N_STEPS),
                        ("EVAL_BATCHES", EVAL_BATCHES)):
        monkeypatch.setattr(bench, name, value)
    calls = {"train": 0, "eval": 0}

    def counted(make, kind):
        def wrapper(*args, **kwargs):
            fn = make(*args, **kwargs)

            def run(*a, **k):
                calls[kind] += 1
                return fn(*a, **k)
            return run
        return wrapper
    monkeypatch.setattr(train_step, "make_train_step",
                        counted(train_step.make_train_step, "train"))
    monkeypatch.setattr(train_step, "make_eval_step", counted(train_step.make_eval_step, "eval"))
    return calls


def _records(out: str) -> list:
    return [json.loads(line) for line in out.strip().splitlines() if line.startswith("{")]


def _jax_keys(monkeypatch, capsys, argv) -> set:
    """The keys of the last record JAX's bench.py prints, its measurements stubbed."""
    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_bench, "measure", lambda *a, **k: (1.0, [1.0] * 5, 1e9))
    monkeypatch.setattr(jax_bench, "_measure_eval", lambda *a, **k: (1.0, [1.0] * 5))
    monkeypatch.setattr(jax_bench, "_shapenet_setup", lambda *a, **k: (None,) * 4)
    monkeypatch.setattr(jax_bench, "_pix3d_setup", lambda *a, **k: (None,) * 4)
    monkeypatch.setattr(jax_train_step, "make_train_step", lambda *a, **k: None)
    monkeypatch.setattr(jax_train_step, "make_eval_step", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    capsys.readouterr()
    jax_bench.main()
    return set(_records(capsys.readouterr().out)[-1])


@pytest.mark.parametrize("budget", [None, "0"])
def test_record_keys_match_jax_bench(tiny, monkeypatch, capsys, budget):
    argv = [] if budget is None else ["--budget", budget]
    want = _jax_keys(monkeypatch, capsys, argv)
    last = bench.main(argv + ["--device", "cpu"])
    records = _records(capsys.readouterr().out)
    assert records[-1] == last
    assert set(last) == (want - {"pix3d_eval_vs_prefusion_record"}) | {"device",
                                                                       "power_limit_w"}
    assert last["device"] == "cpu" and last["power_limit_w"] is None
    skipped = {k for k in last if k.endswith("_skipped")}
    if budget is None:
        assert not skipped
        assert len(records) == 5                    # one cumulative line after each bench
        for a, b in zip(records, records[1:]):
            assert set(a) - {"bench_elapsed_s"} <= set(b)
        assert tiny == {"train": 3 * (1 + WINDOWS) * N_STEPS,
                        "eval": 2 * (1 + WINDOWS * EVAL_BATCHES)}
    else:
        assert skipped == {"pix3d_skipped", "shapenet_eval_skipped", "pix3d_eval_skipped",
                           "normal_term_skipped"}
        assert len(records) == 5                    # the headline, then a line a skip
        assert tiny == {"train": (1 + WINDOWS) * N_STEPS, "eval": 0}


def test_windows_flops_and_rates(tiny, capsys):
    rec = bench.main(["--model", "Pix3D", "--device", "cpu"])
    assert rec["metric"] == "pix3d_train_samples_per_sec"
    assert len(rec["window_s"]) == WINDOWS and all(w > 0 for w in rec["window_s"])
    assert tiny["train"] == (1 + WINDOWS) * N_STEPS
    B = 4
    sps = B * N_STEPS / float(np.median(rec["window_s"]))
    assert rec["value"] == pytest.approx(sps, rel=1e-2, abs=2e-3)
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 0.871, rel=1e-2, abs=2e-3)
    assert rec["flops_per_step"] > 0 and rec["achieved_tflops"] >= 0
    assert rec["mfu_pct_vs_bf16_peak"] is None        # no BF16 peak for the CPU


def test_peak_table_is_the_card_table():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert bench.peak_tflops("NVIDIA H100 PCIe") == 756.5
    assert bench.peak_tflops("NVIDIA H100 NVL") == 835.5
    assert bench.peak_tflops("cpu") is None
    fields = bench.mfu_fields([2.0, 1.0, 3.0], 1e12, 1000.0)
    step_s = 2.0 / bench.N_STEPS
    assert fields["achieved_tflops"] == round(1e12 / step_s / 1e12, 4)
    assert fields["mfu_pct_vs_bf16_peak"] == round(100 * (1e12 / step_s) / 1e15, 4)


def test_without_a_card_prints_the_error_record_and_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        bench.main([])
    assert exit_info.value.code == 1
    rec = _records(capsys.readouterr().out)[-1]
    assert rec["value"] == 0.0 and "error" in rec and rec["pix3d_train_samples_per_sec"] == 0.0
