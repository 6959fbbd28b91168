"""End-to-end throughput of the port's train and eval steps on a CUDA card
(counterpart of the JAX package's bench.py).

    python -m meshrcnn_tpu_torch.bench [--model both|ShapeNet|Pix3D] [--batch B]
                                       [--budget S] [--device cuda|cpu]

Recipes, random weights and data from seed 0 (``harness.shapenet_train_setup``
and ``pix3d_train_setup``):
  * ShapeNet: ResNet-50 in bfloat16 (the JAX model's default), residual
    refinement, 48^3 voxels, capacities 8192/16384/32768, 10k-point clouds,
    137x137 images, B=3; Adam lr 1e-4, frozen backbone, weights voxel 1 /
    chamfer 1 / normal 0 / edge 0.5. ``vs_baseline`` is against the
    reference's 1.84 samples/s (its PyTorch GPU figure, BASELINE.md);
  * Pix3D: the bfloat16 Mask R-CNN at 224x224, B=4, SGD under the Pix3D
    schedule with the backbone trained, weights voxel 3 / chamfer 1 / normal
    0.1 / edge 0.5; against the reference's best epoch, 0.871 samples/s;
  * the eval loops' per-batch work (the forward, then ``shapenet_eval_metrics``
    / ``pix3d_eval_metrics`` with ranked AP) of both recipes;
  * the ShapeNet recipe with its zero-weight normal term computed
    (``shapenet_with_normal_term_sps``).

One batch lives on the device and is reused by every step. A train bench
takes a warm-up window of ``N_STEPS`` steps, then ``WINDOWS`` windows of
``N_STEPS``; an eval bench one warm-up batch, then ``WINDOWS`` windows of
``EVAL_BATCHES``. Each window ends in one ``torch.cuda.synchronize()``; the
median window gives samples/s, and every train window is kept in
``window_s`` / ``pix3d_window_s``.

``flops_per_step`` comes from the first warm-up step under
``torch.utils.flop_counter.FlopCounterMode``, which counts matrix products
and convolutions (forward and backward) and nothing else, so it is a lower
bound of the work. ``mfu_pct_vs_bf16_peak`` is the achieved rate over the
card's dense BF16 tensor peak (``BF16_PEAK_TFLOPS``), None on another device.

After each bench a cumulative JSON record is printed and flushed, so the
last line is always the most complete one; ``device`` and ``power_limit_w``
name the card as ``nvidia-smi`` gives them. Once ``--budget`` seconds would
be passed, the secondary benches are skipped and recorded as ``*_skipped``.
Without a card, and without ``--device cpu``, it prints an error record and
exits 1.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

BASELINE_SAMPLES_PER_SEC = 1.84          # the reference's ShapeNet throughput
PIX3D_BASELINE_SAMPLES_PER_SEC = 0.871   # the reference's best Pix3D epoch

N_STEPS = 20        # train steps a window
EVAL_BATCHES = 5    # eval batches a window
WINDOWS = 5         # timed windows a bench

# dense BF16 tensor peaks by card, TFLOP/s (NVIDIA data sheets); "H100" is the SXM card
BF16_PEAK_TFLOPS = {"H100 PCIe": 756.5, "H100 NVL": 835.5, "H100": 989.4}


def peak_tflops(name: str):
    """The card's dense BF16 peak in TFLOP/s, None for a device not in the table."""
    for key, peak in BF16_PEAK_TFLOPS.items():
        if key in name:
            return peak
    return None


def _peak(device: torch.device):
    return peak_tflops(torch.cuda.get_device_name(device)) if device.type == "cuda" else None


def device_info(device: torch.device):
    """(name, power limit in W) of the card as ``nvidia-smi`` gives them;
    ("cpu", None) on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=30)
        name, limit = [s.strip() for s in smi.stdout.strip().splitlines()[0].split(",")]
        return name, float(limit.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return torch.cuda.get_device_name(index), None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(step, state, batch, B: int, device: torch.device):
    """(samples/s of the median window, window times in s, FLOPs of one step
    or None): a warm-up window of ``N_STEPS`` steps, its first under the FLOP
    counter, then ``WINDOWS`` timed windows of ``N_STEPS``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    flops = counter.get_total_flops() or None
    for _ in range(N_STEPS - 1):
        step(state, batch)
    _sync(device)
    times = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(N_STEPS):
            step(state, batch)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return B * N_STEPS / float(np.median(times)), times, flops


def mfu_fields(times, flops_per_step, peak) -> dict:
    """GFLOP a step, achieved TFLOP/s and its share of ``peak`` TFLOP/s (None without one)."""
    if flops_per_step is None:
        return {}
    achieved = flops_per_step / (float(np.median(times)) / N_STEPS)
    return {"flops_per_step": round(flops_per_step / 1e9, 2),
            "achieved_tflops": round(achieved / 1e12, 4),
            "mfu_pct_vs_bf16_peak": (None if peak is None
                                     else round(100.0 * achieved / (peak * 1e12), 4))}


def _shapenet_setup(B: int, device: torch.device, report_unweighted: bool = False):
    """(model, config, numpy batch) of the ShapeNet recipe, bfloat16 backbone."""
    from meshrcnn_tpu_torch.harness import shapenet_train_setup
    model, config, data = shapenet_train_setup(1, device, backbone_dtype="bfloat16",
                                               batch_size=B,
                                               report_unweighted_losses=report_unweighted)
    return model, config, data[0]


def _pix3d_setup(B: int, device: torch.device):
    """(model, config, numpy batch) of the Pix3D recipe."""
    from meshrcnn_tpu_torch.harness import pix3d_train_setup
    model, config, data = pix3d_train_setup(1, device, batch_size=B)
    return model, config, data[0]


def _train_bench(model, config, batch, B: int, device: torch.device):
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                        make_train_step)
    generator = torch.Generator(device=device).manual_seed(1)
    state = create_train_state(model, config, generator)
    step = make_train_step(config, uniform_from(generator))
    return measure(step, state, Batch.from_host(batch, device), B, device)


def bench_shapenet(B: int, device: torch.device, report_unweighted: bool = False):
    """ShapeNet train-step throughput. The recipe's normal weight is 0, so the
    normal term is left out of the step, as for a user of the recipe;
    ``report_unweighted=True`` computes it anyway, as the reference did."""
    model, config, batch = _shapenet_setup(B, device, report_unweighted)
    sps, times, flops = _train_bench(model, config, batch, B, device)
    return {"metric": "shapenet_train_samples_per_sec", "value": round(sps, 3),
            "unit": "samples/s", "vs_baseline": round(sps / BASELINE_SAMPLES_PER_SEC, 3),
            **mfu_fields(times, flops, _peak(device))}, times


def bench_pix3d(B: int, device: torch.device):
    """Pix3D train-step throughput."""
    model, config, batch = _pix3d_setup(B, device)
    sps, times, flops = _train_bench(model, config, batch, B, device)
    return {"metric": "pix3d_train_samples_per_sec", "value": round(sps, 3),
            "unit": "samples/s",
            "vs_baseline": round(sps / PIX3D_BASELINE_SAMPLES_PER_SEC, 3),
            **mfu_fields(times, flops, _peak(device))}, times


def _measure_eval(run_batch, B: int, device: torch.device):
    """(samples/s of the median window, window times): one warm-up batch, then
    ``WINDOWS`` windows of ``EVAL_BATCHES`` back-to-back batches."""
    run_batch()
    _sync(device)
    times = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for _ in range(EVAL_BATCHES):
            run_batch()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return B * EVAL_BATCHES / float(np.median(times)), times


def _eval_inputs(batch, device, names):
    return [torch.from_numpy(np.array(getattr(batch, n))).to(device) for n in names]


def bench_shapenet_eval(B: int, device: torch.device):
    """The per-batch work of ``harness.validate``: the eval forward and
    ``shapenet_eval_metrics`` (K1 four times a batch)."""
    from meshrcnn_tpu_torch.harness import shapenet_eval_metrics
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    model, config, batch = _shapenet_setup(B, device)
    eval_step = make_eval_step(model)
    uniform = uniform_from(torch.Generator(device=device).manual_seed(1))
    images, *targets = _eval_inputs(batch, device, ("images", "voxels", "gt_verts",
                                                    "gt_faces", "gt_faces_mask"))

    def run_batch():
        return shapenet_eval_metrics(eval_step(images), *targets, config.point_cloud_size,
                                     uniform, (0.1, 0.3), False, config.normal_k,
                                     config.distance_tile, config.face_normals)

    sps, times = _measure_eval(run_batch, B, device)
    return {"shapenet_eval_samples_per_sec": round(sps, 3),
            "shapenet_eval_s_per_batch": round(B / sps, 4)}, times


def bench_pix3d_eval(B: int, device: torch.device):
    """The per-batch work of ``harness.validate_pix3d``: the eval forward and
    ``pix3d_eval_metrics`` with ranked AP (K1 five times a batch)."""
    from meshrcnn_tpu_torch.harness import pix3d_eval_metrics
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    model, config, batch = _pix3d_setup(B, device)
    eval_step = make_eval_step(model)
    uniform = uniform_from(torch.Generator(device=device).manual_seed(1))
    images, *targets = _eval_inputs(batch, device, ("images", "boxes", "masks", "voxels",
                                                    "gt_verts", "gt_faces", "gt_faces_mask"))

    def run_batch():
        return pix3d_eval_metrics(eval_step(images), *targets, config.point_cloud_size,
                                  uniform, (0.1, 0.3), False, config.normal_k,
                                  config.distance_tile, config.face_normals, True)

    sps, times = _measure_eval(run_batch, B, device)
    return {"pix3d_eval_samples_per_sec": round(sps, 3),
            "pix3d_eval_s_per_batch": round(B / sps, 4)}, times


parser = argparse.ArgumentParser(description="train and eval throughput of the port")
parser.add_argument("--model", choices=["both", "ShapeNet", "Pix3D"], default="both",
                    help="'both' runs the two recipes, printing a cumulative JSON line "
                         "after each bench (ShapeNet train as the headline metric, the "
                         "rest under their own keys)")
parser.add_argument("--batch", type=int, default=None,
                    help="another batch size than the recipe's")
parser.add_argument("--budget", type=float, default=330.0,
                    help="wall-clock budget in seconds: a secondary bench that would end "
                         "after it is skipped and recorded as skipped")
parser.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on: 'cuda' (default) or 'cpu'")


def main(argv=None) -> dict:
    """Run the benches of ``argv``; returns the last record printed."""
    from meshrcnn_tpu_torch.utils.cli import device_of

    t_start = time.perf_counter()
    args = parser.parse_args(argv)
    try:
        device = device_of(args.device)
    except RuntimeError as e:
        metric = ("pix3d_train_samples_per_sec" if args.model == "Pix3D"
                  else "shapenet_train_samples_per_sec")
        record = {"metric": metric, "value": 0.0, "unit": "samples/s", "vs_baseline": 0.0,
                  "error": f"CUDA device unavailable ({type(e).__name__}: {e}); "
                           "bench skipped"}
        if args.model == "both":
            record["pix3d_train_samples_per_sec"] = 0.0
            record["pix3d_vs_baseline"] = 0.0
        print(json.dumps(record), flush=True)
        raise SystemExit(1)
    name, power = device_info(device)

    def elapsed():
        return time.perf_counter() - t_start

    def emit(record):
        record["bench_elapsed_s"] = round(elapsed(), 1)
        print(json.dumps(record), flush=True)
        return record

    def headline(bench, B):
        result, times = bench(B, device)
        result["window_s"] = [round(t, 3) for t in times]
        result.update(device=name, power_limit_w=power)
        return result

    if args.model == "ShapeNet":
        return emit(headline(bench_shapenet, args.batch or 3))
    if args.model == "Pix3D":
        return emit(headline(bench_pix3d, args.batch or 4))

    t0 = elapsed()
    result = headline(bench_shapenet, args.batch or 3)
    emit(result)
    # a secondary starts only if the longest bench so far (at least 60 s)
    # still ends inside the budget
    durations = [elapsed() - t0]

    def fits(key):
        est = max(max(durations), 60.0)
        if elapsed() + est < args.budget:
            return True
        result[f"{key}_skipped"] = (f"budget: elapsed {elapsed():.0f}s + est {est:.0f}s "
                                    f">= {args.budget}s")
        emit(result)
        return False

    if fits("pix3d"):
        t0 = elapsed()
        p3d, p3d_times = bench_pix3d(args.batch or 4, device)
        durations.append(elapsed() - t0)
        result["pix3d_train_samples_per_sec"] = p3d["value"]
        result["pix3d_vs_baseline"] = p3d["vs_baseline"]
        result["pix3d_window_s"] = [round(t, 3) for t in p3d_times]
        for k in ("flops_per_step", "achieved_tflops", "mfu_pct_vs_bf16_peak"):
            if k in p3d:
                result[f"pix3d_{k}"] = p3d[k]
        emit(result)
    for key, bench, B in (("shapenet_eval", bench_shapenet_eval, args.batch or 3),
                          ("pix3d_eval", bench_pix3d_eval, args.batch or 4)):
        if fits(key):
            t0 = elapsed()
            ev, _ = bench(B, device)
            durations.append(elapsed() - t0)
            result.update(ev)
            emit(result)
    if fits("normal_term"):
        with_n, _ = bench_shapenet(args.batch or 3, device, report_unweighted=True)
        result["shapenet_with_normal_term_sps"] = with_n["value"]
        emit(result)
    return result


if __name__ == "__main__":
    main()
