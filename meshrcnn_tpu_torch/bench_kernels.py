"""Time the port's kernels K1-K4 of two trees on one card, in turns.

    python3 meshrcnn_tpu_torch/bench_kernels.py --trees OTHER . . OTHER

Each tree is a directory that holds a ``meshrcnn_tpu_torch`` package (for
example a ``git archive`` of another commit). For each, in the order given, a
worker process imports that tree's package, builds its kernels and times, at
the main paths' shapes (clouds of 10,000 points, k = 10):

  * K1: ``ops.chamfer_cuda.nn_bidir`` on [3,10000,3], and on [1,10000,3], the
    launch behind K2;
  * K3: ``ops.chamfer.batched_knn`` of a [3,10000,3] cloud into itself, and K4:
    ``ops.chamfer.knn`` of one cloud. These are the functions the normal
    estimator calls, so a tree whose kernel writes candidates is timed with
    its merge.

Only functions that every tree of the port has are called. Each case gets two
times: ``*_ms``, the median of 5 windows of 50 calls between CUDA events,
which at B=1 is as much the host's launch path as the card's work; and
``*_device_ms``, the kernels' and memsets' own time a call, summed from a
``torch.profiler`` trace of 20 calls, which the host cannot move. The card's
name, power limit and SM clock (nvidia-smi) are printed with the times; the
last line is one JSON object of all runs. Fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def _time_ms(fn, reps: int = 50, windows: int = 5) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def _device_ms(fn, calls: int = 20) -> float:
    """Device time of everything a call of fn launches, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / calls / 1e3


def worker() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import meshrcnn_tpu_torch
    from meshrcnn_tpu_torch.ops import chamfer, chamfer_cuda
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    p = (torch.rand((3, 10000, 3), generator=g) * 2 - 1).to(dev)
    q = (torch.rand((3, 10000, 3), generator=g) * 2 - 1).to(dev)
    p1, q1 = p[:1].contiguous(), q[:1].contiguous()
    cases = {"k1_b3": lambda: chamfer_cuda.nn_bidir(p, q),
             "k1_b1": lambda: chamfer_cuda.nn_bidir(p1, q1),
             "k3_b3": lambda: chamfer.batched_knn(p, p, 10),
             "k4_b1": lambda: chamfer.knn(p1[0], p1[0], 10)}
    out = {"package": str(Path(meshrcnn_tpu_torch.__file__).resolve().parent)}
    for name, fn in cases.items():
        out[name + "_ms"] = _time_ms(fn)
        out[name + "_device_ms"] = _device_ms(fn)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="directories holding a meshrcnn_tpu_torch package")
    ap.add_argument("--worker", action="store_true", help="time the package on PYTHONPATH")
    args = ap.parse_args()
    if args.worker:
        return worker()
    if not args.trees:
        ap.error("--trees is required")
    runs = []
    for tree in args.trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker"],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"worker failed in {root}:\n{proc.stdout}\n{proc.stderr}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        if Path(run["package"]).parent != root:
            sys.exit(f"worker imported {run['package']}, not the package of {root}")
        run["tree"] = tree
        runs.append(run)
        print(f"[{tree}] {run['card']}: ms (device ms) K1 B=3 {run['k1_b3_ms']:.4f} "
              f"({run['k1_b3_device_ms']:.4f}), K1 B=1 (K2) {run['k1_b1_ms']:.4f} "
              f"({run['k1_b1_device_ms']:.4f}), K3 B=3 {run['k3_b3_ms']:.4f} "
              f"({run['k3_b3_device_ms']:.4f}), K4 B=1 {run['k4_b1_ms']:.4f} "
              f"({run['k4_b1_device_ms']:.4f})", flush=True)
    print(json.dumps({"runs": runs}))


if __name__ == "__main__":
    main()
