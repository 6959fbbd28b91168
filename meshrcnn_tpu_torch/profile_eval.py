"""Where the time of a full-width eval batch or train step goes, on a CUDA card.

    python3 -m meshrcnn_tpu_torch.profile_eval [--windows 4,8,4,8] [--batches 8]
                                               [--train] [--estimator] [--pix3d]

Builds the bench recipe (``harness.shapenet_bench_setup``, or with ``--train``
``harness.shapenet_train_setup``: ResNet-50 at 137x137, residual refinement,
capacities 8192/16384/32768, 10k-point clouds, B=3, random weights from seed
0; ``--estimator`` sets normal weight 0.1 and the kNN + PCA normals; with
``--pix3d`` the Pix3D eval recipe of ``harness.pix3d_bench_setup``, bfloat16
detection stack at 224x224, B=4, ranked AP, and with ``--pix3d --train`` its
train step, ``harness.pix3d_train_setup``), runs one forward, then prints
  1. ``validate`` (``validate_pix3d``, ``train_epoch``) over each window of batches in
     ``--windows``, in that order, in this one process: steady ms/batch and
     samples/s (the first batch of a window is booked apart), so windows of
     different length and repeats of one length can be compared;
  2. the untraced wall time of ``--batches`` whole batches, and a
     ``torch.profiler`` trace of them: host and device time of each
     ``record_function`` range of the forward, the losses or metrics and the
     train step (``losses/rpn``, ``losses/roi heads`` and ``losses/mask``
     nest inside ``forward/rpn`` and ``forward/roi heads``' calls), with
     ``--train`` the device time of the autograd nodes of the backward, and
     device time by kernel, with the kernels' share of the untraced wall, and
     with ``--pix3d`` the NMS sweeps a call.
Needs a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import time

import torch

from meshrcnn_tpu_torch.core.config import LossWeights
from meshrcnn_tpu_torch.harness import (pix3d_bench_setup, pix3d_eval_metrics,
                                        pix3d_train_setup, shapenet_bench_setup,
                                        shapenet_eval_metrics, shapenet_train_setup,
                                        train_epoch, validate, validate_pix3d)
from meshrcnn_tpu_torch.ops import nms
from meshrcnn_tpu_torch.ops.sampling import uniform_from
from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                    make_eval_step, make_train_step)
from meshrcnn_tpu_torch.utils.meters import gcn_metrics

_RANGES = ("forward/", "metrics/", "losses/", "train/")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", default="4,8,4,8",
                    help="batch counts of the validate windows, run in order")
    ap.add_argument("--batches", type=int, default=8, help="batches traced")
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--estimator", action="store_true",
                    help="normal weight 0.1 with kNN + PCA normals (face_normals=False)")
    ap.add_argument("--pix3d", action="store_true",
                    help="profile the Pix3D eval path (with --train, its train step)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    windows = [int(w) for w in args.windows.split(",")]
    n_batches = max(windows + [args.batches])
    overrides = {}
    if args.estimator:
        overrides = dict(loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.1,
                                                  edge=0.5), face_normals=False)
    uniform = uniform_from(torch.Generator(device=dev).manual_seed(0))
    if args.train:
        setup = pix3d_train_setup if args.pix3d else shapenet_train_setup
        model, config, batches = setup(n_batches, dev, **overrides)
        state = create_train_state(model, config)
        step = make_train_step(config, uniform)
        step(state, Batch.from_host(batches[0], dev))
    elif args.pix3d:
        model, config, batches = pix3d_bench_setup(n_batches, dev, **overrides)
        step = make_eval_step(model)
        step(torch.from_numpy(batches[0].images).to(dev))
    else:
        model, config, batches = shapenet_bench_setup(n_batches, dev, **overrides)
        step = make_eval_step(model)
        step(torch.from_numpy(batches[0].images).to(dev))
    torch.cuda.synchronize()
    B = batches[0].images.shape[0]

    for n in windows:
        if args.train:
            _, meters = train_epoch(0, step, state, batches[:n], gcn_metrics(), dev,
                                    print_freq=10 ** 9)
            steady, first = meters["batch_time"].history[0], meters["warmup_time"].history[0]
        elif args.pix3d:
            res = validate_pix3d(step, batches[:n], config, 10, uniform, device=dev,
                                 print_freq=10 ** 9)
            steady, first = res["batch_time"], res["warmup_time"]
        else:
            res = validate(step, batches[:n], config, 13, uniform, device=dev,
                           print_freq=10 ** 9)
            steady, first = res["batch_time"], res["warmup_time"]
        print(f"window of {n} batches: steady {steady * 1e3:.3f} ms/batch = "
              f"{B / steady:.3f} samples/s over {n - 1}; first batch {first * 1e3:.3f} ms")

    traced = batches[:args.batches]

    def run():
        for b in traced:
            if args.train:
                m = step(state, Batch.from_host(b, dev))
            elif args.pix3d:
                gt = [torch.from_numpy(getattr(b, k)).to(dev) for k in
                      ("boxes", "masks", "voxels", "gt_verts", "gt_faces", "gt_faces_mask")]
                m = pix3d_eval_metrics(step(torch.from_numpy(b.images).to(dev)), *gt,
                                       config.point_cloud_size, uniform,
                                       normal_k=config.normal_k, tile=config.distance_tile,
                                       face_normals=config.face_normals, ranked=True)
            else:
                gt = [torch.from_numpy(getattr(b, k)).to(dev)
                      for k in ("voxels", "gt_verts", "gt_faces", "gt_faces_mask")]
                m = shapenet_eval_metrics(step(torch.from_numpy(b.images).to(dev)), *gt,
                                          config.point_cloud_size, uniform,
                                          normal_k=config.normal_k, tile=config.distance_tile,
                                          face_normals=config.face_normals)
            _ = {k: v.cpu() for k, v in m.items()}
        torch.cuda.synchronize()

    calls, sweeps = nms.nms_mask.calls, nms.nms_mask.sweeps
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(traced)
    calls, sweeps = nms.nms_mask.calls - calls, nms.nms_mask.sweeps - sweeps
    if calls:
        print(f"NMS: {calls / len(traced):.1f} calls a batch, {sweeps / calls:.2f} sweeps a call")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    events = prof.key_averages()
    n = len(traced)
    print(f"ranges, ms/batch over {n} traced batches (host: wall inside the range; "
          f"device: kernels launched inside it):")
    for e in events:
        if e.key.startswith(_RANGES) and e.device_type == torch.autograd.DeviceType.CPU:
            print(f"  {e.key:22s} host {e.cpu_time_total / 1e3 / n:9.3f}  "
                  f"device {e.device_time_total / 1e3 / n:9.3f}")
    if args.train:
        # backward kernels run on autograd's thread, outside every range: the
        # device time of the autograd nodes that launched them is what names them
        nodes = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                 and "Backward" in e.key and not e.key.startswith("autograd::")]
        nodes.sort(key=lambda e: e.device_time_total, reverse=True)
        print(f"backward nodes, ms/batch: "
              f"{sum(e.device_time_total for e in nodes) / 1e3 / n:.3f} device in all")
        for e in nodes[:12]:
            print(f"  {e.key[:40]:40s} host {e.cpu_time_total / 1e3 / n:9.3f}  "
                  f"device {e.device_time_total / 1e3 / n:9.3f}  calls {e.count / n:7.1f}")
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(_RANGES)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    print(f"untraced wall {wall_ms:.3f} ms/batch; kernel time {busy_ms:.3f} ms/batch "
          f"(traced); device busy share {100 * busy_ms / wall_ms:.1f}%")
    print(f"  {'kernel':70s} {'ms/batch':>9s} {'calls/batch':>11s}")
    # the 25 longest, then the port's own kernels and any top-k or sort kernel,
    # whatever their rank (cubify sorts once a batch; the kNN merge must not)
    def selects(e):
        key = e.key.lower()
        return any(w in key for w in ("topk", "sort", "radix")) and "searchsorted" not in key

    own = ("nn_sweep_kernel", "nn_resolve_kernel", "knn_sweep_kernel", "knn_merge_kernel")
    rest = [e for e in kernels[25:] if selects(e) or any(w in e.key for w in own)]
    for e in kernels[:25] + rest:
        print(f"  {e.key[:70]:70s} {e.self_device_time_total / 1e3 / n:9.3f} "
              f"{e.count / n:11.1f}")
    print("top-k and sort kernels in the trace, calls/batch: "
          f"{ {e.key[:50]: e.count / n for e in kernels if selects(e)} or 'none'}")


if __name__ == "__main__":
    main()
