"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. build every kernel of the port from the sources in this checkout;
  2. hold each kernel against its plain PyTorch twin on the card, and time it;
  3. drive the port's main path (ShapeNet eval: forward + mesh metrics) at the
     full width of the bench recipe, and check that it went through the kernels;
  4. run a small model on the card and on the CPU with the same weights.
Prints the card's name and power limit, a JSON line with every kernel's
numbers, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without that line when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# FP32 CUDA-core and memory peaks by card (NVIDIA data sheets, dense rates).
_PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
          "H100": (67.0e12, 3.35e12)}
# FP32 operations a point pair costs: 3 sub, 3 mul, 2 add, 1 compare.
_OPS_PER_PAIR = 9


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return key, val
    return "H100", _PEAKS["H100"]


def _time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_build():
    from meshrcnn_tpu_torch.ops import chamfer_cuda
    t0 = time.perf_counter()
    path = chamfer_cuda.build()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    print(chamfer_cuda.build_log.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def _k1_agree(tag, got, want, min_agree=0.999, tol=1e-6):
    """K1 tolerances: argmin agreement >= 99.9%, and every distance within 1e-6
    of the plain twin's. Both compute the same difference form, so this also
    fails a kernel that keeps the right argmin but writes a wrong distance.
    Returns the max |d_kernel - d_plain|."""
    err = 0.0
    for side, (dk, ik), (dp, ip) in (("p", got[:2], want[:2]), ("q", got[2:], want[2:])):
        agree = (ik == ip).float().mean().item()
        diff = (dk - dp).abs().max().item()
        err = max(err, diff)
        print(f"[k1 {tag}] {side}: argmin agreement {agree:.6f}, max |d| diff {diff:.3e}")
        if agree < min_agree or not diff <= tol:
            _fail(f"K1 {tag} disagrees with its plain twin on side {side}")
    return err


def phase_kernels(card: str):
    import torch

    from meshrcnn_tpu_torch.ops import chamfer_cuda
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    # ragged N != M with exact ties: integer lattice points, so every distance
    # is exact and the lowest-index rule decides; held against numpy too
    p = torch.randint(0, 5, (2, 1000, 3), generator=g).float()
    q = torch.randint(0, 5, (2, 777, 3), generator=g).float()
    got = chamfer_cuda.nn_bidir(p.to(dev), q.to(dev))
    torch.cuda.synchronize()
    want = chamfer_cuda.nn_bidir_plain(p.to(dev), q.to(dev))
    _k1_agree("ragged+ties", [t.cpu() for t in got], [t.cpu() for t in want])
    full = ((p[:, :, None] - q[:, None]) ** 2).sum(-1).numpy()
    if not (np.array_equal(got[1].cpu().numpy(), full.argmin(2))
            and np.array_equal(got[3].cpu().numpy(), full.argmin(1))):
        _fail("K1 tie-break differs from the first-minimum argmin")

    # the eval path's shape: 3 samples of 10k points each way
    B, N, M = 3, 10000, 10000
    p = torch.rand((B, N, 3), generator=g).to(dev) * 2 - 1
    q = torch.rand((B, M, 3), generator=g).to(dev) * 2 - 1
    got = chamfer_cuda.nn_bidir(p, q)
    torch.cuda.synchronize()
    want = chamfer_cuda.nn_bidir_plain(p, q)
    err = _k1_agree("full", got, want)

    launches = chamfer_cuda.nn_bidir.launches
    ms = _time_ms(lambda: chamfer_cuda.nn_bidir(p, q))
    plain_ms = _time_ms(lambda: chamfer_cuda.nn_bidir_plain(p, q), reps=3, warmup=1)

    def library():
        d = torch.cdist(p, q).square()
        return d.min(2), d.min(1)
    library_ms = _time_ms(library, reps=5)
    chamfer_cuda.nn_bidir.launches = launches

    key, (flops, bw) = _peaks(card)
    ops = B * N * M * _OPS_PER_PAIR
    nbytes = (B * N + B * M) * 3 * 4 + (B * N + B * M) * 8
    t_ops, t_bytes = ops / flops * 1e3, nbytes / bw * 1e3
    rec = {"name": "chamfer_nn_bidir", "route": "cuda",
           "source": "meshrcnn_tpu_torch/csrc/chamfer_nn.cu",
           "replaces": "meshrcnn_tpu/ops/chamfer_pallas.py:338",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms}
    print(f"[k1 full] B={B} N={N} M={M}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+min {library_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}; {key} FP32 {flops / 1e12:.1f} TFLOP/s, "
          f"{_OPS_PER_PAIR} ops/pair)")
    return {"chamfer_nn_bidir": rec}


def phase_slice(kernels, batches: int = 8):
    """ShapeNet eval at full width: ResNet-50 on 137x137 images, 48^3 voxels,
    residual refinement, capacities 8192/16384/32768, 10k-point clouds, B=3."""
    import torch

    from meshrcnn_tpu_torch.harness import shapenet_bench_setup, validate
    from meshrcnn_tpu_torch.ops import chamfer_cuda
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    dev = torch.device("cuda")
    model, config, loader = shapenet_bench_setup(batches, dev)   # random weights, seed 0
    B = loader[0].images.shape[0]
    step = make_eval_step(model)
    out = step(torch.from_numpy(loader[0].images).to(dev))
    ovf = out.overflow
    print(f"[slice] cubify overflow verts {ovf.verts.tolist()} faces "
          f"{ovf.faces.tolist()} edges {ovf.edges.tolist()}; mesh verts "
          f"{out.mesh.num_verts().tolist()} faces {out.mesh.num_faces().tolist()} "
          f"edges {out.mesh.num_edges().tolist()}")

    chamfer_cuda.nn_bidir.launches = 0
    t0 = time.perf_counter()
    res = validate(step, loader, config, 13,
                   uniform_from(torch.Generator(device=dev).manual_seed(0)), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chamfer_cuda.nn_bidir.launches
    kernels["chamfer_nn_bidir"]["launches"] = launches

    scalars = {k: v for k, v in res.items() if k != "confusion"}
    print(f"[slice] metrics {json.dumps(scalars)}")
    steady = res["batch_time"]
    print(f"[slice] {batches} batches of {B} in {wall:.3f} s; steady "
          f"{steady * 1e3:.2f} ms/batch = {B / steady:.3f} samples/s (first batch "
          f"{res['warmup_time'] * 1e3:.2f} ms); K1 calls {launches}")
    if not all(np.isfinite(v) for v in scalars.values()):
        _fail("non-finite eval metric")
    if launches != 4 * batches:
        _fail(f"K1 ran {launches} times for {batches} batches, want {4 * batches}")


def phase_small_card_vs_cpu():
    """The tiny model (48x48 images, capacities 512/1024/2048) on the card and
    on the CPU with the same weights. Tolerance 1e-4 relative to each output's
    scale: f32 on both (TF32 off), only summation order differs."""
    import torch

    from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    torch.manual_seed(1)
    model = ShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                          voxel_out_channels=8, vert_capacity=512, face_capacity=1024,
                          edge_capacity=2048, num_refinement_stages=3)
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 48, 48, 3).astype(np.float32))
    cpu = make_eval_step(model)(images)
    gpu = make_eval_step(model.to("cuda"))(images.to("cuda"))
    for name in ("logits", "voxels"):
        a, b = getattr(gpu, name).cpu(), getattr(cpu, name)
        err = ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
        print(f"[small] {name} card vs cpu: relative error {err:.3e}")
        if not err < 1e-4:
            _fail(f"{name} differs between the card and the CPU")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    # the port's f32 reference numerics: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_build()
    kernels = phase_kernels(card)
    phase_slice(kernels)
    phase_small_card_vs_cpu()

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
