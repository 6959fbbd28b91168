"""Quickest proof that the PyTorch port runs on an NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which fails the run:
  1. build every kernel of the port from the sources in this checkout, one
     nvcc per source, all at once;
  2. hold each kernel against its plain PyTorch twin on the card, and time it
     (K1 and K3; K2 and K4 are B=1 launches of them, held to the batched
     launch's row): K1 bit-equal in distances and indices on ragged sizes
     around its 128- and 256-point tiles, on clouds full of ties, over five runs,
     with NaN coordinates and at the Pix3D eval's and train step's [4, 10000, 3]
     (stage chamfers, F1 pair) and [12, 10000, 3] (ranked slots); K3 equal in
     values and indices for every subtile, for k from 1 to the largest, with
     fewer runs than k and over many spans; and greedy NMS (plain PyTorch, no
     kernel) equal in keep sets and order to a sequential numpy reference,
     with tied scores, invalid rows and class offsets;
  3. drive the port's paths at the full width of their bench recipes, each
     with the launch counts set to 0 just before it and read just after, and
     check that it went through its kernels: ShapeNet eval (K1 x 4 a batch),
     the train step (K1 x 3 a step, no K3), Pix3D eval with ranked AP (K1 x 5
     a batch; bfloat16 detection stack, held against its float32 FPN), the
     Pix3D train step (K1 x 3 a step, no K3), the reference kNN + PCA normal
     estimator in training and eval (K3 x 6 a step and a batch), the
     single-sample chamfer distance and kNN (K2, K4), and the user's entry
     points: ``python -m meshrcnn_tpu_torch.train`` for 4 steps of each model
     through the data layer, its checkpoint reloaded bit-equal and resumed for
     a step, then ``eval_model`` on that checkpoint (K1 x 3 a step, x 4 / x 5
     a ShapeNet / Pix3D eval batch); and the eval metrics of both models equal
     in every bit over two runs; and data parallelism (``phase_dp``): two gloo
     ranks spawned on the card train both models 3 steps at the bench recipes
     (states equal in every bit across ranks, K1 x 3 a rank a step, the first
     step against its one-process emulation, the tiny Pix3D step in float64
     at 1e-9), evaluate both (gathered outputs against the one-process eval,
     ``validate`` with K1 on rank 0), the train CLI on NCCL as rank 0 of a
     world of one (``--multihost``), and ms/step of one and two ranks with the
     all-reduce's share; then the rest of the user's surface: the reference-
     style API (``models/api.py``: ShapeNetAPI and Pix3DAPI at the bench
     recipes, the eval dict, the train-mode loss dict with the model left
     unchanged in every bit and K1 x 3, two ``step()``s with K1 x 3 each,
     ``load()`` of the CLI's checkpoints equal in every bit to
     ``eval_model``'s forward, tiny APIs on the card against the CPU), the
     demo below its image decode (one ``.npy`` and four ``.obj`` files a
     valid object, each OBJ equal to the forward's mesh), ``bench.main`` (every
     record key, 5 windows each, K1 exactly 3 x 20 x 6 a train bench and
     4 x 26 / 5 x 26 an eval bench), ``train_backbone`` of both models (the
     backbone checkpoint loaded whole, then a train CLI step from it), and
     the tools (``download_dataset`` rendering with the port's cubify on the
     card, ``point_cloud_f1`` through K2 equal in every bit to the CPU's,
     ``time_this``);
  4. run small models on the card and on the CPU with the same weights: the
     ShapeNet and Pix3D eval forwards, one ShapeNet and one Pix3D train step,
     and the backward of each module and loss the steps differentiate through
     (gradients within 1e-4 of each tensor's scale in float32, 1e-9 in float64),
     the tiny Pix3D step with its mesh branch in float64 among them.
Prints the card's name and power limit, a JSON line with every kernel's
numbers, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without that line when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# FP32 CUDA-core and memory peaks by card (NVIDIA data sheets, dense rates).
_PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
          "H100": (67.0e12, 3.35e12)}
# FP32 operations a point pair costs: 3 sub, 3 mul, 2 add, 1 compare.
_OPS_PER_PAIR = 9
KERNEL_SOURCES = ("chamfer_nn", "knn_topk")
_CHAMFER_SRC = "meshrcnn_tpu_torch/csrc/chamfer_nn.cu"
_KNN_SRC = "meshrcnn_tpu_torch/csrc/knn_topk.cu"
_PALLAS = "meshrcnn_tpu/ops/chamfer_pallas.py"


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
    from meshrcnn_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    paths = cuda_build.build(KERNEL_SOURCES)
    print(f"[build] {', '.join(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in KERNEL_SOURCES:
        print(cuda_build.build_log.get(name, "").strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def _counters():
    from meshrcnn_tpu_torch.ops import chamfer_cuda, knn_cuda
    return {"chamfer_nn_bidir": chamfer_cuda.nn_bidir,
            "knn_topk_batched": knn_cuda.knn_topk_batched,
            "chamfer_sums_fused": chamfer_cuda.chamfer_sums_fused,
            "knn_topk": knn_cuda.knn_topk}


def _reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _record(kernels, name, source, replaces, err, ms, plain_ms, ops, nbytes,
            library_ms, card):
    key, (flops, bw) = _peaks(card)
    t_ops, t_bytes = ops / flops * 1e3, nbytes / bw * 1e3
    kernels[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": library_ms}
    print(f"[{name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, bound {kernels[name]['bound_ms']:.4f} ms "
          f"({kernels[name]['bound_by']}; {key} FP32 {flops / 1e12:.1f} TFLOP/s, "
          f"{bw / 1e12:.2f} TB/s, {_OPS_PER_PAIR} ops/pair)")


def _k1_equal(tag, got, want):
    """K1's gate: distances bit-equal to the plain twin's and indices equal
    (both compute the same difference form with the same roundings, and both
    take the first minimum). Returns the max |d_kernel - d_plain|, which is 0."""
    import torch
    names = ("d_p", "i_p", "d_q", "i_q")
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            _fail(f"K1 {tag}: {name} differs from its plain twin")
    return max((got[k] - want[k]).nan_to_num(posinf=0.0).abs().max().item() for k in (0, 2))


def _k3_library(p, q, s, k):
    """One PyTorch yardstick for K3: cdist squared, padded to runs of s, min,
    then the top-k merge."""
    import torch
    d = torch.cdist(p, q).square()
    C = -(-q.shape[1] // s)
    d = torch.nn.functional.pad(d, (0, C * s - q.shape[1]), value=float("inf"))
    vals, arg = d.view(p.shape[0], p.shape[1], C, s).min(-1)
    top, pos = torch.topk(vals, min(k, C), dim=-1, largest=False)
    return top, torch.gather(arg, -1, pos)


def _k1_library(p, q):
    import torch
    d = torch.cdist(p, q).square()
    return d.min(2), d.min(1)


def _sm_clock_mhz(fn, launches: int = 4000) -> float:
    """The SM clock nvidia-smi reads while ``launches`` calls of fn are in flight."""
    import torch
    for _ in range(launches):
        fn()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    torch.cuda.synchronize()
    return float(smi.stdout.strip().splitlines()[0])


def _instruction_floor(kernels, name, pairs, per_pair, clock_mhz):
    """The floor of this arithmetic without FMAs, beside the bound: lane
    instructions over SMs x 128 lanes x the SM clock read in this run."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = pairs * per_pair / (sms * 128 * clock_mhz * 1e6) * 1e3
    kernels[name].update(instruction_floor_ms=floor, sm_clock_mhz=clock_mhz)
    print(f"[{name}] instruction floor {floor:.4f} ms ({per_pair} instructions a pair, {sms} SMs "
          f"x 128 lanes at {clock_mhz:.0f} MHz), {floor / kernels[name]['ms']:.1%} of the "
          "kernel's time")


def _k1_cases(dev):
    """K1 on shapes that stress the tile grid, the key reductions and the rescan."""
    import torch

    from meshrcnn_tpu_torch.ops import chamfer_cuda
    g = torch.Generator(device="cpu").manual_seed(5)

    def check(tag, p, q, numpy_too=True):
        p, q = p.to(dev).contiguous(), q.to(dev).contiguous()
        got = chamfer_cuda.nn_bidir(p, q)
        torch.cuda.synchronize()
        _k1_equal(tag, got, chamfer_cuda.nn_bidir_plain(p, q))
        if numpy_too:   # lattice clouds: every distance exact, so numpy's first minimum decides
            full = ((p[:, :, None] - q[:, None]) ** 2).sum(-1).cpu().numpy()
            if not (np.array_equal(got[1].cpu().numpy(), full.argmin(2))
                    and np.array_equal(got[3].cpu().numpy(), full.argmin(1))):
                _fail(f"K1 {tag}: tie-break differs from the first-minimum argmin")
        return got

    # ragged N != M with exact ties: integer lattice points
    check("ragged+ties", torch.randint(0, 5, (2, 1000, 3), generator=g).float(),
          torch.randint(0, 5, (2, 777, 3), generator=g).float())
    sizes = (1, 127, 129, 255, 256, 257, 1025)
    for N, M in zip(sizes + sizes, sizes + sizes[1:] + sizes[:1]):
        check(f"N={N} M={M}", torch.randint(0, 4, (2, N, 3), generator=g).float(),
              torch.randint(0, 4, (2, M, 3), generator=g).float())
    # p equal to q, with duplicates: every minimum is 0 at the first duplicate
    same = torch.randint(0, 6, (2, 1300, 3), generator=g).float()
    got = check("p == q", same, same.clone())
    if not (got[0].max().item() == 0.0 and got[2].max().item() == 0.0):
        _fail("K1 p == q: a minimum is not 0")
    # one repeated point: every entry ties, index 0 everywhere
    got = check("one point", torch.full((1, 700, 3), 0.25), torch.full((1, 900, 3), 0.25))
    if int(got[1].max()) != 0 or int(got[3].max()) != 0:
        _fail("K1 one repeated point: an index is not 0")
    # B=1 and B=3 of the same clouds, row for row
    p3 = torch.rand((3, 1500, 3), generator=g).to(dev)
    q3 = torch.rand((3, 1100, 3), generator=g).to(dev)
    batched = check("B=3 random", p3, q3, numpy_too=False)
    for b in range(3):
        one = chamfer_cuda.nn_bidir(p3[b:b + 1].contiguous(), q3[b:b + 1].contiguous())
        if not all(torch.equal(o[0], w[b]) for o, w in zip(one, batched)):
            _fail(f"K1 B=1 launch of sample {b} differs from its row of the B=3 launch")
    # a NaN coordinate: that point gets (+inf, 0) and is nobody's neighbour
    pn, qn = p3.clone(), q3.clone()
    pn[0, 3, 1] = float("nan")
    qn[0, 0, 2] = qn[0, 300, 0] = qn[2, 1099, 1] = float("nan")
    got = check("NaN", pn, qn, numpy_too=False)
    if not (got[0][0, 3].item() == float("inf") and got[1][0, 3].item() == 0
            and got[2][0, 300].item() == float("inf")
            and not bool(((got[1][0] == 300) & (got[0][0] < float("inf"))).any())):
        _fail("K1 NaN: a NaN point has a neighbour or is one")
    # the Pix3D shapes: B = 4 clouds of 10k points (the eval's and the train
    # step's stage chamfers, the F1 pair) and B * D = 12 (ranked per-slot F1)
    for n in (4, 12):
        check(f"B={n} 10k", torch.rand((n, 10000, 3), generator=g) * 2 - 1,
              torch.rand((n, 10000, 3), generator=g) * 2 - 1, numpy_too=False)
    print(f"[k1 cases] ragged+ties, {len(sizes) * 2} mixed sizes of {sizes}, p == q, one "
          "repeated point, B=1 rows of B=3, NaN, [4,10000,3], [12,10000,3]: bit-equal to "
          "the twin; lattice cases equal to numpy's first minimum")


def _k3_cases(dev):
    """K3 against its twin where ties decide, and at the edges of its contract."""
    import torch

    from meshrcnn_tpu_torch.ops import knn_cuda
    g = torch.Generator(device="cpu").manual_seed(6)
    p = torch.randint(0, 5, (2, 1000, 3), generator=g).float().to(dev)
    q = torch.randint(0, 5, (2, 777, 3), generator=g).float().to(dev)

    def check(tag, p, q, s, k):
        got = knn_cuda.knn_topk_batched(p, q, s, k)
        torch.cuda.synchronize()
        want = knn_cuda.knn_topk_plain(p, q, s, k)
        if not (got[0].shape == want[0].shape and torch.equal(got[0], want[0])
                and got[1].dtype == torch.int32 and torch.equal(got[1], want[1])):
            _fail(f"K3 {tag} s={s} k={k}: values or indices differ from its plain twin")

    for s in (8, 16, 32, 64):
        for k in (1, 10, 16):
            check("ragged+ties", p, q, s, k)
    check("fewer runs than k", p, q[:, :100].contiguous(), 64, 10)     # 2 runs
    check("one run", p, q[:, :5].contiguous(), 8, 10)
    check("largest k", p, q, 8, knn_cuda.MAX_K)
    big = torch.randint(0, 12, (1, 3000, 3), generator=g).float().to(dev)
    check("many spans", big, big, 16, 10)
    check("many spans, largest k", big, big, 8, knn_cuda.MAX_K)
    print("[k3 cases] lattice s=8,16,32,64 x k=1,10,16, fewer runs than k, one run, "
          f"k={knn_cuda.MAX_K}, many spans: values and indices equal to the twin")


def _iou_f32(a, b):
    """numpy float32 IoU in the port's operation order (``ops/boxes.box_iou``):
    every step is one correctly rounded float32 operation on both sides."""
    def area(x):
        return (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, np.float32(1e-9))


def _greedy_nms(bx, sc, vd, thr, max_keep):
    """Sequential greedy NMS: take the best remaining valid box (lower index on
    equal scores), drop what it overlaps beyond thr, repeat."""
    alive = vd.copy()
    s = np.where(vd, sc, -np.inf)
    iou = _iou_f32(bx, bx)
    order = []
    while alive.any() and len(order) < max_keep:
        i = int(np.argmax(np.where(alive, s, -np.inf)))
        order.append(i)
        alive &= ~(iou[i] > np.float32(thr))
        alive[i] = False
    return order + [-1] * (max_keep - len(order))


def phase_nms():
    """Greedy NMS on the card against ``_greedy_nms``: 20 sets of 1000
    clustered boxes (the RPN's batch of 4 images x 5 levels) with scores on a
    coarse grid and invalid rows, and 4 sets of 576 class-labelled boxes (the
    box head's prefilter) through the class offset. Keep sets and order equal."""
    import torch

    from meshrcnn_tpu_torch.ops import nms
    rng = np.random.RandomState(7)

    def sets(S, N, thr, max_keep, labelled):
        c = rng.uniform(30, 200, (S, 40, 2))[np.arange(S)[:, None], rng.randint(0, 40, (S, N))]
        c = c + rng.randn(S, N, 2) * 6
        wh = rng.uniform(8, 60, (S, N, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        sc = (rng.randint(0, 50, (S, N)) / 50.0).astype(np.float32)
        vd = rng.rand(S, N) > 0.1
        labels = rng.randint(1, 10, (S, N)).astype(np.int64)
        dev = [torch.from_numpy(x).cuda() for x in (bx, sc, vd, labels)]
        sweeps = nms.nms_mask.sweeps
        if labelled:
            order, keep = nms.batched_nms_mask(dev[0], dev[1], dev[3], dev[2], thr, max_keep)
            top = np.where(vd[..., None], bx, 0).reshape(S, -1).max(1)[:, None, None]
            bx = bx + labels[..., None].astype(np.float32) * (top + np.float32(1))
        else:
            order, keep = nms.nms_mask(dev[0], dev[1], dev[2], thr, max_keep)
        order = order.cpu().numpy()
        for s in range(S):
            want = _greedy_nms(bx[s], sc[s], vd[s], thr, max_keep)
            if order[s].tolist() != want or not np.array_equal(keep[s].cpu().numpy(),
                                                               np.asarray(want) >= 0):
                _fail(f"NMS set {s} of [{S},{N}] differs from sequential greedy")
        return int(keep.sum()), nms.nms_mask.sweeps - sweeps

    kept, sweeps = sets(20, 1000, 0.7, 512, False)
    kept_c, sweeps_c = sets(4, 576, 0.5, 3, True)
    print(f"[nms] 20 x 1000 boxes at IoU 0.7 ({kept} kept, {sweeps} sweeps) and 4 x 576 "
          f"class-offset boxes at 0.5 ({kept_c} kept, {sweeps_c} sweeps): equal to "
          "sequential greedy in keep sets and order")


def phase_kernels(card: str):
    import torch

    from meshrcnn_tpu_torch.ops import chamfer_cuda, knn_cuda
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    kernels = {}
    _k1_cases(dev)
    _k3_cases(dev)

    # the main paths' shapes: 3 samples of 10k points
    B, N, M, S, K = 3, 10000, 10000, 64, 10
    p = torch.rand((B, N, 3), generator=g).to(dev) * 2 - 1
    q = torch.rand((B, M, 3), generator=g).to(dev) * 2 - 1
    got = chamfer_cuda.nn_bidir(p, q)
    torch.cuda.synchronize()
    err = _k1_equal("full", got, chamfer_cuda.nn_bidir_plain(p, q))
    for _ in range(4):   # the atomics are order-independent: five runs, identical bits
        again = chamfer_cuda.nn_bidir(p, q)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            _fail("K1 gives different bits on the same input")
    print("[k1 full] bit-equal to the twin; five runs identical")
    ms = _time_ms(lambda: chamfer_cuda.nn_bidir(p, q))
    plain_ms = _time_ms(lambda: chamfer_cuda.nn_bidir_plain(p, q), reps=3, warmup=1)
    library_ms = _time_ms(lambda: _k1_library(p, q), reps=5)
    _record(kernels, "chamfer_nn_bidir", _CHAMFER_SRC, f"{_PALLAS}:338", err, ms, plain_ms,
            B * N * M * _OPS_PER_PAIR, (B * N + B * M) * (3 * 4 + 8), library_ms, card)
    clock = _sm_clock_mhz(lambda: chamfer_cuda.nn_bidir(p, q))
    _instruction_floor(kernels, "chamfer_nn_bidir", B * N * M, 10, clock)

    # K3 self-kNN, as the normal estimator calls it
    dists, idx = knn_cuda.knn_topk_batched(p, p, S, K)
    torch.cuda.synchronize()
    pd, pi = knn_cuda.knn_topk_plain(p, p, S, K)
    k3_err = (dists - pd).abs().max().item()
    print(f"[k3 full] B={B} N=M={N} s={S} k={K}: max |dist| diff {k3_err:.3e}, indices "
          f"equal {torch.equal(idx, pi)}")
    if not (k3_err == 0.0 and torch.equal(idx, pi)):
        _fail("K3 disagrees with its plain twin at full width")
    ms = _time_ms(lambda: knn_cuda.knn_topk_batched(p, p, S, K))
    plain_ms = _time_ms(lambda: knn_cuda.knn_topk_plain(p, p, S, K), reps=3, warmup=1)
    library_ms = _time_ms(lambda: _k3_library(p, p, S, K), reps=5)
    _record(kernels, "knn_topk_batched", _KNN_SRC, f"{_PALLAS}:553", k3_err, ms,
            plain_ms, B * N * N * _OPS_PER_PAIR, 2 * B * N * 3 * 4 + B * N * K * 8,
            library_ms, card)
    _instruction_floor(kernels, "knn_topk_batched", B * N * N, 11, clock)

    # K2 and K4: each B=1 launch equals the same row of the batched launch
    sums = chamfer_cuda.chamfer_sums_batched(p, q)
    for b in range(B):
        one = chamfer_cuda.chamfer_sums_fused(p[b], q[b])
        d1, i1 = knn_cuda.knn_topk(p[b], p[b], S, K)
        torch.cuda.synchronize()
        # the kernel's outputs, the indices, are equal; the sums over them are
        # PyTorch reductions, whose order depends on the batch shape: 1e-6 relative
        if not (torch.equal(one[1], sums[1][b]) and torch.equal(one[3], sums[3][b])
                and torch.allclose(one[0], sums[0][b], rtol=1e-6, atol=0.0)
                and torch.allclose(one[2], sums[2][b], rtol=1e-6, atol=0.0)):
            _fail(f"K2 sample {b} differs from the batched K1 launch")
        if not (torch.equal(d1, dists[b]) and torch.equal(i1, idx[b])):
            _fail(f"K4 sample {b} differs from the batched K3 launch")
    print("[k2, k4] every B=1 launch equals its row of the batched launch")
    p1, q1 = p[0].contiguous(), q[0].contiguous()

    def plain_sums(a, b):
        _, i_a, _, i_b = chamfer_cuda.nn_bidir_plain(a[None], b[None])
        return chamfer_cuda.exact_sums_batched(a[None], b[None], i_a, i_b)

    got, want = chamfer_cuda.chamfer_sums_fused(p1, q1), plain_sums(p1, q1)
    k2_err = max(abs(got[0] - want[0][0]).item(), abs(got[2] - want[1][0]).item())
    # K2's kernel time is the B=1 launch; the function around it adds the sums,
    # a dozen small PyTorch ops whose launches the host bounds
    ms = _time_ms(lambda: chamfer_cuda.nn_bidir(p1[None], q1[None]))
    function_ms = _time_ms(lambda: chamfer_cuda.chamfer_sums_fused(p1, q1))
    plain_ms = _time_ms(lambda: chamfer_cuda.nn_bidir_plain(p1[None], q1[None]), reps=3,
                        warmup=1)
    library_ms = _time_ms(lambda: _k1_library(p1[None], q1[None]), reps=5)
    _record(kernels, "chamfer_sums_fused", _CHAMFER_SRC, f"{_PALLAS}:200", k2_err, ms,
            plain_ms, N * M * _OPS_PER_PAIR, (N + M) * (3 * 4 + 8), library_ms, card)
    kernels["chamfer_sums_fused"]["function_ms"] = function_ms
    print(f"[chamfer_sums_fused] the whole function, kernel and sums: {function_ms:.4f} ms")
    _instruction_floor(kernels, "chamfer_sums_fused", N * M, 10, clock)
    k4_err = (knn_cuda.knn_topk(p1, p1, S, K)[0]
              - knn_cuda.knn_topk_plain(p1[None], p1[None], S, K)[0][0]).abs().max().item()
    ms = _time_ms(lambda: knn_cuda.knn_topk(p1, p1, S, K))
    plain_ms = _time_ms(lambda: knn_cuda.knn_topk_plain(p1[None], p1[None], S, K), reps=3,
                        warmup=1)
    library_ms = _time_ms(lambda: _k3_library(p1[None], p1[None], S, K), reps=5)
    _record(kernels, "knn_topk", _KNN_SRC, f"{_PALLAS}:491", k4_err, ms, plain_ms,
            N * N * _OPS_PER_PAIR, 2 * N * 3 * 4 + N * K * 8, library_ms, card)
    _instruction_floor(kernels, "knn_topk", N * N, 11, clock)
    if not (k2_err <= 1e-5 * max(abs(want[0][0].item()), 1.0) and k4_err == 0.0):
        _fail(f"K2 / K4 disagree with their twins: {k2_err}, {k4_err}")
    return kernels


def phase_slice(batches: int = 8):
    """ShapeNet eval at full width: ResNet-50 on 137x137 images, 48^3 voxels,
    residual refinement, capacities 8192/16384/32768, 10k-point clouds, B=3.
    Face normals (the default): K1 four times a batch, K3 never."""
    import torch

    from meshrcnn_tpu_torch.harness import shapenet_bench_setup, validate
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

    _reset_counts()
    t0 = time.perf_counter()
    res = validate(step, loader, config, 13,
                   uniform_from(torch.Generator(device=dev).manual_seed(0)), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()

    scalars = {k: v for k, v in res.items() if k != "confusion"}
    print(f"[slice] metrics {json.dumps(scalars)}")
    steady = res["batch_time"]
    print(f"[slice] {batches} batches of {B} in {wall:.3f} s; steady "
          f"{steady * 1e3:.2f} ms/batch = {B / steady:.3f} samples/s (first batch "
          f"{res['warmup_time'] * 1e3:.2f} ms); launches {counts}")
    if not all(np.isfinite(v) for v in scalars.values()):
        _fail("non-finite eval metric")
    want = {"chamfer_nn_bidir": 4 * batches, "knn_topk_batched": 0,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"eval launched {counts}, want {want}")


def _bf16_fpn_check(fpn, images, bound: float = 5e-2):
    """The bfloat16 FPN against a float32 copy of itself on the same images:
    max |bf16 - f32| / max |f32| of P2..P5, gated at ``bound``. Each conv
    rounds its output to bfloat16 (4e-3 relative); on the CPU at 64x64 and
    96x96 the pyramid ends ~1e-2 from float32 (tests/test_torch_pix3d_modules.py)."""
    import copy

    import torch

    from meshrcnn_tpu_torch.models.fpn import ResNetFPN
    f32 = ResNetFPN(dtype=torch.float32).to(images.device).eval()
    f32.load_state_dict(copy.deepcopy(fpn.state_dict()))
    with torch.no_grad():
        low, full = fpn(images), f32(images)
    errs = [((a.float() - b).abs().max() / b.abs().max()).item() for a, b in zip(low[:4], full)]
    print(f"[pix3d bf16] FPN P2..P5 bfloat16 vs float32, max error / max |f32|: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (bound {bound}); P2 max |f32| "
          f"{full[0].abs().max().item():.4g}")
    if not all(e < bound for e in errs):
        _fail("the bfloat16 FPN is further from float32 than its bound")


def phase_pix3d_eval(kernels, batches: int = 4):
    """Pix3D eval at full width (harness.pix3d_bench_setup): ResNet-50 FPN with
    a bfloat16 detection stack at 224x224, RPN 1000 / 512, 3 detections an
    image, 24^3 voxels, capacities 4096/8192/16384, 10k-point clouds, B=4,
    ranked AP. K1 five times a batch: three stage chamfers and the F1 pair at
    [4, 10000, 3], the mesh F1 of all B * D slots at [12, 10000, 3]; both
    shapes are held bit-equal to the twin in ``_k1_cases``."""
    import torch

    from meshrcnn_tpu_torch.harness import pix3d_bench_setup, validate_pix3d
    from meshrcnn_tpu_torch.models.rpn import generate_anchors, select_proposals
    from meshrcnn_tpu_torch.ops import nms
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    dev = torch.device("cuda")
    model, config, loader = pix3d_bench_setup(batches, dev)       # random weights, seed 0
    B = loader[0].images.shape[0]
    step = make_eval_step(model)
    images = torch.from_numpy(loader[0].images).to(dev)
    sweeps = nms.nms_mask.sweeps
    out = step(images)
    sweeps = nms.nms_mask.sweeps - sweeps
    mrcnn = model.backbone
    with torch.no_grad():                      # the RPN's NMS alone, on the same batch
        feats = mrcnn.backbone(images)
        rpn_sweeps = nms.nms_mask.sweeps
        select_proposals(*mrcnn.rpn_head(feats),
                         generate_anchors([f.shape[2:] for f in feats], (224, 224), dev),
                         (224, 224), mrcnn.rpn_pre_nms_top_n, mrcnn.rpn_post_nms_top_n)
        rpn_sweeps = nms.nms_mask.sweeps - rpn_sweeps
    print(f"[pix3d] NMS sweeps in one forward: RPN {rpn_sweeps} (20 sets of 1000), box "
          f"head {sweeps - rpn_sweeps} (4 sets of 576)")
    det, ovf = out.detections, out.overflow
    print(f"[pix3d] first batch: valid detections {det.valid.sum(1).tolist()}, labels "
          f"{det.labels.tolist()}, scores {[[round(s, 4) for s in r] for r in det.scores.tolist()]}; "
          f"cubify overflow verts {ovf.verts.tolist()} faces {ovf.faces.tolist()} edges "
          f"{ovf.edges.tolist()}; mesh verts {out.mesh.num_verts().tolist()}")
    _bf16_fpn_check(model.backbone.backbone, images)

    per_batch = []

    def checked(x):
        o = step(x)
        per_batch.append(o.detections.valid.sum(1))
        return o

    calls, sweeps = nms.nms_mask.calls, nms.nms_mask.sweeps
    _reset_counts()
    t0 = time.perf_counter()
    res = validate_pix3d(checked, loader, config, 10,
                         uniform_from(torch.Generator(device=dev).manual_seed(0)), device=dev,
                         print_freq=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    calls, sweeps = nms.nms_mask.calls - calls, nms.nms_mask.sweeps - sweeps

    scalars = {k: v for k, v in res.items() if k != "confusion"}
    print(f"[pix3d] metrics {json.dumps(scalars)}")
    steady = res["batch_time"]
    print(f"[pix3d] {batches} batches of {B} in {wall:.3f} s; steady {steady * 1e3:.2f} "
          f"ms/batch = {B / steady:.3f} samples/s (first batch {res['warmup_time'] * 1e3:.2f} "
          f"ms); NMS {calls} calls, {sweeps / max(calls, 1):.2f} sweeps a call; launches {counts}")
    if not all(np.isfinite(v) for v in scalars.values()):
        _fail("non-finite Pix3D eval metric")
    # AP_mesh is the reference's AUC over percent precision and recall: [0, 1e4]
    unit = [k for k in scalars if k.startswith(("AP_box", "AP_mask", "AP50_", "AP_mesh_ranked",
                                                "F1@"))]
    if not (all(0.0 <= scalars[k] <= 1.0 for k in unit) and 0.0 <= scalars["AP_mesh"] <= 1e4):
        _fail(f"a Pix3D AP or F1 is out of range: {scalars}")
    if not all(bool((v > 0).all()) for v in per_batch):
        _fail(f"an image has no valid detection: {[v.tolist() for v in per_batch]}")
    want = {"chamfer_nn_bidir": 5 * batches, "knn_topk_batched": 0,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"Pix3D eval launched {counts}, want {want}")
    kernels["chamfer_nn_bidir"]["launches"] += counts["chamfer_nn_bidir"]


def _train(tag, model, config, loader, dev, metrics=()):
    """``train_epoch`` over ``loader`` with every step's metrics checked:
    finite, grads_finite 1, and each name of ``metrics`` present. Returns the
    launch counts."""
    import torch

    from meshrcnn_tpu_torch.harness import train_epoch
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import create_train_state, make_train_step
    from meshrcnn_tpu_torch.utils.meters import gcn_metrics

    step = make_train_step(config, uniform_from(torch.Generator(device=dev).manual_seed(1)))
    seen = []

    def checked(state, batch):
        m = step(state, batch)
        seen.append(dict(zip(m, torch.stack(list(m.values())).tolist())))
        return m

    _reset_counts()
    t0 = time.perf_counter()
    state, meters = train_epoch(0, checked, create_train_state(model, config), loader,
                                gcn_metrics(), dev, print_freq=10 ** 9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    B, steps = loader[0].images.shape[0], len(loader)
    steady = meters["batch_time"].history[0]
    print(f"[{tag}] {steps} steps of {B} in {wall:.3f} s; steady {steady * 1e3:.2f} "
          f"ms/step = {B / steady:.3f} samples/s over {steps - 1} (first step "
          f"{meters['warmup_time'].history[0] * 1e3:.2f} ms); launches {counts}")
    for i, m in enumerate(seen):
        print(f"[{tag}] step {i} {json.dumps(m)}")
        if not all(np.isfinite(v) for v in m.values()) or m["grads_finite"] != 1.0:
            _fail(f"{tag}: step {i} has a non-finite metric or gradient")
        if not set(metrics) <= set(m):
            _fail(f"{tag}: step {i} lacks metrics {sorted(set(metrics) - set(m))}")
    if state.step != steps:
        _fail(f"{tag}: {state.step} steps taken, want {steps}")
    return counts


def phase_train(kernels, steps: int = 5):
    """The bench recipe's train step at full width (harness.shapenet_train_setup):
    Adam lr 1e-4, frozen backbone, weights voxel 1 / chamfer 1 / normal 0 /
    edge 0.5. K1 three times a step, K3 never (the normal term is elided)."""
    import torch

    from meshrcnn_tpu_torch.harness import shapenet_train_setup
    dev = torch.device("cuda")
    model, config, loader = shapenet_train_setup(steps, dev)
    counts = _train("train", model, config, loader, dev)
    want = {"chamfer_nn_bidir": 3 * steps, "knn_topk_batched": 0,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"train launched {counts}, want {want}")
    kernels["chamfer_nn_bidir"]["launches"] = counts["chamfer_nn_bidir"]


PIX3D_TRAIN_METRICS = ("voxel_loss", "loss_objectness", "loss_rpn_box_reg", "loss_classifier",
                       "loss_box_reg", "loss_mask", "backbone_loss", "chamfer_loss",
                       "normal_loss", "edge_loss", "overflow", "loss", "grads_finite")


def phase_pix3d_train(kernels, steps: int = 5):
    """The Pix3D train step at full width (harness.pix3d_train_setup): bfloat16
    detection stack at 224x224, B=4, RPN 1000 / 512, 512 sampled RoIs and 64
    mask RoIs an image, the RPN, box, mask, voxel and mesh losses, SGD under
    the Pix3D schedule with the backbone trained. Every metric finite in every
    step, the voxel branch's and the FPN's parameters moved, K1 three times a
    step (the stage chamfers at [4, 10000, 3]), K3 never (face normals)."""
    import torch

    from meshrcnn_tpu_torch.harness import pix3d_train_setup
    dev = torch.device("cuda")
    model, config, loader = pix3d_train_setup(steps, dev)
    groups = {"voxel branch": "voxelBranch.", "FPN": "backbone.backbone."}
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(tuple(groups.values()))}
    counts = _train("pix3d train", model, config, loader, dev, PIX3D_TRAIN_METRICS)
    params = dict(model.named_parameters())
    for name, prefix in groups.items():
        names = [n for n in before if n.startswith(prefix)]
        moved = sum(not torch.equal(params[n].detach(), before[n]) for n in names)
        print(f"[pix3d train] {name}: {moved} of {len(names)} parameter tensors moved")
        if moved != len(names):
            _fail(f"pix3d train: a parameter of the {name} did not move")
    want = {"chamfer_nn_bidir": 3 * steps, "knn_topk_batched": 0,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"pix3d train launched {counts}, want {want}")
    kernels["chamfer_nn_bidir"]["launches"] += counts["chamfer_nn_bidir"]


def phase_estimator(kernels, steps: int = 3, batches: int = 2):
    """The reference normal estimator at full width: train steps with normal
    weight 0.1 and face_normals=False, then eval batches with face_normals=False.
    K3 six times a step and a batch (2 clouds x 3 stages), K1 three times a
    step and four times a batch."""
    import torch

    from meshrcnn_tpu_torch.core.config import LossWeights
    from meshrcnn_tpu_torch.harness import SyntheticBatch, shapenet_train_setup, validate
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step
    dev = torch.device("cuda")
    weights = LossWeights(voxel=1.0, chamfer=1.0, normal=0.1, edge=0.5)
    model, config, loader = shapenet_train_setup(steps, dev, loss_weights=weights,
                                                 face_normals=False)
    counts = _train("estimator train", model, config, loader, dev)
    want = {"chamfer_nn_bidir": 3 * steps, "knn_topk_batched": 6 * steps,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"estimator train launched {counts}, want {want}")
    total = counts["knn_topk_batched"]

    rng = np.random.RandomState(1)
    eval_loader = [SyntheticBatch(rng) for _ in range(batches)]
    _reset_counts()
    res = validate(make_eval_step(model), eval_loader, config, 13,
                   uniform_from(torch.Generator(device=dev).manual_seed(2)), device=dev,
                   print_freq=10 ** 9)
    torch.cuda.synchronize()
    counts = _counts()
    scalars = {k: v for k, v in res.items() if k != "confusion"}
    print(f"[estimator eval] metrics {json.dumps(scalars)}")
    print(f"[estimator eval] {batches} batches; steady {res['batch_time'] * 1e3:.2f} "
          f"ms/batch (first batch {res['warmup_time'] * 1e3:.2f} ms); launches {counts}")
    if not all(np.isfinite(v) for v in scalars.values()):
        _fail("non-finite estimator eval metric")
    want = {"chamfer_nn_bidir": 4 * batches, "knn_topk_batched": 6 * batches,
            "chamfer_sums_fused": 0, "knn_topk": 0}
    if counts != want:
        _fail(f"estimator eval launched {counts}, want {want}")
    kernels["knn_topk_batched"]["launches"] = total + counts["knn_topk_batched"]


def phase_single(kernels, calls: int = 3):
    """The single-sample entry points at 10k points: ``chamfer_distance`` (K2)
    and ``knn`` (K4), on clouds sampled from a bumpy sheet."""
    import torch

    from meshrcnn_tpu_torch.ops.chamfer import chamfer_distance, knn
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    _reset_counts()
    for _ in range(calls):
        xy = torch.rand((2, 10000, 2), generator=g) * 2 - 1
        z = 0.3 * torch.sin(2 * xy[..., :1]) * torch.cos(3 * xy[..., 1:])
        p, q = torch.cat([xy, z], -1).to(dev)
        s_p, _, s_q, _ = chamfer_distance(p, q)
        dists, idx = knn(p, q, 10)
        ok = (bool(torch.isfinite(torch.stack([s_p, s_q])).all())
              and bool((dists[:, 1:] >= dists[:, :-1]).all())
              and 0 <= int(idx.min()) and int(idx.max()) < q.shape[0])
        if not ok:
            _fail("single-sample chamfer sums or kNN are not finite, sorted and in range")
    torch.cuda.synchronize()
    counts = _counts()
    print(f"[single] {calls} x (chamfer_distance, knn k=10) at 10k points: last sums "
          f"{s_p.item():.6f}, {s_q.item():.6f}; launches {counts}")
    want = {"chamfer_nn_bidir": calls, "knn_topk_batched": calls,
            "chamfer_sums_fused": calls, "knn_topk": calls}
    if counts != want:
        _fail(f"single-sample paths launched {counts}, want {want}")
    kernels["chamfer_sums_fused"]["launches"] = counts["chamfer_sums_fused"]
    kernels["knn_topk"]["launches"] = counts["knn_topk"]


def phase_eval_bit_equal(batches: int = 2):
    """ShapeNet and Pix3D eval at full width (the bench recipes), twice on the
    same batches with the same draws: every metric, chamfer, normal, edge,
    F1 and the APs, must be the same bits in both runs. The refine stages'
    neighbour sums are segment sums in a fixed order (``ops/graph_conv.py``),
    and no other sum of the eval path adds floats in the order of atomics."""
    import torch

    from meshrcnn_tpu_torch.harness import (pix3d_bench_setup, shapenet_bench_setup, validate,
                                            validate_pix3d)
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    dev = torch.device("cuda")
    timing = {"batch_time", "data_loading", "warmup_time"}
    for tag, setup, fn, classes in (("ShapeNet", shapenet_bench_setup, validate, 13),
                                    ("Pix3D", pix3d_bench_setup, validate_pix3d, 10)):
        model, config, loader = setup(batches, dev)
        runs = [fn(make_eval_step(model), loader, config, classes,
                   uniform_from(torch.Generator(device=dev).manual_seed(5)), device=dev,
                   print_freq=10 ** 9) for _ in range(2)]
        keys = sorted(set(runs[0]) - timing - {"confusion"})
        differ = [k for k in keys if not np.array_equal(runs[0][k], runs[1][k])]
        if not np.array_equal(runs[0]["confusion"], runs[1]["confusion"]):
            differ.append("confusion")
        print(f"[eval bits] {tag}: two runs of {batches} batches; {len(keys)} metrics, "
              f"differing: {differ or 'none'}; chamfer {runs[0]['chamfer_loss']!r}, "
              f"normal {runs[0]['normal_loss']!r}, F1@0.1 {runs[0]['F1@0.1']!r}")
        if differ:
            _fail(f"{tag} eval metrics differ between two runs: "
                  f"{ {k: (runs[0][k], runs[1][k]) for k in differ if k != 'confusion'} }")


def _same_state(a, b) -> list:
    """Names of the entries where two train states differ: parameters and
    buffers, optimizer state, schedule, step and generator state."""
    import torch
    differ = [k for k, v in a.model.state_dict().items()
              if not torch.equal(v, b.model.state_dict()[k])]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            w = sb["state"][i][k]
            if not (torch.equal(v, w) if torch.is_tensor(v) else v == w):
                differ.append(f"optimizer {i} {k}")
    if [g["lr"] for g in a.optimizer.param_groups] != [g["lr"] for g in b.optimizer.param_groups]:
        differ.append("lr")
    if a.step != b.step:
        differ.append("step")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        differ.append("generator")
    return differ


def phase_cli(kernels, root: str):
    """The user's path: ``python -m meshrcnn_tpu_torch.train`` then
    ``eval_model --model_path`` on its checkpoint, called in process (``main``)
    so that the K1 counters can be read, at the bench widths: ShapeNet with
    residual refinement, B=3, capacities 8192/16384/32768, 10k-point clouds;
    Pix3D at 224x224 with a bfloat16 detection stack, B=4, capacities
    4096/8192/16384, SGD at lr 0.02 under the Pix3D schedule with the
    backbone trained and voxel weight 3. Each trains 12 steps on the synthetic
    dataset with 2 loader threads, evaluates 6 batches of the held-out side of
    the split, and is checked: every metric finite, K1 launches exact (3 a
    train step, 4 a ShapeNet and 5 a Pix3D eval batch), the final checkpoint
    reloaded on the card equal in every bit (parameters, buffers, optimizer
    state, learning rate, step, generator), one resumed step continuing the
    step count and the Pix3D learning rate, the stats and metrics files
    readable. Each batch's wait for the loader is printed: the ``data_loading``
    meter averages them with the first, which no thread prefetches."""
    from meshrcnn_tpu_torch import harness

    recipes = {
        "ShapeNet": (3, ["--residual", "--vert_capacity", "8192", "--face_capacity", "16384",
                         "--edge_capacity", "32768"], [], 4),
        "Pix3D": (4, ["--img_size", "224", "--vert_capacity", "4096", "--face_capacity", "8192",
                      "--edge_capacity", "16384"],
                  ["--optim", "SGD", "--lr", "0.02", "--weightDecay", "1e-4",
                   "--train_backbone", "--voxel", "3"], 5),
    }
    waits = []                         # each batch's wait, in the order waited
    timed_iter = harness._timed_iter

    class Booked:
        """The loader's meter, keeping each wait as well as their mean."""
        def __init__(self, meter):
            self.meter = meter

        def update(self, value, n=1):
            waits.append(value)
            self.meter.update(value, n)

    def wait_line(step_ms):
        ms = [w * 1e3 for w in waits]
        steady = float(np.mean(ms[1:]))
        return (f"waits for the loader {ms[0]:.3f} ms for the first batch, then "
                f"{steady:.3f} ms a batch over {len(ms) - 1} ({steady / step_ms:.2%} of a "
                f"steady step); each {json.dumps([round(m, 3) for m in ms])}")

    harness._timed_iter = lambda loader, meter: timed_iter(loader, Booked(meter))
    try:
        _cli_runs(kernels, root, recipes, waits, wait_line)
    finally:
        harness._timed_iter = timed_iter


def _cli_runs(kernels, root, recipes, waits, wait_line):
    import os
    import pickle

    import torch

    from meshrcnn_tpu_torch import eval_model, train
    from meshrcnn_tpu_torch.parallel.train_step import create_train_state, pix3d_lr
    from meshrcnn_tpu_torch.utils import cli
    from meshrcnn_tpu_torch.utils.checkpoint import load_state
    from meshrcnn_tpu_torch.utils.meters import load_stats

    steps, eval_batches = 12, 6
    for model_name, (B, shape_flags, train_flags, k1_eval) in recipes.items():
        n_train, n_test = steps * B, eval_batches * B
        common = ["--model", model_name, "-b", str(B), "--point_cloud_size", "10000",
                  "--synthetic_size", str(n_train + n_test), "--workers", "2",
                  "--print_freq", "1000", "--num_devices", "1"] + shape_flags
        ck_root = os.path.join(root, "checkpoints")
        _reset_counts()
        waits.clear()
        t0 = time.perf_counter()
        out = train.main(common + train_flags + ["--num_sampels", str(n_train), "--nEpoch", "1",
                                                 "--checkpoint_root", ck_root])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        meters, state = out["meters"], out["state"]
        step_ms = meters["batch_time"].history[0] * 1e3
        print(f"[cli] {model_name} train: {steps} steps of {B} in {wall:.3f} s; steady "
              f"{step_ms:.2f} ms/step over {steps - 1} (first step "
              f"{meters['warmup_time'].history[0] * 1e3:.2f} ms); data_loading meter "
              f"{meters['data_loading'].history[0] * 1e3:.3f} ms; {wait_line(step_ms)}; "
              f"launches {counts}")
        if len(waits) != steps:
            _fail(f"{model_name} train: {len(waits)} waits for {steps} steps")
        history = {k: m.history for k, m in meters.items()}
        if not all(np.isfinite(h).all() and len(h) == 1 for h in history.values()):
            _fail(f"{model_name} train: a meter is not finite: {history}")
        if state.step != steps or meters["grads_finite"].history != [1.0]:
            _fail(f"{model_name} train: {state.step} steps, grads_finite "
                  f"{meters['grads_finite'].history}")
        want = {"chamfer_nn_bidir": 3 * steps, "knn_topk_batched": 0,
                "chamfer_sums_fused": 0, "knn_topk": 0}
        if counts != want:
            _fail(f"{model_name} train CLI launched {counts}, want {want}")
        total = counts["chamfer_nn_bidir"]
        stats = load_stats(out["stats"][0])
        if set(stats) != set(meters) or not all(
                isinstance(v["name"], str) and all(type(h) is float for h in v["history"])
                for v in stats.values()):
            _fail(f"{model_name}: {out['stats'][0]} is not a dict of names and float histories")

        # the final checkpoint, reloaded into a fresh state on the card
        options = train.parser.parse_args(common + train_flags)
        dev = torch.device("cuda")
        settings = train.model_settings(options, dev)
        fresh = create_train_state(cli.build_model(settings, dev), train.train_config(options),
                                   torch.Generator(device=dev).manual_seed(123))
        load_state(out["final"], fresh, settings)
        differ = _same_state(state, fresh)
        print(f"[cli] {model_name} checkpoint {os.path.basename(out['final'])} reloaded on the "
              f"card: {len(fresh.model.state_dict())} tensors, step {fresh.step}; "
              f"differing: {differ or 'none'}")
        if differ:
            _fail(f"{model_name}: the reloaded checkpoint differs in {differ}")

        # one more step from the checkpoint
        _reset_counts()
        resumed = train.main(common + train_flags + [
            "--num_sampels", str(B), "--nEpoch", "1", "--model_path", out["final"],
            "--checkpoint_root", os.path.join(root, "resumed")])["state"]
        counts = _counts()
        lr = resumed.optimizer.param_groups[0]["lr"]
        print(f"[cli] {model_name} resumed one step: step {resumed.step}, lr {lr!r}; "
              f"launches {counts}")
        if resumed.step != steps + 1 or counts["chamfer_nn_bidir"] != 3:
            _fail(f"{model_name}: the resumed run took step {resumed.step}, launched {counts}")
        if model_name == "Pix3D" and (lr != 1.0 * pix3d_lr(steps + 1)
                                      or resumed.scheduler.last_epoch != steps + 1):
            _fail(f"Pix3D: the resumed schedule gives lr {lr}, want {pix3d_lr(steps + 1)}")
        total += counts["chamfer_nn_bidir"]

        # eval of the checkpoint on the held-out side of the split
        _reset_counts()
        waits.clear()
        t0 = time.perf_counter()
        res = eval_model.main(common + ["--model_path", out["final"], "--test_ratio",
                                        repr(n_test / (n_train + n_test)),
                                        "--output_path", os.path.join(root, "eval")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        with open(res["path"], "rb") as f:
            saved = pickle.load(f)
        scalars = {k: v for k, v in saved.items() if k != "confusion"}
        print(f"[cli] {model_name} eval: {eval_batches} batches of {B} in {wall:.3f} s; steady "
              f"{res['batch_time'] * 1e3:.2f} ms/batch over {eval_batches - 1} (first "
              f"{res['warmup_time'] * 1e3:.2f} ms); data_loading meter "
              f"{res['data_loading'] * 1e3:.3f} ms; {wait_line(res['batch_time'] * 1e3)}; "
              f"launches {counts}; metrics {json.dumps(scalars)}")
        if len(waits) != eval_batches:
            _fail(f"{model_name} eval: {len(waits)} waits for {eval_batches} batches")
        if not all(np.isfinite(v) for v in scalars.values()) or "confusion" not in saved:
            _fail(f"{model_name} eval: a non-finite metric or no confusion in {res['path']}")
        want = {"chamfer_nn_bidir": k1_eval * eval_batches, "knn_topk_batched": 0,
                "chamfer_sums_fused": 0, "knn_topk": 0}
        if counts != want:
            _fail(f"{model_name} eval CLI launched {counts}, want {want}")
        kernels["chamfer_nn_bidir"]["launches"] += total + counts["chamfer_nn_bidir"]


def _tiny_model():
    from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
    return ShapeNetModel(num_classes=13, residual=False, cubify_threshold=0.2,
                         voxel_out_channels=8, vert_capacity=512, face_capacity=1024,
                         edge_capacity=2048, num_refinement_stages=3)


def _tiny_batch(B: int):
    """The tiny model's training batch (``__graft_entry__._tiny_batch``'s recipe):
    48x48 images, an 8x18x18 voxel target, 8 ground-truth verts and 6 faces."""
    import types
    rng = np.random.RandomState(0)
    gt_verts = np.zeros((B, 16, 3), np.float32)
    gt_verts[:, :8] = rng.randn(B, 8, 3)
    gt_faces = np.zeros((B, 24, 3), np.int32)
    gt_faces[:, :6] = rng.randint(0, 8, (B, 6, 3))
    gt_faces_mask = np.zeros((B, 24), bool)
    gt_faces_mask[:, :6] = True
    return types.SimpleNamespace(
        images=rng.rand(B, 48, 48, 3).astype(np.float32),
        voxels=(rng.rand(B, 8, 18, 18) > 0.5).astype(np.float32),
        gt_verts=gt_verts, gt_faces=gt_faces, gt_faces_mask=gt_faces_mask,
        labels=rng.randint(0, 13, (B,)).astype(np.int32))


def phase_small_card_vs_cpu():
    """The tiny model (48x48 images, capacities 512/1024/2048) on the card and
    on the CPU with the same weights. Tolerance 1e-4 relative to each output's
    scale: f32 on both (TF32 off), only summation order differs."""
    import torch

    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    torch.manual_seed(1)
    model = _tiny_model()
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 48, 48, 3).astype(np.float32))
    cpu = make_eval_step(model)(images)
    gpu = make_eval_step(model.to("cuda"))(images.to("cuda"))
    for name in ("logits", "voxels"):
        a, b = getattr(gpu, name).cpu(), getattr(cpu, name)
        err = ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
        print(f"[small] {name} card vs cpu: relative error {err:.3e}")
        if not err < 1e-4:
            _fail(f"{name} differs between the card and the CPU")


def _tiny_pix3d_model(voxel_only: bool = False):
    """tests/test_pix3d.py's TINY Pix3D model: RPN 64 / 32, 32 sampled RoIs and
    8 mask RoIs an image, capacities 256/512/1024, float32 detection stack."""
    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    return Pix3DModel(num_classes=10, voxel_out_channels=8, vert_capacity=256,
                      face_capacity=512, edge_capacity=1024, num_refinement_stages=3,
                      rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, roi_batch_size=32,
                      mask_rois=8, detections_per_img=3, backbone_dtype="float32",
                      voxel_only=voxel_only)


def phase_small_pix3d_card_vs_cpu():
    """The tiny Pix3D model (tests/test_pix3d.py TINY: 64x64 images, RPN 64 /
    32, capacities 256/512/1024, float32) in eval on the card and on the CPU
    with the same weights. Validity and labels identical; on valid slots boxes
    within 1e-3 px, and scores, mask probabilities, voxels and stage vertices
    within 1e-4 relative to scale (f32 on both, TF32 off: only summation order
    differs). Vertices are compared where cubify gave both devices the same
    mesh; a slot whose mesh differs must hold a voxel within 1e-5 of the
    threshold on one device, a decision the rounding may flip."""
    import torch

    from meshrcnn_tpu_torch.parallel.train_step import make_eval_step

    torch.manual_seed(4)
    model = _tiny_pix3d_model()
    images = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32))
    cpu = make_eval_step(model)(images)
    gpu = make_eval_step(model.to("cuda"))(images.to("cuda"))
    cd, gd = cpu.detections, gpu.detections
    if not (torch.equal(gd.valid.cpu(), cd.valid) and torch.equal(gd.labels.cpu(), cd.labels)):
        _fail("Pix3D detections' validity or labels differ between the card and the CPU")
    v = cd.valid
    slots = cpu.mesh_valid

    def rel(a, b):
        return ((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

    box_err = (gd.boxes.cpu()[v] - cd.boxes[v]).abs().max().item()
    errs = {"scores": rel(gd.scores[v.cuda()], cd.scores[v]),
            "mask_probs": rel(gpu.mask_probs[v.cuda()], cpu.mask_probs[v]),
            "voxels": rel(gpu.voxels[slots.cuda()], cpu.voxels[slots])}
    same_mesh = torch.tensor([torch.equal(gpu.mesh.faces[i].cpu(), cpu.mesh.faces[i])
                              and torch.equal(gpu.mesh.verts_mask[i].cpu(), cpu.mesh.verts_mask[i])
                              for i in range(slots.shape[0])]) & slots
    for i in torch.nonzero(slots & ~same_mesh).flatten().tolist():
        near = (cpu.voxels[i] - model.cubify_threshold).abs().min().item()
        print(f"[small pix3d] slot {i}: cubify meshes differ; nearest voxel to the "
              f"threshold {near:.2e}")
        if not near < 1e-5:
            _fail(f"slot {i}'s cubify mesh differs between the card and the CPU")
    m = same_mesh.cuda()
    for s, (a, b) in enumerate(zip(gpu.stage_verts, cpu.stage_verts)):
        errs[f"stage {s} verts"] = rel(a[m], b[same_mesh]) if bool(same_mesh.any()) else 0.0
    print(f"[small pix3d] {int(v.sum())} valid detections, {int(same_mesh.sum())} of "
          f"{int(slots.sum())} meshes identical; boxes max |card - cpu| {box_err:.3e} px; "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    if not (box_err <= 1e-3 and all(e < 1e-4 for e in errs.values())):
        _fail("the tiny Pix3D eval forward differs between the card and the CPU")


def _distance(a: dict, b: dict, keys) -> float:
    import torch
    return torch.sqrt(sum(((a[k].double() - b[k].double()) ** 2).sum() for k in keys)).item()


def phase_small_train_card_vs_cpu(lr: float = 1e-4, noise: float = 4.0, floor: float = 1e-4):
    """One train step of the tiny model (bench recipe, 512-point clouds, the
    same replayed uniforms) on the card and on the CPU from the same weights.
    In train mode this model amplifies f32 rounding ~1e4-fold (BatchNorm over
    8 values at c5, then the refine stages; tests/test_torch_train_step.py), so
    the card is held within ``noise`` times the CPU's own spread, the distance
    between CPU steps on images scaled by 1 and by 1 + 1e-6, plus ``floor`` of
    scale: gradients (trainable and frozen trees) and BN statistics. Losses:
    within 4 / point_cloud_size relative, four sampled points on another face
    (the card sums the face areas' cumulative distribution in another order,
    and a uniform near a boundary picks the neighbouring face). Parameters:
    within 2 lr absolute (Adam's first update is ~lr sign(g))."""
    import copy

    import torch

    from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
    from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                        make_train_step)

    torch.manual_seed(2)
    base = _tiny_model()
    pcs = 512
    config = TrainConfig(optimizer="adam", lr=lr, weight_decay=0.0, point_cloud_size=pcs,
                         loss_weights=LossWeights(voxel=1.0, chamfer=1.0, normal=0.0,
                                                  edge=0.5))
    draws = [np.random.RandomState(i).rand(2, pcs).astype(np.float32) for i in range(18)]
    batch = _tiny_batch(2)
    runs = {}
    for tag, dev, scale in (("cpu", "cpu", 1.0), ("nudged", "cpu", 1.0 + 1e-6),
                            ("card", "cuda", 1.0)):
        model = copy.deepcopy(base).to(dev)
        it = iter(draws)
        step = make_train_step(config, lambda shape: torch.from_numpy(next(it)))
        b = Batch.from_host(batch, dev)
        b.images = b.images * scale
        m = step(create_train_state(model, config), b)
        runs[tag] = ({k: v.cpu() for k, v in m.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
                     {k: v.cpu() for k, v in model.state_dict().items()})
    (m_c, g_c, s_c), (m_n, g_n, s_n), (m_g, g_g, s_g) = (runs[k] for k in
                                                         ("cpu", "nudged", "card"))
    for k in m_c:
        d, spread = abs(m_g[k] - m_c[k]).item(), abs(m_n[k] - m_c[k]).item()
        print(f"[small train] {k}: card {m_g[k].item():.6f} cpu {m_c[k].item():.6f} "
              f"(cpu spread {spread:.3e})")
        if not d <= 4.0 / pcs * max(abs(m_c[k].item()), 1.0):
            _fail(f"train metric {k} differs between the card and the CPU")
    stats = [k for k in s_c if "running_" in k]
    groups = {"trainable grads": (g_g, g_c, g_n, [k for k in g_c if not k.startswith("backbone.")]),
              "frozen grads": (g_g, g_c, g_n, [k for k in g_c if k.startswith("backbone.")]),
              "BN statistics": (s_g, s_c, s_n, stats)}
    for name, (a, b, n, keys) in groups.items():
        d, spread, scale = _distance(a, b, keys), _distance(n, b, keys), _distance(
            b, {k: torch.zeros_like(b[k]) for k in keys}, keys)
        print(f"[small train] {name}: card-cpu {d:.3e}, cpu spread {spread:.3e}, "
              f"scale {scale:.3e}")
        if not d <= noise * spread + floor * max(scale, 1.0):
            _fail(f"{name} differ between the card and the CPU")
    params = [k for k in s_c if "running_" not in k and "num_batches" not in k]
    worst = max((s_g[k] - s_c[k]).abs().max().item() for k in params)
    print(f"[small train] params: max |card - cpu| {worst:.3e} (lr {lr})")
    if not worst <= 2 * lr * 1.001:
        _fail("updated parameters differ between the card and the CPU by more than 2 lr")


def _tiny_pix3d_batch(B: int = 2, H: int = 64):
    """tests/test_pix3d.py's ``tiny_batch``: one box [8, 8, 40, 40] and its
    mask an image, an 8x24x24 voxel target, 8 ground-truth verts and 6 faces."""
    import types
    batch = _tiny_batch(B)
    rng = np.random.RandomState(1)
    masks = np.zeros((B, H, H), np.float32)
    masks[:, 10:38, 10:38] = 1.0
    return types.SimpleNamespace(
        images=rng.rand(B, H, H, 3).astype(np.float32),
        voxels=(rng.rand(B, 8, 24, 24) > 0.5).astype(np.float32),
        gt_verts=batch.gt_verts, gt_faces=batch.gt_faces, gt_faces_mask=batch.gt_faces_mask,
        labels=rng.randint(1, 10, (B,)).astype(np.int32),
        boxes=np.tile(np.float32([[8, 8, 40, 40]]), (B, 1, 1)), masks=masks)


def _nudged_images(images):
    """1e-6 changes of the input: scaled by 1 + 1e-6, and pixel by pixel by
    1 + 1e-6 u for uniforms u in [-1, 1] of two seeds. One change alone may
    move a train-mode result 100 times less than another."""
    yield images * np.float32(1.0 + 1e-6)
    for seed in (0, 1):
        u = np.random.RandomState(seed).uniform(-1.0, 1.0, images.shape).astype(np.float32)
        yield (images * (1.0 + 1e-6 * u)).astype(np.float32)


def phase_small_pix3d_train_card_vs_cpu(noise: float = 4.0, floor: float = 1e-4,
                                        device: str = "cuda"):
    """One train step of the tiny Pix3D model (the bench recipe's SGD, Pix3D
    schedule and weights, 512-point clouds) on the card and on the CPU from
    the same weights with the same uniforms, which replay one numpy stream.
    The RPN's and the RoI heads' sampled indices are identical; losses within
    4 / point_cloud_size relative (points on a neighbouring face, as in
    ``phase_small_train_card_vs_cpu``); gradients (the detection stack and the
    mesh branch apart) and BN statistics within ``noise`` times the CPU's own
    spread, the largest distance to CPU steps on images changed by 1e-6
    (``_nudged_images``) that sampled the CPU step's indices, plus ``floor`` of
    scale; a nudged step that sampled other indices made another discrete
    choice and is left out of the spread, and the phase fails if none is left.
    In train mode this model amplifies rounding: BatchNorm over two images, the
    RPN's proposals, matches at IoU 0.5 and cubify at a capacity of 256
    vertices. The composed detection stack is held tightly in float64 by
    ``phase_small_backward_card_vs_cpu`` ("pix3d detection stack")."""
    import copy

    import torch

    from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
    from meshrcnn_tpu_torch.models import roi_heads, rpn
    from meshrcnn_tpu_torch.ops import matcher
    from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                        make_train_step)

    torch.manual_seed(5)
    base = _tiny_pix3d_model()
    pcs = 512
    config = TrainConfig(optimizer="sgd", lr=0.02, weight_decay=1e-4, point_cloud_size=pcs,
                         train_backbone=True, pix3d_schedule=True,
                         loss_weights=LossWeights(voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5))
    host = _tiny_pix3d_batch()
    sampled = []

    def recording(*args, **kwargs):
        out = matcher.balanced_sample(*args, **kwargs)
        sampled.append(out[0].cpu())
        return out
    runs = {}
    inputs = [("cpu", "cpu", host.images), ("card", device, host.images)] + [
        (f"nudged {i}", "cpu", x) for i, x in enumerate(_nudged_images(host.images))]
    rpn.balanced_sample = roi_heads.balanced_sample = recording
    try:
        for tag, dev, images in inputs:
            model = copy.deepcopy(base).to(dev)
            stream = np.random.RandomState(0)
            step = make_train_step(config, lambda shape: torch.from_numpy(
                stream.rand(*shape).astype(np.float32)))
            b = Batch.from_host(host, dev)
            b.images = torch.from_numpy(images).to(dev)
            sampled.clear()
            m = step(create_train_state(model, config), b)
            runs[tag] = ({k: v.cpu() for k, v in m.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None},
                         {k: v.cpu() for k, v in model.state_dict().items() if "running_" in k},
                         list(sampled))
    finally:
        rpn.balanced_sample = roi_heads.balanced_sample = matcher.balanced_sample
    (m_c, g_c, s_c, i_c), (m_g, g_g, s_g, i_g) = runs["cpu"], runs["card"]
    def same_indices(run):
        return len(run[3]) == len(i_c) == 2 and all(torch.equal(a, b) for a, b in zip(run[3], i_c))
    if not same_indices(runs["card"]):
        _fail("the sampled RPN or RoI indices differ between the card and the CPU")
    tags = [t for t in runs if t.startswith("nudged")]
    nudged = [runs[t] for t in tags if same_indices(runs[t])]
    print(f"[small pix3d train] sampled indices identical: RPN {tuple(i_c[0].shape)}, RoI "
          f"{tuple(i_c[1].shape)}; {len(nudged)} of {len(tags)} nudged CPU steps sampled "
          f"the same indices and set the spread")
    if not nudged:
        _fail("no nudged CPU step sampled the CPU step's indices: no spread to hold the card to")
    for k in m_c:
        d = abs(m_g[k] - m_c[k]).item()
        spread = max(abs(n[0][k] - m_c[k]).item() for n in nudged)
        print(f"[small pix3d train] {k}: card {m_g[k].item():.6f} cpu {m_c[k].item():.6f} "
              f"(cpu spread {spread:.3e})")
        if not (np.isfinite(m_g[k].item()) and d <= 4.0 / pcs * max(abs(m_c[k].item()), 1.0)):
            _fail(f"Pix3D train metric {k} differs between the card and the CPU")
    groups = {"detection stack grads": (1, [k for k in g_c if k.startswith("backbone.")]),
              "mesh branch grads": (1, [k for k in g_c if not k.startswith("backbone.")]),
              "BN statistics": (2, list(s_c))}
    for name, (j, keys) in groups.items():
        a, b = runs["card"][j], runs["cpu"][j]
        d = _distance(a, b, keys)
        spread = max(_distance(n[j], b, keys) for n in nudged)
        scale = _distance(b, {k: torch.zeros_like(b[k]) for k in keys}, keys)
        print(f"[small pix3d train] {name}: card-cpu {d:.3e}, cpu spread {spread:.3e}, "
              f"scale {scale:.3e}")
        if not d <= noise * spread + floor * max(scale, 1.0):
            _fail(f"Pix3D {name} differ between the card and the CPU")


def _backward_pieces():
    """name -> (module or None, float inputs, int inputs, scalar of (module,
    floats, ints), dtype): every module the train step differentiates
    through, at the bench recipe's widths and the tiny model's spatial sizes
    (B=2, 48x48 images), eval mode, with fixed random cotangents. The mesh
    loss runs K1, which takes float32; the modules run in float64 (see
    ``phase_small_backward_card_vs_cpu``)."""
    import torch

    from meshrcnn_tpu_torch.core.mesh import MeshBatch
    from meshrcnn_tpu_torch.models import layers
    from meshrcnn_tpu_torch.models.resnet import ResNet50
    from meshrcnn_tpu_torch.ops.graph_conv import precompute_adjacency
    from meshrcnn_tpu_torch.ops.losses import mesh_loss

    rng = np.random.RandomState(4)

    def randn(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def dot(outs, cots):
        return sum((o * torch.from_numpy(c).to(o.device)).sum() for o, c in zip(outs, cots))

    torch.manual_seed(3)
    B, V, E, pcs = 2, 512, 2048, 512
    maps = [randn(B, s, s, c) for s, c in ((12, 256), (6, 512), (3, 1024), (2, 2048))]
    verts = rng.uniform(-0.8, 0.8, (B, V, 3)).astype(np.float32) - np.float32([0, 0, 2])
    a, b = rng.randint(0, V, (2, B, E))
    edges = np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(np.int32)
    mask = rng.rand(B, E) > 0.2
    cell_cots = [randn(B, V, 3), randn(B, V, 128)]

    def cell(m, f, i):
        topo = precompute_adjacency(i[0], i[1], V)
        return dot(m(f[:4], f[4], topo, (48, 48), vert_feats=f[5]), cell_cots)

    images = rng.rand(B, 48, 48, 3).astype(np.float32)
    backbone = ResNet50(num_classes=13).eval()
    with torch.no_grad():
        logits, fms = backbone(torch.from_numpy(images))
    backbone_cots = [randn(*o.shape) for o in [logits, *fms]]
    c5 = randn(B, 5, 5, 2048)

    def backbone_fn(m, f, i):
        out_logits, out_maps = m(f[0])
        return dot([out_logits, *out_maps], backbone_cots)
    voxel_cot = randn(B, 48, 10, 10)

    F = 300
    faces = rng.randint(0, V, (B, F, 3)).astype(np.int32)
    gt_v, gt_f = randn(B, 200, 3, scale=0.5), rng.randint(0, 200, (B, 400, 3)).astype(np.int32)
    draws = [rng.rand(B, pcs).astype(np.float32) for _ in range(6)]

    def loss(m, f, i):
        it = iter(draws)
        mesh = MeshBatch(verts=f[0], verts_mask=torch.ones((B, V), dtype=torch.bool,
                                                           device=f[0].device),
                         faces=i[0], faces_mask=torch.ones_like(i[0][..., 0], dtype=torch.bool),
                         edges=i[1], edges_mask=i[2])
        c, n, e = mesh_loss(f[0], mesh, f[1], i[3], torch.ones_like(i[3][..., 0], dtype=torch.bool),
                            lambda shape: torch.from_numpy(next(it)).to(f[0].device),
                            point_cloud_size=pcs, face_normals=True)
        return c + 0.1 * n + 0.5 * e

    return {
        "refine cell": (layers.ResVertixRefineShapenet(use_input_features=True).eval(),
                        maps + [verts, randn(B, V, 128)], [edges, mask], cell, torch.float64),
        "backbone": (backbone, [images], [], backbone_fn, torch.float64),
        "voxel head": (layers.VoxelBranch(2048, 48).eval(), [c5], [],
                       lambda m, f, i: dot([m(f[0])], [voxel_cot]), torch.float64),
        "mesh loss": (None, [verts * 0.5 + np.float32([0, 0, 1]), gt_v], [faces, edges, mask, gt_f],
                      loss, torch.float32),
    }


def _pix3d_backward_pieces():
    """``_backward_pieces`` of the Pix3D train step's detection losses, in
    float64: the RPN loss over the anchors of a 224x224 image, the RoI heads'
    training branch with its box losses (sampling, 12x12 pool, box head,
    predictor), the mask loss (14x14 pool, mask head, GT mask crop),
    ``multiscale_roi_align`` into the level table, ``filter_roi_input``, and
    the detection stack composed: the tiny Pix3D model without its mesh branch
    in train mode (FPN with BatchNorm over the batch, RPN, proposals, RoI
    heads, the best-IoU RoI feature and the voxel head) on the tiny train
    batch, its running statistics held too; and the tiny train step whole
    (``pix3d_loss_fn``: the stack, then cubify, the refine stages and the
    sampled chamfer, normal and edge losses of 256-point clouds, K1's indices
    taken from a float32 launch and every gather and distance in float64).
    Channels and heads at the bench recipe's widths, B=2; every sampler draws
    the same fixed uniforms on both devices."""
    import torch

    from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
    from meshrcnn_tpu_torch.models.pix3d import filter_roi_input
    from meshrcnn_tpu_torch.models.roi_heads import Detections, RoIHeads
    from meshrcnn_tpu_torch.parallel.train_step import Batch, pix3d_loss_fn
    from meshrcnn_tpu_torch.models.rpn import generate_anchors, rpn_loss
    from meshrcnn_tpu_torch.ops import roi_align

    rng = np.random.RandomState(6)
    B = 2

    def randn(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def boxes(n, lo, hi, wmin, wmax):
        xy = rng.uniform(lo, hi, (B, n, 2))
        return np.concatenate([xy, xy + rng.uniform(wmin, wmax, (B, n, 2))], -1).astype(np.float32)

    def replay(shapes):
        draws = [rng.rand(*shape).astype(np.float32) for shape in shapes]

        def make(device):
            it = iter(draws)
            return lambda shape: torch.from_numpy(next(it)).to(device)
        return make

    # the RPN loss: 12495 anchors of P2..P6 at 224x224, one GT box an image
    shapes = [(224 // s, 224 // s) for s in (4, 8, 16, 32)] + [(4, 4)]
    n_anchors = [3 * h * w for h, w in shapes]
    rpn_draws = replay([(B, sum(n_anchors))] * 2)
    gt = np.float32([[[40, 50, 190, 180]], [[30, 20, 120, 150]]])

    def rpn_fn(m, f, i):
        dev = f[0].device
        obj, box = rpn_loss(rpn_draws(dev), f[:5], f[5:10],
                            generate_anchors(shapes, (224, 224), dev), f[10])
        return 0.7 * obj + 1.3 * box

    # the RoI heads at 64x64: 256-channel FPN, 40 proposals around the GT
    size, R = 64, 40
    maps = [randn(B, 256, size // s, size // s) for s in (4, 8, 16, 32, 64)]
    gt_small = np.float32([[[8, 10, 40, 44]], [[20, 16, 60, 50]]])
    props = np.clip(gt_small + rng.uniform(-10, 10, (B, R, 4)), -20, 90).astype(np.float32)
    props[:, ::4] = boxes(R // 4, -10, 50, 8, 70)
    valid = np.ones((B, R), bool)
    valid[:, -3:] = False
    labels = np.int64([3, 7])
    heads = RoIHeads(num_classes=10, batch_size_per_image=64, mask_rois=8).eval()
    box_draws = replay([(B, R + 1)] * 2)

    def box_fn(m, f, i):
        _, losses, _ = m(f[:5], f[5], i[0], (size, size), train=True, gt_boxes=f[6],
                         gt_labels=i[1], uniform=box_draws(f[0].device))
        return 0.9 * losses["loss_classifier"] + 1.1 * losses["loss_box_reg"]

    masks = np.zeros((B, size, size), np.float32)
    masks[0, 12:40, 10:36] = masks[1, 18:48, 24:58] = 1.0
    pos = rng.rand(B, 32) < 0.3
    mask_draws = replay([(B, 32)])

    def mask_fn(m, f, i):
        return m._mask_loss(mask_draws(f[0].device), roi_align.flatten_levels(f[:4]), f[4],
                            i[0], i[1], i[2], (size, size))

    pool_cot = randn(B, 60, 12, 12, 256)

    def align_fn(m, f, i):
        out = roi_align.multiscale_roi_align(roi_align.flatten_levels(f[:4]), f[4], (224, 224),
                                             12, 1)
        return (out * torch.from_numpy(pool_cot).to(out.device)).sum()

    det_valid = np.array([[True, False, True], [False, False, False]])
    roi_cot = randn(B, 12, 12, 256)

    def filter_fn(m, f, i):
        det = Detections(boxes=f[1], labels=torch.ones_like(i[0], dtype=torch.long),
                         scores=torch.ones_like(f[1][..., 0]), valid=i[0], roi_features=f[2])
        out = filter_roi_input(f[0], det)
        return (out * torch.from_numpy(roi_cot).to(out.device)).sum()

    torch.manual_seed(7)
    stack = _tiny_pix3d_model(voxel_only=True).train()
    batch = _tiny_pix3d_batch()
    voxel_cot = randn(*batch.voxels.shape)

    # the whole tiny step, its mesh branch composed: cubify, refine and the
    # sampled chamfer / normal / edge losses, K1's indices from float32 casts
    torch.manual_seed(9)
    whole = _tiny_pix3d_model().train()
    step_config = TrainConfig(point_cloud_size=256, loss_weights=LossWeights(
        voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5))

    def step_fn(m, f, i):
        draws = np.random.RandomState(10)
        b = Batch(images=f[0], boxes=f[1], voxels=f[2], gt_verts=f[3], labels=i[0], masks=i[1],
                  gt_faces=i[2], gt_faces_mask=i[3])
        total, _ = pix3d_loss_fn(m, step_config, b, lambda shape: torch.from_numpy(
            draws.rand(*shape).astype(np.float32)).to(f[0].device))
        return total

    def stack_fn(m, f, i):
        draws = np.random.RandomState(8)
        out = m(f[0], f[1], i[0], i[1], lambda shape: torch.from_numpy(
            draws.rand(*shape).astype(np.float32)).to(f[0].device))
        losses = [out.backbone_losses[k] for k in sorted(out.backbone_losses)]
        return (sum((1.0 + 0.1 * n) * x for n, x in enumerate(losses))
                + (out.voxels * torch.from_numpy(voxel_cot).to(out.voxels.device)).sum())

    f64 = torch.float64
    return {
        "rpn loss": (None, [randn(B, n, scale=2.0) for n in n_anchors]
                     + [randn(B, n, 4, scale=0.5) for n in n_anchors] + [gt], [], rpn_fn, f64),
        "roi heads box losses": (heads, maps + [props, gt_small], [valid, labels], box_fn, f64),
        "mask loss": (heads, maps[:4] + [props[:, :32].copy()], [pos, labels, masks], mask_fn,
                      f64),
        "multiscale roi align": (None, [randn(B, 256, 224 // s, 224 // s) for s in (4, 8, 16, 32)]
                                 + [boxes(60, -20, 200, 4, 230)], [], align_fn, f64),
        "filter roi input": (None, [gt, boxes(3, 20, 120, 30, 100), randn(B, 3, 12, 12, 256)],
                             [det_valid], filter_fn, f64),
        "pix3d detection stack": (stack, [batch.images, batch.boxes],
                                  [batch.labels.astype(np.int64), batch.masks > 0.5], stack_fn,
                                  f64),
        "pix3d step with its mesh branch": (
            whole, [batch.images, batch.boxes, batch.voxels, batch.gt_verts],
            [batch.labels.astype(np.int64), batch.masks > 0.5, batch.gt_faces,
             batch.gt_faces_mask], step_fn, f64),
    }


def phase_small_backward_card_vs_cpu(device: str = "cuda"):
    """The train step's backward piece by piece (``_backward_pieces``), on the
    card and on the CPU from the same weights and inputs: every parameter's
    and input's gradient, and every running statistic a train-mode module
    updated, within 1e-4 of its scale (max |card - cpu| / max(max |cpu|, 1))
    in float32, 1e-9 in float64; only summation order differs. The modules run in float64 because their ReLUs are kinks: in
    float32 a pre-activation within rounding of 0 takes the other branch on
    the other device and moves a weight's gradient by ~1/(B*V) of its scale
    (5.6e-4 in a refine cell at 512 vertices, on an H100). The whole step is
    held more loosely above, as it amplifies rounding."""
    import copy

    import torch
    tols = {torch.float32: 1e-4, torch.float64: 1e-9}
    pieces = {**_backward_pieces(), **_pix3d_backward_pieces()}
    for name, (module, floats, ints, fn, dtype) in pieces.items():
        grads = {}
        for dev in ("cpu", device):
            m = copy.deepcopy(module).to(dev, dtype) if module is not None else None
            f = [torch.from_numpy(x).to(dev, dtype).requires_grad_(True) for x in floats]
            fn(m, f, [torch.from_numpy(x).to(dev) for x in ints]).backward()
            named = dict(m.named_parameters()) if m is not None else {}
            named.update({f"input{k}": x for k, x in enumerate(f)})
            grads[dev] = {k: p.grad.cpu().double() for k, p in named.items()
                          if p.grad is not None}
            if m is not None and m.training:
                grads[dev].update({f"buffer {k}": b.cpu().double() for k, b in m.named_buffers()
                                   if b.is_floating_point()})
        cpu, card = grads["cpu"], grads[device]
        if set(cpu) != set(card) or not cpu:
            _fail(f"{name}: the card and the CPU differentiate different tensors")
        errs = {k: ((card[k] - cpu[k]).abs().max() / max(cpu[k].abs().max().item(), 1.0)).item()
                for k in cpu}
        worst = max(errs, key=errs.get)
        stats = sum(k.startswith("buffer ") for k in errs)
        print(f"[small backward] {name} ({dtype}): {len(errs) - stats} gradients, {stats} "
              f"running statistics, worst {worst} {errs[worst]:.3e} of its scale")
        if not errs[worst] < tols[dtype]:
            _fail(f"{name}: {worst} differs between the card and the CPU")


# ----------------------------------------------------------------------------
# Data parallelism: ranks spawned by phase_dp. A spawned rank re-imports this
# script as a module, so everything it runs lives at module level.

DP_STEPS = 3
DP_SEED = 1


def _state_digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes, in state_dict order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _emulated_step(start, config, shards, generators, scale: float = 1.0):
    """One DP step in one process on the card: the loss and backward of every
    shard from ``start`` with that rank's generator, the gradients (zero where
    a parameter got none), metrics and BN running statistics averaged over
    the shards, then the optimizer. Returns (metrics, gradients, statistics,
    parameters)."""
    import copy

    import torch

    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel.train_step import (_update, create_train_state,
                                                        pix3d_loss_fn, shapenet_loss_fn)
    model = copy.deepcopy(start)
    loss_fn = pix3d_loss_fn if isinstance(model, Pix3DModel) else shapenet_loss_fn
    params = list(model.parameters())
    sd0 = copy.deepcopy(model.state_dict())
    grads, stats, metrics = [], [], []
    for shard, gen in zip(shards, generators):
        model.load_state_dict(sd0)
        model.train()
        for p in params:
            p.grad = None
        shard = copy.copy(shard)
        shard.images = shard.images * scale
        total, m = loss_fn(model, config, shard, uniform_from(gen))
        total.backward()
        grads.append([torch.zeros_like(p) if p.grad is None else p.grad for p in params])
        stats.append({k: v.clone() for k, v in model.state_dict().items() if "running_" in k})
        metrics.append(m)
    model.load_state_dict(sd0)
    n = len(shards)
    mean = {k: sum(m[k] for m in metrics) / n for k in metrics[0]}
    for i, p in enumerate(params):
        p.grad = sum(g[i] for g in grads) / n
    sd = model.state_dict()
    for k in stats[0]:
        sd[k].copy_(sum(s[k] for s in stats) / n)
    g = {name: p.grad.clone() for name, p in model.named_parameters()}
    _update(create_train_state(model, config), config)
    return (mean, g, {k: sd[k].clone() for k in stats[0]},
            {k: v.clone() for k, v in model.state_dict().items()
             if "running_" not in k and "num_batches" not in k})


def _dp_compare(got, runs, floor: float):
    """{group: (distance, spread, scale)} of ``got`` against ``runs[0]``, the
    spread the largest distance of another run to it."""
    import torch
    out = {}
    for j, name in enumerate(("metrics", "gradients", "BN statistics", "parameters")):
        keys = list(runs[0][j])
        a = {k: got[j][k].double() for k in keys}
        ref = {k: runs[0][j][k].double() for k in keys}
        d = _distance(a, ref, keys)
        spread = max([_distance({k: r[j][k].double() for k in keys}, ref, keys)
                      for r in runs[1:]] or [0.0])
        scale = _distance(ref, {k: torch.zeros_like(ref[k]) for k in keys}, keys)
        out[name] = (d, spread, scale, floor)
    return out


def _dp_train_case(kind: str, rank: int, world: int, dev, timing_only: bool) -> dict:
    """``DP_STEPS`` DP train steps of the full-width recipe of ``kind`` at its
    bench batch a rank: each step's state digest, metrics, kernel launches,
    ms and all-reduce ms; on rank 0 (unless ``timing_only``) the first step
    against ``_emulated_step`` (twice, and on images scaled by 1 + 1e-6)."""
    import copy

    import torch

    from meshrcnn_tpu_torch import harness
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel import distributed
    from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                        make_dp_train_step)
    if kind == "ShapeNet":
        model, config, _ = harness.shapenet_train_setup(0, dev)
        per, make = 3, harness.SyntheticBatch
    else:
        model, config, _ = harness.pix3d_train_setup(0, dev)
        per, make = 4, harness.SyntheticPix3DBatch
    rng = np.random.RandomState(7)
    batches = [make(rng, B=per * world) for _ in range(DP_STEPS)]
    gen = distributed.rank_generator(DP_SEED, rank, dev)
    state = create_train_state(model, config, gen)
    step = make_dp_train_step(config, uniform_from(gen))
    reduce_ms = []
    real = distributed.all_reduce_mean

    def timed(tensors, group=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(tensors, group)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"digests": [], "metrics": [], "counts": [], "ms": [], "reduce_ms": reduce_ms}
    distributed.all_reduce_mean = timed
    try:
        for i, host in enumerate(batches):
            shard = Batch.from_host(distributed.shard_batch(host, rank, world), dev)
            emulated = None
            if i == 0 and rank == 0 and not timing_only:
                shards = [Batch.from_host(distributed.shard_batch(host, r, world), dev)
                          for r in range(world)]
                start = copy.deepcopy(model)
                emulated = [_emulated_step(start, config, shards, [
                    distributed.rank_generator(DP_SEED, r, dev) for r in range(world)], s)
                    for s in (1.0, 1.0, 1.0 + 1e-6)]
                del start
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, shard)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["counts"].append(_counts())
            out["metrics"].append(dict(zip(m, torch.stack(list(m.values())).tolist())))
            out["digests"].append(_state_digest(model))
            if emulated is not None:
                got = (m, {n: p.grad for n, p in model.named_parameters()},
                       {k: v for k, v in model.state_dict().items() if "running_" in k},
                       {k: v for k, v in model.state_dict().items()
                        if "running_" not in k and "num_batches" not in k})
                out["emulation"] = _dp_compare(got, emulated, 1e-4)
                del emulated
    finally:
        distributed.all_reduce_mean = real
    return out


def _dp_f64_case(rank: int, world: int, dev, timing_only: bool) -> dict:
    """One DP step of the tiny Pix3D model in float64 (2 images a rank), and
    on rank 0 its one-process emulation, held at 1e-9 of scale."""
    import torch

    from meshrcnn_tpu_torch.core.config import LossWeights, TrainConfig
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel import distributed
    from meshrcnn_tpu_torch.parallel.train_step import (Batch, create_train_state,
                                                        make_dp_train_step)
    torch.manual_seed(9)
    model = _tiny_pix3d_model().to(dev, torch.float64)
    config = TrainConfig(point_cloud_size=256, loss_weights=LossWeights(
        voxel=3.0, chamfer=1.0, normal=0.1, edge=0.5))
    host = _tiny_pix3d_batch(2 * world)

    def batch_of(r):
        b = Batch.from_host(distributed.shard_batch(host, r, world), dev)
        for k in ("images", "voxels", "gt_verts", "boxes", "masks"):
            setattr(b, k, getattr(b, k).double())
        return b
    emulated = None
    if rank == 0:
        emulated = _emulated_step(model, config, [batch_of(r) for r in range(world)],
                                  [distributed.rank_generator(DP_SEED, r, dev)
                                   for r in range(world)])
    gen = distributed.rank_generator(DP_SEED, rank, dev)
    m = make_dp_train_step(config, uniform_from(gen))(
        create_train_state(model, config, gen), batch_of(rank))
    out = {"digest": _state_digest(model)}
    if emulated is not None:
        got = (m, {n: p.grad for n, p in model.named_parameters()},
               {k: v for k, v in model.state_dict().items() if "running_" in k},
               {k: v for k, v in model.state_dict().items()
                if "running_" not in k and "num_batches" not in k})
        out["emulation"] = _dp_compare(got, [emulated], 1e-9)
    return out


def _leaf_errors(got, parts: list) -> dict:
    """Each output tensor of ``got`` against the concatenation of its leaves in
    ``parts`` (one process's outputs): the largest float error relative to
    the tensor's scale, and whether every other tensor is identical."""
    import torch

    from meshrcnn_tpu_torch.parallel import distributed
    worst, name, exact = 0.0, None, True
    leaves = distributed.tensor_leaves(got, [])
    for i, a in enumerate(leaves):
        b = torch.cat([p[i] for p in parts]) if len(parts) > 1 else parts[0][i]
        if a.shape != b.shape or a.dtype != b.dtype:
            exact = False
        elif a.is_floating_point():
            err = ((a.double() - b.double()).abs().max()
                   / b.double().abs().max().clamp(min=1.0)).item() if a.numel() else 0.0
            if err >= worst:
                worst, name = err, i
        else:
            exact = exact and torch.equal(a, b)
    return {"leaves": len(leaves), "worst": worst, "worst_leaf": name, "exact": exact}


def _dp_eval_case(kind: str, rank: int, world: int, dev, timing_only: bool) -> dict:
    """DP eval of the full-width recipe of ``kind`` (bench batch a rank): the
    gathered outputs against the one-process eval of the whole batch (rank
    0), then two global batches through ``validate`` / ``validate_pix3d`` with
    a ``shard_fn`` and the kernel launches of each rank."""
    import torch

    from meshrcnn_tpu_torch import harness
    from meshrcnn_tpu_torch.ops.sampling import uniform_from
    from meshrcnn_tpu_torch.parallel import distributed
    from meshrcnn_tpu_torch.parallel.train_step import make_dp_eval_step, make_eval_step
    if kind == "ShapeNet":
        model, config, _ = harness.shapenet_bench_setup(0, dev)
        per, make, fn, classes = 3, harness.SyntheticBatch, harness.validate, 13
    else:
        model, config, _ = harness.pix3d_bench_setup(0, dev)
        per, make, fn, classes = 4, harness.SyntheticPix3DBatch, harness.validate_pix3d, 10
    rng = np.random.RandomState(8)
    batches = [make(rng, B=per * world) for _ in range(2)]
    images = torch.from_numpy(distributed.shard_batch(batches[0], rank, world).images).to(dev)
    got = make_dp_eval_step(model)(images)
    out = {}
    if rank == 0:
        step = make_eval_step(model)
        halves = [step(torch.from_numpy(distributed.shard_batch(batches[0], r, world).images)
                       .to(dev)) for r in range(world)]
        whole = step(torch.from_numpy(batches[0].images).to(dev))
        out["halves"] = _leaf_errors(got, [distributed.tensor_leaves(h, []) for h in halves])
        out["whole"] = _leaf_errors(got, [distributed.tensor_leaves(whole, [])])
    _reset_counts()
    res = fn(make_dp_eval_step(model), batches, config, classes,
             uniform_from(torch.Generator(device=dev).manual_seed(DP_SEED)), device=dev,
             print_freq=10 ** 9, shard_fn=lambda b: distributed.shard_batch(b, rank, world))
    torch.cuda.synchronize()
    out["counts"] = _counts()
    out["metrics"] = None if res is None else {k: float(v) for k, v in res.items()
                                               if k != "confusion"}
    return out


_DP_CASES = {
    "ShapeNet train": lambda *a: _dp_train_case("ShapeNet", *a),
    "Pix3D train": lambda *a: _dp_train_case("Pix3D", *a),
    "float64 step": _dp_f64_case,
    "ShapeNet eval": lambda *a: _dp_eval_case("ShapeNet", *a),
    "Pix3D eval": lambda *a: _dp_eval_case("Pix3D", *a),
}


def _dp_rank(rank: int, world: int, backend: str, store: str, out: str, cases: list,
             timing_only: bool) -> None:
    """One spawned rank: join the group, run each case, pickle the results."""
    import os
    import pickle

    import torch

    from meshrcnn_tpu_torch.parallel import distributed
    dev = torch.device(f"cuda:{rank if backend == 'nccl' else 0}")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(backend, rank=rank, world_size=world,
                                         init_method=f"file://{store}")
    try:
        results = {name: _DP_CASES[name](rank, world, dev, timing_only) for name in cases}
    finally:
        distributed.destroy()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def _dp_spawn(world: int, backend: str, cases: list, timing_only: bool = False) -> list:
    import os
    import pickle

    import torch
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_dp_rank, nprocs=world, args=(
            world, backend, os.path.join(tmp, "store"), tmp, cases, timing_only))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _dp_check(tag: str, ranks: list, kernels) -> None:
    """(a)'s checks of the ranks' results; adds their K1 launches to ``kernels``."""
    world = len(ranks)
    k1 = 0
    for kind in ("ShapeNet train", "Pix3D train"):
        r0 = ranks[0][kind]
        for i in range(DP_STEPS):
            digests = {r[kind]["digests"][i] for r in ranks}
            if len(digests) != 1:
                _fail(f"{tag} {kind}: the ranks' states differ after step {i}")
            for r, res in enumerate(ranks):
                c = res[kind]["counts"][i]
                if c != {"chamfer_nn_bidir": 3, "knn_topk_batched": 0, "chamfer_sums_fused": 0,
                         "knn_topk": 0}:
                    _fail(f"{tag} {kind}: rank {r} launched {c} in step {i}, want K1 x 3")
                k1 += c["chamfer_nn_bidir"]
                m = res[kind]["metrics"][i]
                if not all(np.isfinite(v) for v in m.values()) or m["grads_finite"] != 1.0:
                    _fail(f"{tag} {kind}: rank {r} step {i} has a non-finite metric")
        for name, (d, spread, scale, floor) in r0["emulation"].items():
            print(f"[dp] {tag} {kind} step 0 against its one-process emulation: {name} "
                  f"{d:.3e} (card spread {spread:.3e}, scale {scale:.3e})")
            if not d <= 4.0 * spread + floor * max(scale, 1.0):
                _fail(f"{tag} {kind}: the DP step's {name} differ from the emulation")
        print(f"[dp] {tag} {kind}: {world} ranks x {DP_STEPS} steps equal in every bit "
              f"(sha256 {r0['digests'][-1][:16]}); K1 x 3 a rank a step; metrics "
              f"{json.dumps(r0['metrics'][-1])}")
    f64 = ranks[0]["float64 step"]
    if len({r["float64 step"]["digest"] for r in ranks}) != 1:
        _fail(f"{tag}: the float64 ranks' states differ")
    for name, (d, _, scale, floor) in f64["emulation"].items():
        print(f"[dp] {tag} float64 tiny Pix3D step against its emulation: {name} "
              f"{d / max(scale, 1.0):.3e} of scale")
        if not d <= floor * max(scale, 1.0):
            _fail(f"{tag}: the float64 DP step's {name} differ from the emulation")
    for kind, per_batch in (("ShapeNet eval", 4), ("Pix3D eval", 5)):
        r0 = ranks[0][kind]
        h, w = r0["halves"], r0["whole"]
        print(f"[dp] {tag} {kind}: gathered {h['leaves']} output tensors against one "
              f"process's eval of the batch in the ranks' halves: worst float {h['worst']:.3e} "
              f"of scale (tensor {h['worst_leaf']}), others "
              f"{'identical' if h['exact'] else 'DIFFERENT'}; against its eval of the whole "
              f"batch in one forward: {w['worst']:.3e} (tensor {w['worst_leaf']}), others "
              f"{'identical' if w['exact'] else 'different'}; validate metrics "
              f"{json.dumps(r0['metrics'])}")
        if not (h["exact"] and h["worst"] <= 1e-4):
            _fail(f"{tag} {kind}: the gathered outputs differ from the one-process eval")
        if not all(np.isfinite(v) for v in r0["metrics"].values()):
            _fail(f"{tag} {kind}: a non-finite metric")
        for r, res in enumerate(ranks):
            want = 2 * per_batch if r == 0 else 0
            c = res[kind]["counts"]
            if c["chamfer_nn_bidir"] != want or sum(c.values()) != want:
                _fail(f"{tag} {kind}: rank {r} launched {c}, want K1 x {want}")
            if r and res[kind]["metrics"] is not None:
                _fail(f"{tag} {kind}: rank {r} returned metrics")
            k1 += c["chamfer_nn_bidir"]
    kernels["chamfer_nn_bidir"]["launches"] += k1


def _dp_timing(ranks: list) -> dict:
    """Steady ms/step (the steps after the first) and all-reduce ms a step, of rank 0."""
    out = {}
    for kind in ("ShapeNet train", "Pix3D train"):
        r = ranks[0][kind]
        out[kind] = (float(np.mean(r["ms"][1:])), float(np.mean(r["reduce_ms"][1:])))
    return out


def _dp_cli_nccl(kernels, root: str) -> None:
    """(b): ``python -m meshrcnn_tpu_torch.train --multihost`` in this process
    as rank 0 of a world of one, as torchrun would start it: NCCL set up, its
    all-reduce in every step, rank 0's checkpoint behind a barrier, reloaded
    equal in every bit."""
    import os
    import socket

    import torch

    from meshrcnn_tpu_torch import train
    from meshrcnn_tpu_torch.parallel import distributed
    from meshrcnn_tpu_torch.parallel.train_step import create_train_state
    from meshrcnn_tpu_torch.utils import cli
    from meshrcnn_tpu_torch.utils.checkpoint import load_state

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    backends = []
    real_init = distributed.init_from_env

    def recording(backend):
        real_init(backend)
        backends.append(torch.distributed.get_backend())
    flags = ["--model", "ShapeNet", "--residual", "-b", "3", "--num_sampels", "6",
             "--synthetic_size", "9", "--nEpoch", "1", "--point_cloud_size", "10000",
             "--workers", "2", "--print_freq", "1000", "--checkpoint_root",
             os.path.join(root, "dp_nccl")]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    distributed.init_from_env = recording
    _reset_counts()
    try:
        out = train.main(flags + ["--multihost"])
    finally:
        distributed.init_from_env = real_init
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    counts = _counts()
    state = out["state"]
    options = train.parser.parse_args(flags)
    dev = torch.device("cuda")
    settings = train.model_settings(options, dev)
    fresh = create_train_state(cli.build_model(settings, dev), train.train_config(options),
                               torch.Generator(device=dev).manual_seed(123))
    load_state(out["final"], fresh, settings)
    differ = _same_state(state, fresh)
    print(f"[dp] NCCL through the train CLI (--multihost, world 1): backend {backends}, "
          f"{state.step} steps, grads_finite {out['meters']['grads_finite'].history}, "
          f"launches {counts}; checkpoint reloaded, differing: {differ or 'none'}")
    if backends != ["nccl"] or state.step != 2 or differ:
        _fail("the NCCL CLI run did not use NCCL, take 2 steps or reload its checkpoint")
    if counts["chamfer_nn_bidir"] != 6 or sum(counts.values()) != 6:
        _fail(f"the NCCL CLI run launched {counts}, want K1 x 6")
    kernels["chamfer_nn_bidir"]["launches"] += counts["chamfer_nn_bidir"]
    n = torch.cuda.device_count()
    if n >= 2:                 # --num_devices: one spawned NCCL rank a card
        flags[flags.index("-b") + 1] = str(3 * n)
        flags[flags.index("--num_sampels") + 1] = str(6 * n)
        flags[flags.index("--synthetic_size") + 1] = str(9 * n)
        out = train.main(flags + ["--num_devices", str(n)])
        ckpt = torch.load(out["final"], map_location="cpu", weights_only=True)
        print(f"[dp] the train CLI with --num_devices {n}: checkpoint of world "
              f"{ckpt['world_size']}, step {ckpt['step']}, {len(ckpt['generators'])} "
              f"generators; grads_finite {out['meters']['grads_finite'].history}")
        if (ckpt["world_size"], ckpt["step"], len(ckpt["generators"])) != (n, 2, n) or \
                out["meters"]["grads_finite"].history != [1.0]:
            _fail(f"the train CLI on {n} NCCL ranks did not take 2 steps on {n} ranks")


def phase_dp(kernels, card: str, root: str):
    """Data parallelism (``make_dp_train_step``, ``make_dp_eval_step``, the
    CLIs' ``--num_devices`` / ``--multihost``):
      (a) two gloo ranks spawned on one card (gloo is the backend that lets
          two ranks share a card: a test configuration). ShapeNet train at
          the bench recipe, 3 images a rank, and Pix3D train, 4 a rank, 3
          steps each: the ranks' states equal in every bit after every step,
          K1 x 3 a rank a step, the first step against its one-process
          emulation on the card within 4x the card's own spread (a repeated
          emulation and one on images scaled by 1 + 1e-6) plus 1e-4 of scale;
          the tiny Pix3D step in float64 at 1e-9 of scale; DP eval of both
          models, the gathered outputs within 1e-4 of one process's eval of
          the same batch in the ranks' halves, integer outputs identical (the
          eval of the whole batch in one forward is printed beside it: cuDNN
          picks its bfloat16 algorithms by batch size), then two batches of
          ``validate`` / ``validate_pix3d`` with a ``shard_fn`` (K1 x 4 / x 5
          a batch on rank 0 only);
      (b) NCCL through the train CLI as rank 0 of a world of one
          (``--multihost``); with two or more cards also (a) on two NCCL ranks
          and the CLI with ``--num_devices`` = every card;
      (c) ms/step of one and of two ranks, and the all-reduce's ms a step."""
    import torch
    two = _dp_spawn(2, "gloo", list(_DP_CASES))
    _dp_check("gloo x 2 on one card", two, kernels)
    one = _dp_spawn(1, "gloo", ["ShapeNet train", "Pix3D train"], timing_only=True)
    for kind in ("ShapeNet train", "Pix3D train"):
        kernels["chamfer_nn_bidir"]["launches"] += sum(
            c["chamfer_nn_bidir"] for c in one[0][kind]["counts"])
    _dp_cli_nccl(kernels, root)
    t1, t2 = _dp_timing(one), _dp_timing(two)
    print(f"[dp] {card}: " + "; ".join(
        f"{kind} {t1[kind][0]:.2f} ms/step on 1 rank ({t1[kind][1]:.3f} ms all-reduce), "
        f"{t2[kind][0]:.2f} ms/step on 2 gloo ranks sharing the card ({t2[kind][1]:.3f} ms "
        f"all-reduce, {t2[kind][1] / t2[kind][0]:.1%} of the step)" for kind in t1))
    if torch.cuda.device_count() >= 2:
        nccl = _dp_spawn(2, "nccl", list(_DP_CASES))
        _dp_check("nccl x 2", nccl, kernels)
        t = _dp_timing(nccl)
        print(f"[dp] {card}: " + "; ".join(
            f"{kind} {t[kind][0]:.2f} ms/step on 2 NCCL ranks, a card each ({t[kind][1]:.3f} "
            f"ms all-reduce, {t[kind][1] / t[kind][0]:.1%} of the step)" for kind in t))


WANT_NONE = {"chamfer_nn_bidir": 0, "knn_topk_batched": 0, "chamfer_sums_fused": 0,
             "knn_topk": 0}


def _k1_only(n: int) -> dict:
    return dict(WANT_NONE, chamfer_nn_bidir=n)


def _check_api_eval(tag, got, B, D=None):
    """Every key of the reference's eval dict, with consistent shapes."""
    import torch
    keys = {"backbone", "voxels", "vertex_positions", "faces", "edge_index", "vertice_index",
            "face_index", "mesh_index"}
    if set(got) != keys:
        _fail(f"{tag}: eval dict keys {sorted(got)}")
    n_obj = B if D is None else sum(got["mesh_index"])
    total_v, total_f = sum(got["vertice_index"]), sum(got["face_index"])
    shapes = [tuple(s.shape) for s in got["vertex_positions"]]
    ok = (len(shapes) == 4 and all(s == (total_v, 3) for s in shapes)
          and got["faces"].shape == (total_f, 3) and got["edge_index"].shape[0] == 2
          and len(got["vertice_index"]) == len(got["face_index"]) == n_obj
          and all(np.isfinite(s).all() for s in got["vertex_positions"])
          and bool(torch.isfinite(got["voxels"]).all()))
    if D is None:
        ok = ok and tuple(got["backbone"].shape) == (B, 13) and got["mesh_index"] == [1] * B
    else:
        ok = ok and len(got["backbone"]) == B and all(
            set(d) == {"boxes", "labels", "scores", "valid", "masks"} and d["boxes"].shape == (D, 4)
            for d in got["backbone"]) and got["mesh_index"] == [
                int(d["valid"].sum()) for d in got["backbone"]]
    print(f"[api] {tag} eval: voxels {tuple(got['voxels'].shape)}, {n_obj} meshes, "
          f"{total_v} verts, {total_f} faces, edge_index {got['edge_index'].shape}, "
          f"mesh_index {got['mesh_index']}")
    if not ok:
        _fail(f"{tag}: the eval dict's shapes are inconsistent")


def _api_train_checks(tag, api, batch, trainable_prefix: str):
    """The train-mode loss dict (K1 x 3, the model unchanged in every bit),
    then two steps (K1 x 3 each, the step count, parameters moved: with
    random weights some get no gradient, and Adam without weight decay
    leaves those where they are)."""
    import torch
    before = {k: v.clone() for k, v in api.model.state_dict().items()}
    _reset_counts()
    losses = api(batch.images, batch)
    torch.cuda.synchronize()
    counts = _counts()
    after = api.model.state_dict()
    differ = [k for k in before if not torch.equal(before[k], after[k])]
    print(f"[api] {tag} train-mode losses {json.dumps({k: float(v) for k, v in losses.items()})}; "
          f"launches {counts}; changed entries: {differ or 'none'}")
    if counts != _k1_only(3) or differ or "loss" in losses or any(
            p.grad is not None for p in api.model.parameters()):
        _fail(f"{tag}: the train-mode call launched {counts}, changed {differ}")
    if not all(np.isfinite(float(v)) for v in losses.values()):
        _fail(f"{tag}: a non-finite train-mode loss")
    _reset_counts()
    metrics = [api.step(batch.images, batch) for _ in range(2)]
    torch.cuda.synchronize()
    counts = _counts()
    params = {n: p for n, p in api.model.named_parameters() if n.startswith(trainable_prefix)}
    moved = sum(not torch.equal(p.detach(), before[n]) for n, p in params.items())
    print(f"[api] {tag} two steps: step {api.state.step}, loss "
          f"{[round(float(m['loss']), 6) for m in metrics]}, grads_finite "
          f"{[float(m['grads_finite']) for m in metrics]}; {moved} of {len(params)} "
          f"'{trainable_prefix}' parameter tensors moved; launches {counts}")
    if (counts != _k1_only(6) or api.state.step != 2 or moved == 0
            or any(float(m["grads_finite"]) != 1.0 for m in metrics)):
        _fail(f"{tag}: two steps launched {counts}, step {api.state.step}, moved {moved}")


def _ragged_equal(a: dict, b: dict) -> list:
    """Names of the eval-dict entries that differ in any bit."""
    import torch
    differ = [k for k in ("vertice_index", "face_index", "mesh_index") if a[k] != b[k]]
    differ += [k for k in ("faces", "edge_index") if not np.array_equal(a[k], b[k])]
    if not all(np.array_equal(x, y) for x, y in zip(a["vertex_positions"],
                                                    b["vertex_positions"])):
        differ.append("vertex_positions")
    if not torch.equal(a["voxels"], b["voxels"]):
        differ.append("voxels")
    return differ


def _cli_checkpoint(root: str, model: str):
    import glob
    import torch
    paths = glob.glob(f"{root}/checkpoints/{model}/GCN/*/final.pt")
    if len(paths) != 1:
        _fail(f"phase_cli's {model} checkpoint not found: {paths}")
    return paths[0], torch.load(paths[0], map_location="cpu", weights_only=True)["settings"]


def _api_of(settings: dict, device: str):
    """A ShapeNetAPI / Pix3DAPI of a checkpoint's model settings."""
    from meshrcnn_tpu_torch.models.api import Pix3DAPI, ShapeNetAPI
    common = {k: settings[k] for k in ("cubify_threshold", "vertex_feature_dim",
                                       "num_refinement_stages", "voxel_only", "num_classes",
                                       "vert_capacity", "face_capacity", "edge_capacity")}
    if settings["model"] == "Pix3D":
        extra = {k: settings[k] for k in ("rpn_pre_nms_top_n", "rpn_post_nms_top_n",
                                          "roi_batch_size", "backbone_dtype",
                                          "mesh_feature_norm")}
        return Pix3DAPI(device=device, **common, **extra)
    return ShapeNetAPI(residual=settings["residual"], device=device, **common)


def phase_api(kernels, root: str):
    """The reference-style API (``models/api.py``) at full width:
    ``ShapeNetAPI`` at the bench recipe (residual, 48^3 voxels, capacities
    8192/16384/32768, B=3 at 137x137) and ``Pix3DAPI`` at the Pix3D recipe
    (B=4 at 224x224): the eval dict with every key and shape; the train-mode
    loss dict (K1 x 3, every parameter and buffer equal in every bit before
    and after); two ``step()``s (K1 x 3 each). Then ``load()`` of each
    ``phase_cli`` checkpoint into an API of its settings, whose eval dict must
    equal in every bit the forward of ``eval_model``'s model on the same
    checkpoint and images; and a tiny ShapeNetAPI and Pix3DAPI (float32) on the
    card against the CPU, the eval dicts within 1e-4 of scale."""
    import torch

    from meshrcnn_tpu_torch import harness
    from meshrcnn_tpu_torch.models.api import Pix3DAPI, ShapeNetAPI, to_ragged
    from meshrcnn_tpu_torch.parallel.train_step import create_train_state, make_eval_step
    from meshrcnn_tpu_torch.utils import cli
    from meshrcnn_tpu_torch.utils.checkpoint import load_state

    dev = torch.device("cuda")
    _, config, data = harness.shapenet_train_setup(1, "cpu")
    api = ShapeNetAPI(residual=True, config=config)
    api.eval()
    _reset_counts()
    _check_api_eval("ShapeNet", api(data[0].images), 3)
    if _counts() != WANT_NONE:
        _fail(f"ShapeNet API eval launched {_counts()}")
    api.train()
    _api_train_checks("ShapeNet", api, data[0], "refine")
    kernels["chamfer_nn_bidir"]["launches"] += 9

    _, config, data = harness.pix3d_train_setup(1, "cpu")
    api = Pix3DAPI(config=config)
    api.eval()
    _check_api_eval("Pix3D", api(data[0].images), 4, 3)
    api.train()
    _api_train_checks("Pix3D", api, data[0], "backbone.backbone.")
    kernels["chamfer_nn_bidir"]["launches"] += 9

    for model_name, images in (
            ("ShapeNet", harness.SyntheticBatch(np.random.RandomState(3)).images),
            ("Pix3D", harness.SyntheticPix3DBatch(np.random.RandomState(3)).images)):
        path, settings = _cli_checkpoint(root, model_name)
        api = _api_of(settings, "cuda").load(path).eval()
        got = api(images)
        model = cli.build_model(settings, dev)
        load_state(path, create_train_state(model, api.config), settings)
        out = make_eval_step(model)(torch.from_numpy(images).to(dev))
        stages, faces, edge_index, v_index, f_index = to_ragged(
            out.stage_verts, out.mesh, getattr(out, "mesh_valid", None))
        want = dict(voxels=out.voxels, vertex_positions=stages, faces=faces,
                    edge_index=edge_index, vertice_index=v_index, face_index=f_index,
                    mesh_index=[1] * images.shape[0])
        differ = []
        if model_name == "ShapeNet":
            if not torch.equal(got["backbone"], torch.softmax(out.logits, -1)):
                differ.append("backbone")
        else:
            det = out.detections
            want["mesh_index"] = det.valid.sum(1).tolist()
            for b, d in enumerate(got["backbone"]):
                for k, v in (("boxes", det.boxes), ("scores", det.scores),
                             ("labels", det.labels), ("valid", det.valid),
                             ("masks", out.mask_probs)):
                    if not np.array_equal(d[k], v[b].cpu().numpy()):
                        differ.append(f"backbone[{b}].{k}")
        differ += _ragged_equal(got, want)
        print(f"[api] {model_name} load() of {path.split('/checkpoints/')[1]} into an API of "
              f"its settings, eval dict against eval_model's model on 3 images: differing "
              f"{differ or 'none'}")
        if differ:
            _fail(f"{model_name}: the loaded API's eval dict differs in {differ}")

    _api_card_vs_cpu()


def _api_card_vs_cpu():
    """A tiny ShapeNetAPI and Pix3DAPI, float32, seed 1, on the card and on
    the CPU: the same eval dict within 1e-4 of scale (topology identical where
    cubify saw the same occupancy)."""
    import torch

    from meshrcnn_tpu_torch.models.api import Pix3DAPI, ShapeNetAPI

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0)) if b.size else 0.0

    tiny = dict(vert_capacity=512, face_capacity=1024, edge_capacity=2048)
    images = np.random.RandomState(0).rand(2, 48, 48, 3).astype(np.float32)
    outs = []
    for device in ("cpu", "cuda"):
        api = ShapeNetAPI(voxel_out_channels=8, seed=1, device=device, **tiny)
        api.model = _tiny_model().to(device)
        api.model.load_state_dict(ShapeNetAPI(voxel_out_channels=8, seed=1, device="cpu",
                                              **tiny).model.state_dict())
        outs.append(api.eval()(images))
    cpu, gpu = outs
    errs = {"backbone": rel(gpu["backbone"].cpu(), cpu["backbone"]),
            "voxels": rel(gpu["voxels"].cpu(), cpu["voxels"])}
    same = _ragged_equal(gpu, dict(cpu, vertex_positions=gpu["vertex_positions"],
                                   voxels=gpu["voxels"])) == []
    if same:
        errs["vertex_positions"] = max(rel(a, b) for a, b in zip(gpu["vertex_positions"],
                                                                 cpu["vertex_positions"]))
    print(f"[api] tiny ShapeNetAPI card vs cpu: topology identical {same}; "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    if not same or not all(e < 1e-4 for e in errs.values()):
        _fail("the tiny ShapeNetAPI's eval dict differs between the card and the CPU")

    images = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    kw = dict(voxel_out_channels=8, vert_capacity=256, face_capacity=512, edge_capacity=1024,
              rpn_pre_nms_top_n=64, rpn_post_nms_top_n=32, roi_batch_size=32, mask_rois=8,
              backbone_dtype="float32", seed=4)
    cpu, gpu = [Pix3DAPI(device=d, **kw).eval()(images) for d in ("cpu", "cuda")]
    same_det = all(np.array_equal(g["valid"], c["valid"]) and np.array_equal(g["labels"], c["labels"])
                   for g, c in zip(gpu["backbone"], cpu["backbone"]))
    if not same_det:
        _fail("the tiny Pix3DAPI's detections differ in validity or labels")
    errs = {"boxes px": max(float(np.abs(g["boxes"][g["valid"]] - c["boxes"][c["valid"]]).max(initial=0))
                            for g, c in zip(gpu["backbone"], cpu["backbone"])),
            "scores": max(rel(g["scores"][g["valid"]], c["scores"][c["valid"]])
                          for g, c in zip(gpu["backbone"], cpu["backbone"])),
            "masks": max(rel(g["masks"][g["valid"]], c["masks"][c["valid"]])
                         for g, c in zip(gpu["backbone"], cpu["backbone"])),
            "voxels": rel(gpu["voxels"].cpu(), cpu["voxels"])}
    same = _ragged_equal(gpu, dict(cpu, vertex_positions=gpu["vertex_positions"],
                                   voxels=gpu["voxels"])) == []
    if same:
        errs["vertex_positions"] = max(rel(a, b) for a, b in zip(gpu["vertex_positions"],
                                                                 cpu["vertex_positions"]))
    print(f"[api] tiny Pix3DAPI card vs cpu: {sum(cpu['mesh_index'])} meshes, topology "
          f"identical {same}; " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    ok = errs.pop("boxes px") <= 1e-3 and all(e < 1e-4 for e in errs.values())
    if not same or not ok:
        _fail("the tiny Pix3DAPI's eval dict differs between the card and the CPU")


def phase_demo(root: str):
    """``demo.run``, the demo below the image decode, on a synthetic ShapeNet
    image (137x137) and a Pix3D image (224x224), each with its ``phase_cli``
    checkpoint and the flags of that checkpoint's settings: one ``.npy`` and
    four ``.obj`` files a valid object, each OBJ read back equal to the eval
    forward's masked vertices and faces. No kernel launches (eval, no metrics)."""
    import os

    import torch

    from meshrcnn_tpu_torch import demo, harness
    from meshrcnn_tpu_torch.data.serialization import load_mesh

    for model_name, images in (
            ("ShapeNet", harness.SyntheticBatch(np.random.RandomState(4), B=1).images),
            ("Pix3D", harness.SyntheticPix3DBatch(np.random.RandomState(4), B=1).images)):
        path, s = _cli_checkpoint(root, model_name)
        flags = ["--model", model_name, "--imagePath", f"{model_name.lower()}.png",
                 "--savePath", os.path.join(root, "demo", model_name), "--modelPath", path,
                 "--threshold", repr(s["cubify_threshold"]), "--featDim",
                 str(s["vertex_feature_dim"]), "-nr", str(s["num_refinement_stages"]),
                 "--vert_capacity", str(s["vert_capacity"]), "--face_capacity",
                 str(s["face_capacity"]), "--edge_capacity", str(s["edge_capacity"])]
        if model_name == "Pix3D":
            flags += ["--img_size", "224"] + (["--mesh_feature_norm"]
                                              if s["mesh_feature_norm"] else [])
        elif s["residual"]:
            flags.append("--residual")
        _reset_counts()
        t0 = time.perf_counter()
        res = demo.run(demo.parser.parse_args(flags), images)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = res["out"]
        valid = (out.mesh_valid.cpu().numpy() if model_name == "Pix3D"
                 else np.ones(1, bool))
        objs = np.flatnonzero(valid).tolist()
        files = sorted(os.listdir(os.path.join(root, "demo", model_name)))
        stem = f"{model_name.lower()}"
        want = sorted([f"{stem}_voxel_obj{i}.npy" for i in objs]
                      + [f"{stem}_mesh_stage{s_}_obj_{i}.obj" for i in objs for s_ in range(4)])
        differ = []
        vmask, fmask = out.mesh.verts_mask.cpu().numpy(), out.mesh.faces_mask.cpu().numpy()
        faces = out.mesh.faces.cpu().numpy()
        for s_ in range(4):
            verts = out.stage_verts[s_].cpu().numpy()
            for i in objs:
                m = load_mesh(os.path.join(root, "demo", model_name,
                                           f"{stem}_mesh_stage{s_}_obj_{i}.obj"))
                if not (np.array_equal(m.vertices, verts[i][vmask[i]])
                        and np.array_equal(m.faces, faces[i][fmask[i]])):
                    differ.append(f"stage {s_} obj {i}")
        print(f"[demo] {model_name}: {len(objs)} valid objects, {len(files)} files in "
              f"{wall:.3f} s; OBJs differing from the eval forward: {differ or 'none'}; "
              f"launches {_counts()}")
        if files != want or differ or _counts() != WANT_NONE:
            _fail(f"{model_name} demo: files {files}, want {want}; differing {differ}")


def phase_bench(kernels, card: str):
    """``bench.main(["--model", "both"])`` in this process: every key of the
    record, none skipped under the default budget, 5 windows in each
    ``window_s``, K1 exactly 3 x 20 x 6 a train bench (the normal-term
    variant too), 4 x 26 and 5 x 26 for the ShapeNet and Pix3D evals. Prints
    the record beside the card's name and power limit."""
    import contextlib
    import io

    from meshrcnn_tpu_torch import bench

    per_bench = []

    def counted(fn):
        def run(*args, **kwargs):
            before = _counts()
            out = fn(*args, **kwargs)
            per_bench.append((fn.__name__, {k: v - before[k] for k, v in _counts().items()}))
            return out
        return run

    names = ("bench_shapenet", "bench_pix3d", "bench_shapenet_eval", "bench_pix3d_eval")
    originals = {n: getattr(bench, n) for n in names}
    buf = io.StringIO()
    try:
        for n in names:
            setattr(bench, n, counted(originals[n]))
        _reset_counts()
        with contextlib.redirect_stdout(buf):
            bench.main(["--model", "both"])
    finally:
        for n, fn in originals.items():
            setattr(bench, n, fn)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    record = json.loads(lines[-1])
    print(f"[bench] {card}: {lines[-1]}")
    keys = {"metric", "value", "unit", "vs_baseline", "flops_per_step", "achieved_tflops",
            "mfu_pct_vs_bf16_peak", "window_s", "bench_elapsed_s", "device", "power_limit_w",
            "pix3d_train_samples_per_sec", "pix3d_vs_baseline", "pix3d_window_s",
            "pix3d_flops_per_step", "pix3d_achieved_tflops", "pix3d_mfu_pct_vs_bf16_peak",
            "shapenet_eval_samples_per_sec", "shapenet_eval_s_per_batch",
            "pix3d_eval_samples_per_sec", "pix3d_eval_s_per_batch",
            "shapenet_with_normal_term_sps"}
    want = [("bench_shapenet", _k1_only(360)), ("bench_pix3d", _k1_only(360)),
            ("bench_shapenet_eval", _k1_only(104)), ("bench_pix3d_eval", _k1_only(130)),
            ("bench_shapenet", _k1_only(360))]
    print(f"[bench] launches a bench: {per_bench}; {len(lines)} records printed")
    if set(record) != keys:
        _fail(f"bench record keys differ: missing {sorted(keys - set(record))}, extra "
              f"{sorted(set(record) - keys)}")
    if len(record["window_s"]) != 5 or len(record["pix3d_window_s"]) != 5:
        _fail("a bench did not keep 5 windows")
    if per_bench != want:
        _fail(f"the benches launched {per_bench}, want {want}")
    numbers = keys - {"metric", "unit", "window_s", "pix3d_window_s", "device"}
    if not all(record[k] is not None and np.isfinite(record[k]) and record[k] >= 0
               for k in numbers) or not all(record[k] > 0 for k in (
                   "value", "pix3d_train_samples_per_sec", "shapenet_eval_samples_per_sec",
                   "pix3d_eval_samples_per_sec", "shapenet_with_normal_term_sps")):
        _fail(f"a bench number is not a positive finite number: {record}")
    kernels["chamfer_nn_bidir"]["launches"] += sum(c["chamfer_nn_bidir"] for _, c in per_bench)


def phase_train_backbone(kernels, root: str):
    """``python -m meshrcnn_tpu_torch.train_backbone`` of both models on the
    synthetic dataset (8 samples, B=4, one epoch): the backbone checkpoint
    written, ``load_backbone`` of it into a fresh ``ShapeNetModel`` /
    ``Pix3DModel`` with every backbone tensor loaded and none left fresh, then
    one step of the train CLI with ``--backbone_path`` on it (K1 x 3)."""
    import os

    import torch

    from meshrcnn_tpu_torch import train, train_backbone
    from meshrcnn_tpu_torch.models.pix3d import Pix3DModel
    from meshrcnn_tpu_torch.models.shapenet import ShapeNetModel
    from meshrcnn_tpu_torch.utils.torch_convert import load_backbone

    shapes = {"ShapeNet": ["--residual", "--vert_capacity", "8192", "--face_capacity", "16384",
                           "--edge_capacity", "32768"],
              "Pix3D": ["--img_size", "224", "--vert_capacity", "4096", "--face_capacity",
                        "8192", "--edge_capacity", "16384", "--optim", "SGD", "--lr", "0.02",
                        "--train_backbone"]}
    for model_name, B in (("ShapeNet", 4), ("Pix3D", 4)):
        _reset_counts()
        t0 = time.perf_counter()
        out = train_backbone.main(["--model", model_name, "--num_sampels", "8", "-b", str(B),
                                   "--nEpoch", "1", "--workers", "2", "--print_freq", "1",
                                   "--checkpoint_root", os.path.join(root, "bb")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meters = {k: m.history for k, m in out["meters"].items()}
        files = sorted(os.listdir(out["dir"]))
        fresh = (Pix3DModel() if model_name == "Pix3D" else ShapeNetModel()).cuda()
        n_loaded, n_fresh = load_backbone(fresh, out["checkpoints"][0],
                                          maskrcnn=model_name == "Pix3D")
        trained = out["model"].state_dict()
        sd = fresh.state_dict()
        differ = [k for k, v in trained.items() if not torch.equal(sd[f"backbone.{k}"], v)]
        print(f"[backbone] {model_name}: 2 steps of {B} in {wall:.3f} s; meters "
              f"{json.dumps(meters)}; {out['dir'].split('/bb/')[1]}: {files}; load_backbone "
              f"{n_loaded} loaded, {n_fresh} fresh of {len(trained)}, differing "
              f"{len(differ)}; launches {_counts()}")
        if (files != ["backbone_0.pt", "stats_0.st"] or (n_loaded, n_fresh) != (len(trained), 0)
                or differ or not all(np.isfinite(h).all() for h in meters.values())
                or _counts() != WANT_NONE):
            _fail(f"{model_name} backbone training: files {files}, loaded {n_loaded}/{n_fresh}")
        _reset_counts()
        res = train.main(["--model", model_name, "-b", str(B), "--num_sampels", str(B),
                          "--nEpoch", "1", "--workers", "2", "--num_devices", "1",
                          "--point_cloud_size", "10000", "--backbone_path",
                          out["checkpoints"][0], "--checkpoint_root",
                          os.path.join(root, "from_backbone")] + shapes[model_name])
        counts = _counts()
        sd = res["state"].model.state_dict()
        print(f"[backbone] {model_name} train CLI from the backbone: step {res['state'].step}, "
              f"grads_finite {res['meters']['grads_finite'].history}; launches {counts}")
        if res["state"].step != 1 or counts != _k1_only(3):
            _fail(f"{model_name}: the train CLI from the backbone took {res['state'].step} "
                  f"steps, launched {counts}")
        kernels["chamfer_nn_bidir"]["launches"] += 3


def phase_tools(kernels, root: str):
    """``download_dataset --render_meshes --build_manifest`` on a small binvox
    tree (the port's cubify on the card); ``point_cloud_f1`` on the card equal
    in every bit to its CPU result with one K2 launch (one K1 launch);
    ``profiling.time_this`` on a card tensor."""
    import os

    import torch

    from meshrcnn_tpu_torch import download_dataset
    from meshrcnn_tpu_torch.data.serialization import write_binvox
    from meshrcnn_tpu_torch.utils import metrics, profiling

    ds = os.path.join(root, "dataset")
    rng = np.random.RandomState(5)
    zz, yy, xx = np.mgrid[:32, :32, :32]
    for i, synset in enumerate(("02691156", "03001627", "04379243")):
        c = rng.uniform(10, 22, 3)
        grid = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < rng.uniform(30, 90)
        os.makedirs(os.path.join(ds, "ShapeNetVox32", synset, f"m{i}"))
        write_binvox(grid, os.path.join(ds, "ShapeNetVox32", synset, f"m{i}", "model.binvox"))
        png = os.path.join(ds, "ShapeNetRendering", synset, f"m{i}", "rendering")
        os.makedirs(png)
        for j in range(3):
            open(os.path.join(png, f"{j:02d}.png"), "wb").close()
    t0 = time.perf_counter()
    download_dataset.main(["--render_meshes", "--build_manifest", "--root", ds])
    wall = time.perf_counter() - t0
    objs = [os.path.join(d, f) for d, _, fs in os.walk(ds) for f in fs if f.endswith(".obj")]
    with open(os.path.join(ds, "shapenet.json")) as f:
        records = json.load(f)
    print(f"[tools] download_dataset: {len(objs)} meshes rendered, {len(records)} manifest "
          f"records in {wall:.3f} s")
    if len(objs) != 3 or len(records) != 9:
        _fail("download_dataset did not render 3 meshes and list 9 records")

    g = torch.Generator().manual_seed(6)
    p = torch.rand((10000, 3), generator=g)
    q = p + 0.05 * torch.randn((10000, 3), generator=g)
    cpu = metrics.point_cloud_f1(p, q, 0.1)
    _reset_counts()
    gpu = metrics.point_cloud_f1(p.cuda(), q.cuda(), 0.1)
    counts = _counts()
    print(f"[tools] point_cloud_f1 at 10k points: card {gpu}, cpu {cpu}; launches {counts}")
    if gpu != cpu or counts != dict(WANT_NONE, chamfer_nn_bidir=1, chamfer_sums_fused=1):
        _fail(f"point_cloud_f1 on the card {gpu} against the CPU {cpu}, launches {counts}")
    kernels["chamfer_nn_bidir"]["launches"] += 1
    kernels["chamfer_sums_fused"]["launches"] += 1

    log = {}

    @profiling.time_this(log=log)
    def card_work():
        return torch.ones((4096, 4096), device="cuda") @ torch.ones((4096, 4096), device="cuda")
    card_work()
    print(f"[tools] time_this on a card matmul: {log['card_work'][0] * 1e3:.3f} ms")
    if len(log["card_work"]) != 1 or not log["card_work"][0] > 0:
        _fail("time_this did not log the card's work")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        sys.exit(1)
    # the port's f32 reference numerics: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    card = timed(phase_build)
    kernels = timed(phase_kernels, card)
    timed(phase_nms)
    timed(phase_slice)
    timed(phase_train, kernels)
    timed(phase_pix3d_eval, kernels)
    timed(phase_eval_bit_equal)
    timed(phase_pix3d_train, kernels)
    timed(phase_estimator, kernels)
    timed(phase_single, kernels)
    with tempfile.TemporaryDirectory() as root:
        timed(phase_cli, kernels, root)
        timed(phase_api, kernels, root)
        timed(phase_demo, root)
        timed(phase_dp, kernels, card, root)
        timed(phase_bench, kernels, card)
        timed(phase_train_backbone, kernels, root)
        timed(phase_tools, kernels, root)
    timed(phase_small_card_vs_cpu)
    timed(phase_small_pix3d_card_vs_cpu)
    timed(phase_small_train_card_vs_cpu)
    timed(phase_small_pix3d_train_card_vs_cpu)
    timed(phase_small_backward_card_vs_cpu)

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
