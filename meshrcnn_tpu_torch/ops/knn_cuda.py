"""K3 and K4: kNN from subtile-min candidates with the k best kept on chip, and
their plain twins.

Counterpart of ``meshrcnn_tpu/ops/chamfer_pallas.py``'s
``knn_candidates_pallas_batched`` (K3) and ``knn_candidates_pallas`` (K4, here
a B=1 launch of K3's kernel) together with the ``lax.top_k`` merge that follows
them in ``meshrcnn_tpu/ops/chamfer.py``. The kernel is CUDA C++ for ``sm_90a``
in ``meshrcnn_tpu_torch/csrc/knn_topk.cu``; its source note says what bounds it
and how it is laid out. ``ops/cuda_build.py`` builds it on first use.

Contract: p [B,N,3] and q [B,M,3] float32, a subtile s and k give ``dists``
[B,N,k] float32 ascending and ``idx`` [B,N,k] int32: the k smallest of the
C = ceil(M/s) candidates of each point. Candidate g is the min squared distance
from p_i to the run q[g*s : (g+1)*s) and its argmin, ties to the first minimum,
the ragged last run cut at M. Equal candidates keep the order of their runs; a
point with fewer than k candidates repeats its last. The Pallas kernel pads q
to a multiple of its 512-point tile with far-away points, which adds
candidates that never win; the port has no padding candidates. ``s`` must
divide the kernel's 256-point tile and be at least 4; k is at most ``MAX_K``.

``knn_topk_batched`` is the wrapper: for a CUDA tensor it launches the kernel
or raises, and it runs the plain twin ``knn_topk_plain`` only for tensors on
the CPU. Its ``launches`` counts kernel launches; ``knn_topk.launches`` those
of them made for K4 (it adds the change of ``knn_topk_batched.launches``).
``knn_candidates_plain`` is the candidate stage of the twin alone, the form
the Pallas kernel's output is held against. Neighbour selection is not
differentiated: its outputs carry no gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from meshrcnn_tpu_torch.ops import cuda_build
from meshrcnn_tpu_torch.ops.chamfer_cuda import _check, sm_count

SOURCE = cuda_build.CSRC / "knn_topk.cu"
TILE = 256                 # TILE in the CUDA source: q points a shared-memory tile
MAX_K = 64                 # the largest list the CUDA source instantiates
BLOCKS_PER_SM = 8          # blocks the plan aims at, to fill the card at any B
PLAIN_TILE = 2048          # q points per step of the plain twin (a multiple of s)
# (largest k, query points a block) of the sweeps the CUDA source instantiates
_FORMS = ((10, 128), (16, 128), (MAX_K, 64))


class TopkPlan(NamedTuple):
    """The kernel's launch: grid (query blocks, spans, B); every span but the last
    holds ``span`` points of q, a multiple of TILE; ``scratch`` 64-bit words of
    partial lists ([spans, B, k, N])."""
    grid: Tuple[int, int, int]
    span: int
    scratch: int


def topk_plan(B: int, N: int, M: int, k: int, sms: int) -> TopkPlan:
    """Cut the q range into spans of whole tiles so that about ``BLOCKS_PER_SM``
    blocks an SM are in flight. A run of s points (s divides TILE) never
    straddles two spans."""
    per_block = next(q for cap, q in _FORMS if k <= cap)
    query_blocks = -(-N // per_block)
    tiles = -(-M // TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sms // (query_blocks * B))))
    span_tiles = -(-tiles // want)
    spans = -(-tiles // span_tiles)
    return TopkPlan((query_blocks, spans, B), span_tiles * TILE, spans * B * k * N)


@functools.lru_cache(maxsize=None)
def _kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("knn_topk", {
        "knn_topk": [vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]}).knn_topk


def _check_subtile_and_k(s: int, k: int) -> None:
    if s < 4 or TILE % s:
        raise ValueError(f"subtile {s} must be at least 4 and divide the kernel's tile of {TILE}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} is outside 1..{MAX_K}, the largest list the kernel keeps")


def _launch(p: torch.Tensor, q: torch.Tensor, s: int, k: int):
    if p.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {p.device}")
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    plan = topk_plan(B, N, M, k, sm_count(p.device.index))
    # the partial lists are freed on return; the results (distances, then
    # indices) share one allocation
    part = torch.empty(plan.scratch, dtype=torch.int64, device=p.device)
    out = torch.empty(2 * B * N * k, dtype=torch.int32, device=p.device)
    dists, idx = out[:B * N * k].view(torch.float32), out[B * N * k:]
    with torch.cuda.device(p.device):
        err = _kernel()(p.data_ptr(), q.data_ptr(), B, N, M, s, k, plan.grid[0],
                                 plan.grid[1], plan.span, part.data_ptr(),
                                 dists.data_ptr(), idx.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    knn_topk_batched.launches += 1
    return dists.view(B, N, k), idx.view(B, N, k)


def knn_topk_batched(p: torch.Tensor, q: torch.Tensor, subtile: int, k: int):
    """K3: p [B,N,3], q [B,M,3] float32 -> (dists [B,N,k] float32 ascending,
    idx [B,N,k] int32). CUDA tensors launch the kernel; CPU tensors take
    ``knn_topk_plain``."""
    _check(p, q)
    _check_subtile_and_k(subtile, k)
    if p.device.type == "cpu":
        return knn_topk_plain(p, q, subtile, k)
    return _launch(p, q, subtile, k)


knn_topk_batched.launches = 0


def knn_topk(p: torch.Tensor, q: torch.Tensor, subtile: int, k: int):
    """K4: p [N,3], q [M,3] -> (dists [N,k], idx [N,k]), a B=1 call of K3. Its
    ``launches`` adds the K3 launches this call made."""
    before = knn_topk_batched.launches
    dists, idx = knn_topk_batched(p[None], q[None], subtile, k)
    knn_topk.launches += knn_topk_batched.launches - before
    return dists[0], idx[0]


knn_topk.launches = 0


def knn_candidates_plain(p: torch.Tensor, q: torch.Tensor, s: int):
    """The candidates of every point, (vals [B,N,C] float32, idx [B,N,C] int32),
    in plain PyTorch.

    Tiled over q in steps of ``PLAIN_TILE`` points; each step's difference-form
    distances [B,N,T] are viewed [B,N,T/s,s] (the ragged last run padded with
    +inf) and reduced with ``min``, whose argmin is the first minimum.
    """
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    step = max(PLAIN_TILE // s, 1) * s
    vals, idx = [], []
    for start in range(0, M, step):
        qt = q[:, start:start + step]
        dx = p[:, :, None, 0] - qt[:, None, :, 0]
        dy = p[:, :, None, 1] - qt[:, None, :, 1]
        dz = p[:, :, None, 2] - qt[:, None, :, 2]
        d = dx * dx + dy * dy + dz * dz                       # [B, N, T]
        T = d.shape[2]
        G = -(-T // s)
        if G * s > T:
            d = torch.nn.functional.pad(d, (0, G * s - T), value=float("inf"))
        v, a = torch.min(d.view(B, N, G, s), dim=3)
        base = start + s * torch.arange(G, device=p.device)
        vals.append(v)
        idx.append(a + base)
    return torch.cat(vals, 2), torch.cat(idx, 2).to(torch.int32)


def smallest_k_stable(d: torch.Tensor, k: int):
    """The k smallest entries of each row of d, ascending, and their positions
    (int64); equal entries keep their order (a stable sort), and a row with
    fewer than k entries repeats its last (the JAX package's rule)."""
    vals, pos = torch.sort(d, dim=-1, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    if vals.shape[-1] < k:
        rep = k - vals.shape[-1]
        vals = torch.cat([vals, vals[..., -1:].expand(*vals.shape[:-1], rep)], -1)
        pos = torch.cat([pos, pos[..., -1:].expand(*pos.shape[:-1], rep)], -1)
    return vals, pos


def knn_topk_plain(p: torch.Tensor, q: torch.Tensor, s: int, k: int):
    """The kernel's function in plain PyTorch (its oracle on the card):
    ``knn_candidates_plain``, then a stable ascending selection of k."""
    vals, cand = knn_candidates_plain(p, q, s)
    top, pos = smallest_k_stable(vals, k)
    return top, torch.gather(cand, -1, pos)
