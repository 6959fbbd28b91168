"""K1 and K2: bidirectional nearest neighbour, its plain twin and the chamfer sums.

Counterpart of ``meshrcnn_tpu/ops/chamfer_pallas.py``'s batched path
(``_chamfer_bidir_pallas_batched``, ``_exact_sums_batched`` and the forward of
``chamfer_sums_fused_batched``) and of its single-sample form
(``_chamfer_bidir_pallas`` behind ``chamfer_sums_fused``: K2, a B=1 launch of
the same kernel). The kernel is CUDA C++ for ``sm_90a`` in
``meshrcnn_tpu_torch/csrc/chamfer_nn.cu``; its source note says what bounds it
and how it is laid out. ``ops/cuda_build.py`` builds it on first use.

``nn_bidir`` is the wrapper. For a CUDA tensor it launches the kernel or
raises; it runs the plain twin ``nn_bidir_plain`` only for tensors on the CPU.
A launch is one sweep over the 128 x 256 tile pairs of ``sweep_plan`` (every
distance computed once, for both directions) and a small kernel that resolves
the packed keys the sweep leaves to (distance, index).
``nn_bidir.launches`` counts kernel launches, ``chamfer_sums_fused.launches``
those of them made for K2 (it adds the change of ``nn_bidir.launches``).

Gradients: the sums are recomputed from the kernel's integer indices with
``torch.gather``, so autograd of ``exact_sums_batched`` with the indices fixed
is the closed-form backward of the JAX package (``_bwd_batched``: gathers plus
a segment sum, which is gather's backward, a scatter-add). No
``autograd.Function`` is needed; tests/test_torch_train_step.py holds the gradients
to ``_bwd_batched``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from meshrcnn_tpu_torch.ops import cuda_build
from meshrcnn_tpu_torch.ops.gather import batched_gather_rows

SOURCE = cuda_build.CSRC / "chamfer_nn.cu"
TILE_P = 128               # TILE_P and TILE_Q in the CUDA source: the points of p
TILE_Q = 256               # and of q in a block's tile pair
PLAIN_TILE = 2048          # reference points per step of the plain twin


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked for once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("chamfer_nn", {
        "chamfer_nn_bidir": [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]}).chamfer_nn_bidir


def _check(p: torch.Tensor, q: torch.Tensor) -> None:
    for name, t in (("p", p), ("q", q)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, n, 3], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p.device != q.device:
        raise ValueError(f"p on {p.device} and q on {q.device}")
    if p.shape[0] != q.shape[0]:
        raise ValueError(f"batch sizes differ: {p.shape[0]} vs {q.shape[0]}")
    if p.shape[1] == 0 or q.shape[1] == 0:
        raise ValueError("both clouds need at least one point")


def sweep_plan(B: int, N: int, M: int):
    """The kernel's launch: (grid, 64-bit key words of scratch). Block (a, b, z)
    of the grid holds rows [a*TILE_P, min((a+1)*TILE_P, N)) of p against columns
    [b*TILE_Q, min((b+1)*TILE_Q, M)) of q in sample z; the shape does not depend
    on the card or on B."""
    return (-(-N // TILE_P), -(-M // TILE_Q), B), B * (N + M)


def _launch(p: torch.Tensor, q: torch.Tensor):
    if p.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {p.device}")
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    grid, words = sweep_plan(B, N, M)
    # one allocation: the keys, then distances and indices of both sides
    buf = torch.empty(2 * words, dtype=torch.int64, device=p.device)
    out = buf[words:].view(torch.int32)
    d, idx = out[:words].view(torch.float32), out[words:]
    with torch.cuda.device(p.device):
        err = _kernel()(p.data_ptr(), q.data_ptr(), B, N, M, grid[0], grid[1],
                        buf.data_ptr(), d.data_ptr(), idx.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    nn_bidir.launches += 1
    return (d[:B * N].view(B, N), idx[:B * N].view(B, N),
            d[B * N:].view(B, M), idx[B * N:].view(B, M))


def nn_bidir(p: torch.Tensor, q: torch.Tensor):
    """p [B,N,3], q [B,M,3] float32 -> (d_p [B,N], i_p [B,N] int32, d_q [B,M], i_q [B,M] int32).

    Min squared distance and argmin both ways, ties to the lowest index. CUDA
    tensors launch the kernel; CPU tensors take ``nn_bidir_plain``.
    """
    _check(p, q)
    if p.device.type == "cpu":
        return nn_bidir_plain(p, q)
    return _launch(p, q)


nn_bidir.launches = 0


def nn_one_way(p: torch.Tensor, q: torch.Tensor):
    """Plain tiled nearest neighbour of p [B,N,3] into q [B,M,3] -> (d [B,N], idx [B,N] int32).

    Difference form with the kernel's operation order, first-occurrence argmin
    inside a tile and strict ``<`` across tiles, so ties go to the lowest index.
    A NaN distance reads as +inf and never wins; a point with no distance below
    +inf gets (+inf, 0), as in the kernel.
    """
    B, N = p.shape[0], p.shape[1]
    best = torch.full((B, N), float("inf"), dtype=torch.float32, device=p.device)
    arg = torch.zeros((B, N), dtype=torch.int64, device=p.device)
    for start in range(0, q.shape[1], PLAIN_TILE):
        qt = q[:, start:start + PLAIN_TILE]
        dx = p[:, :, None, 0] - qt[:, None, :, 0]
        dy = p[:, :, None, 1] - qt[:, None, :, 1]
        dz = p[:, :, None, 2] - qt[:, None, :, 2]
        d = dx * dx + dy * dy + dz * dz                       # [B, N, T]
        d = torch.where(torch.isnan(d), float("inf"), d)
        tmin, targ = torch.min(d, dim=2)
        take = tmin < best
        best = torch.where(take, tmin, best)
        arg = torch.where(take, targ + start, arg)
    return best, arg.to(torch.int32)


def nn_bidir_plain(p: torch.Tensor, q: torch.Tensor):
    """The kernel's function in plain PyTorch (its oracle on the card)."""
    d_p, i_p = nn_one_way(p, q)
    d_q, i_q = nn_one_way(q, p)
    return d_p, i_p, d_q, i_q


def exact_sums_batched(p, q, i_p, i_q):
    """Per-sample chamfer sums recomputed in difference form from the indices
    (``_exact_sums_batched``): [B] sum_i |p_i - q_{i_p}|^2 and [B] sum_j |q_j - p_{i_q}|^2."""
    qa = batched_gather_rows(q, i_p)
    pa = batched_gather_rows(p, i_q)
    return ((p - qa) ** 2).sum(-1).sum(1), ((q - pa) ** 2).sum(-1).sum(1)


def chamfer_sums_batched(p: torch.Tensor, q: torch.Tensor):
    """(sum_p [B], idx_p [B,N], sum_q [B], idx_q [B,M]) through K1; the forward of
    ``chamfer_sums_fused_batched``. K1 takes float32: clouds of another dtype
    (float64 in the card-vs-CPU backward checks) take their indices from K1 on
    their float32 casts, and their sums, and so the gradient, in their own dtype."""
    _, i_p, _, i_q = nn_bidir(p.detach().float(), q.detach().float())
    s_p, s_q = exact_sums_batched(p, q, i_p, i_q)
    return s_p, i_p, s_q, i_q


def chamfer_sums_fused(p: torch.Tensor, q: torch.Tensor):
    """K2: (sum_p, idx_p [N], sum_q, idx_q [M]) for one cloud pair p [N,3], q [M,3],
    a B=1 call of ``chamfer_sums_batched``. Its ``launches`` adds the K1 launches
    this call made."""
    before = nn_bidir.launches
    s_p, i_p, s_q, i_q = chamfer_sums_batched(p[None], q[None])
    chamfer_sums_fused.launches += nn_bidir.launches - before
    return s_p[0], i_p[0], s_q[0], i_q[0]


chamfer_sums_fused.launches = 0
