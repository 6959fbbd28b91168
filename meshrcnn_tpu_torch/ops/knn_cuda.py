"""K3 and K4: subtile-min kNN candidates, and their plain twin.

Counterpart of ``meshrcnn_tpu/ops/chamfer_pallas.py``'s
``knn_candidates_pallas_batched`` (K3) and ``knn_candidates_pallas`` (K4, here
a B=1 launch of K3's kernel). The kernel is CUDA C++ for ``sm_90a`` in
``meshrcnn_tpu_torch/csrc/knn_candidates.cu``; its source note says what
bounds it and how it is laid out. ``ops/cuda_build.py`` builds it on first use.

Contract: p [B,N,3] and q [B,M,3] float32 and a subtile s give ``vals`` and
``idx`` [B,N,C], C = ceil(M/s): entry (b,i,g) is the min squared distance from
p_i to the run q[g*s : (g+1)*s) and its argmin, ties to the first minimum, the
ragged last run cut at M. The Pallas kernel pads q to a multiple of its
512-point tile with far-away points, which adds candidates that never win; the
port has no padding candidates. ``s`` must divide the kernel's 256-point tile.

``knn_candidates_batched`` is the wrapper: for a CUDA tensor it launches the
kernel or raises, and it runs the plain twin ``knn_candidates_plain`` only for
tensors on the CPU. Its ``launches`` counts kernel launches;
``knn_candidates.launches`` those of them made for K4 (it adds the change of
``knn_candidates_batched.launches``). Candidate selection is not
differentiated: its outputs carry no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from meshrcnn_tpu_torch.ops import cuda_build
from meshrcnn_tpu_torch.ops.chamfer_cuda import _check, _splits

SOURCE = cuda_build.CSRC / "knn_candidates.cu"
_QUERIES_PER_BLOCK = 512   # THREADS * QPT in the CUDA source
_TILE = 256                # TILE in the CUDA source
PLAIN_TILE = 2048          # q points per step of the plain twin (a multiple of s)


def _library() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("knn_candidates", {
        "knn_candidates": [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]})


def _check_subtile(s: int) -> None:
    if s <= 0 or _TILE % s:
        raise ValueError(f"subtile {s} must divide the kernel's tile of {_TILE}")


def _launch(p: torch.Tensor, q: torch.Tensor, s: int):
    if p.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors, got {p.device}")
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    C = -(-M // s)
    splits = _splits(B * -(-N // _QUERIES_PER_BLOCK), M, p.device)
    vals = torch.empty((B, C, N), dtype=torch.float32, device=p.device)
    idx = torch.empty((B, C, N), dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = _library().knn_candidates(p.data_ptr(), q.data_ptr(), B, N, M, s, splits,
                                        vals.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    knn_candidates_batched.launches += 1
    return vals.transpose(1, 2), idx.transpose(1, 2)


def knn_candidates_batched(p: torch.Tensor, q: torch.Tensor, subtile: int):
    """K3: p [B,N,3], q [B,M,3] float32 -> (vals [B,N,C] float32, idx [B,N,C] int32).

    CUDA tensors launch the kernel (the results are transposed views of its
    candidate-major output); CPU tensors take ``knn_candidates_plain``.
    """
    _check(p, q)
    _check_subtile(subtile)
    if p.device.type == "cpu":
        return knn_candidates_plain(p, q, subtile)
    return _launch(p, q, subtile)


knn_candidates_batched.launches = 0


def knn_candidates(p: torch.Tensor, q: torch.Tensor, subtile: int):
    """K4: p [N,3], q [M,3] -> (vals [N,C], idx [N,C]), a B=1 call of K3. Its
    ``launches`` adds the K3 launches this call made."""
    before = knn_candidates_batched.launches
    vals, idx = knn_candidates_batched(p[None], q[None], subtile)
    knn_candidates.launches += knn_candidates_batched.launches - before
    return vals[0], idx[0]


knn_candidates.launches = 0


def knn_candidates_plain(p: torch.Tensor, q: torch.Tensor, s: int):
    """The kernel's function in plain PyTorch (its oracle on the card).

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
