"""Row gathers of the port (counterpart of meshrcnn_tpu/ops/gather.py).

``batched_gather_rows`` is ``torch.gather`` along the row axis, so its
backward is a ``scatter_add_`` (atomic adds on the card). Advanced indexing
(``x[bidx, idx]``) computes the same forward, but its backward is PyTorch's
sort-based ``indexing_backward_kernel``, which serialises repeated indices:
on the H100 it took 160 ms of a 240 ms full-width train step, most of it in
``vert_align``, whose thousands of vertices read a few feature-map cells.
"""
from __future__ import annotations

import torch


def batched_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, M] int -> [B, M, ...] with out[b, m] = x[b, idx[b, m]]."""
    B, N = x.shape[:2]
    flat = x.reshape(B, N, -1)
    out = torch.gather(flat, 1, idx.long()[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape((B, idx.shape[1]) + x.shape[2:])
