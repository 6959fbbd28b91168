"""Neighbour aggregation over padded edge lists, the GraphConv primitive
(counterpart of meshrcnn_tpu/ops/graph_conv.py; reference: meshRCNN/utils.py:52-97).

The undirected neighbour sum out[v] = sum over edges (v, u) of feats[u] runs
over the batch flattened to [B*V, C]. ``precompute_adjacency`` keeps only the
valid edges, as flat (destination, source) rows in both directions, sorted by
destination with a stable sort, and the CSR row offsets of that order; it runs
once per cubify output and every GraphConv of the forward reuses it. Padded
edges are dropped there, so they contribute nothing.

The sum of each destination's segment is ``torch.segment_reduce``: one thread
adds a row's neighbours in the sorted order, so the result is the same bits
from run to run on the card (an ``index_add_`` of float rows is not: its
atomic adds land in any order). The edge set is symmetric, so the aggregation
is A x with A = A^T, and its backward is the same aggregation of the
cotangent; ``_Aggregate`` says so, since ``index_select``'s own backward would
be an atomic ``index_add_`` again.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EdgeTopology:
    """Valid edges of a padded batch, both directions, as CSR rows of [B*V, C]:
    row r's neighbours are src[offsets[r]:offsets[r+1]], in edge-list order."""
    src: torch.Tensor       # [2*E_valid] int64
    offsets: torch.Tensor   # [B*V + 1] int64, non-decreasing


def precompute_adjacency(edges: torch.Tensor, edges_mask: torch.Tensor,
                         num_vertices: int) -> EdgeTopology:
    """Build the aggregation plan of edges [B,E,2] with edges_mask [B,E]."""
    b, e = torch.nonzero(edges_mask, as_tuple=True)
    base = b * num_vertices
    lo = base + edges[b, e, 0].long()
    hi = base + edges[b, e, 1].long()
    dst, src = torch.cat([lo, hi]), torch.cat([hi, lo])
    order = torch.sort(dst, stable=True).indices
    rows = edges_mask.shape[0] * num_vertices
    offsets = torch.zeros(rows + 1, dtype=torch.int64, device=dst.device)
    offsets[1:] = torch.cumsum(torch.bincount(dst, minlength=rows), 0)
    return EdgeTopology(src=src[order], offsets=offsets)


def _segment_sum(flat: torch.Tensor, topo: EdgeTopology) -> torch.Tensor:
    """[B*V, C] -> [B*V, C]: each row's neighbour rows summed in ``topo``'s order."""
    return torch.segment_reduce(flat.index_select(0, topo.src), "sum",
                                offsets=topo.offsets, axis=0, unsafe=True)


class _Aggregate(torch.autograd.Function):
    """A x for the symmetric adjacency A of ``topo``; the VJP is A g."""

    @staticmethod
    def forward(ctx, flat, topo):
        ctx.topo = topo
        return _segment_sum(flat, topo)

    @staticmethod
    def backward(ctx, grad):
        return _segment_sum(grad.contiguous(), ctx.topo), None


def aggregate_neighbours(feats: torch.Tensor, topo: EdgeTopology) -> torch.Tensor:
    """Batched undirected neighbour feature sum: [B, V, C] -> [B, V, C]."""
    B, V, C = feats.shape
    return _Aggregate.apply(feats.reshape(B * V, C), topo).reshape(B, V, C)
