"""Neighbour aggregation over padded edge lists, the GraphConv primitive
(counterpart of meshrcnn_tpu/ops/graph_conv.py; reference: meshRCNN/utils.py:52-97).

The undirected neighbour sum out[v] = sum over edges (v, u) of feats[u] is one
``index_add_`` over the batch flattened to [B*V, C]. ``precompute_adjacency``
keeps only the valid edges, as flat (destination, source) rows in both
directions, once per cubify output; every GraphConv of the forward reuses it.
Padded edges are dropped there, so they contribute nothing.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EdgeTopology:
    """Valid edges of a padded batch as flat row indices into [B*V, C], both directions."""
    dst: torch.Tensor   # [2*E_valid] int64
    src: torch.Tensor   # [2*E_valid] int64


def precompute_adjacency(edges: torch.Tensor, edges_mask: torch.Tensor,
                         num_vertices: int) -> EdgeTopology:
    """Build the aggregation plan of edges [B,E,2] with edges_mask [B,E]."""
    b, e = torch.nonzero(edges_mask, as_tuple=True)
    base = b * num_vertices
    lo = base + edges[b, e, 0].long()
    hi = base + edges[b, e, 1].long()
    return EdgeTopology(dst=torch.cat([lo, hi]), src=torch.cat([hi, lo]))


def aggregate_neighbours(feats: torch.Tensor, topo: EdgeTopology) -> torch.Tensor:
    """Batched undirected neighbour feature sum: [B, V, C] -> [B, V, C]."""
    B, V, C = feats.shape
    flat = feats.reshape(B * V, C)
    out = torch.zeros_like(flat)
    out.index_add_(0, topo.dst, flat.index_select(0, topo.src))
    return out.reshape(B, V, C)
