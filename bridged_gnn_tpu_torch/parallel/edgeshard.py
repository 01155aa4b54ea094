"""The edge-shard layout: edges split over ranks, node arrays replicated.

Port of ``bridged_gnn_tpu/parallel/edgeshard.py``. The dst-sorted edge
array is padded to a multiple of ``n·128`` (:func:`pad_graph_edges_for_
sharding`) and split into ``n`` equal contiguous spans, one per rank;
node arrays (features, masks, parameters) stay whole on every rank. Each
rank reduces its span per destination and the partials are all-reduced:
for KT-GNN's attention the softmax's maximum (MAX), its denominator and
the aggregate (SUM), ``ops/segment.py`` with a ``group``. No kernel is on
this path, in the JAX package (its ``ops/segment.segment_sum``) as in
the port (``ops/segment.py``'s plain PyTorch). More wire bytes than the
halo layout (three [N_pad, ·] all-reduces per conv,
``halopart.wire_bytes_per_layer``) and no partition to build.
"""

from __future__ import annotations

from typing import Optional

import torch

from bridged_gnn_tpu_torch.graph import Graph, round_up
from bridged_gnn_tpu_torch.ops.segment import segment_sum
from bridged_gnn_tpu_torch.ops.spmm import Adjacency


def pad_graph_edges_for_sharding(g: Graph, n_shards: int) -> Graph:
    """Pad the edge arrays so their length divides into ``n_shards``
    spans of whole 128-edge blocks (dst-sorted order kept; the extra
    edges are masked and point at the last node)."""
    e_pad = g.num_edges_padded
    extra = round_up(e_pad, n_shards * 128) - e_pad
    if extra == 0:
        return g
    fill = g.num_nodes_padded - 1

    def pad_e(a, value):
        return torch.cat([a, a.new_full((extra,), value)])

    return g.replace(senders=pad_e(g.senders, fill),
                     receivers=pad_e(g.receivers, fill),
                     edge_mask=pad_e(g.edge_mask, False))


def edge_span(g: Graph, n_shards: int, rank: int) -> slice:
    """Rank ``rank``'s span of ``g``'s (padded) edge array."""
    per = g.num_edges_padded // n_shards
    return slice(rank * per, (rank + 1) * per)


def shard_adjacency(g: Graph, n_shards: int, rank: int, group) -> Adjacency:
    """The gather adjacency of rank ``rank``'s edge span, its destination
    reductions all-reduced over ``group``; the in-degrees are those of
    the whole graph. ``g`` comes from :func:`pad_graph_edges_for_
    sharding`."""
    span = edge_span(g, n_shards, rank)
    in_degree = torch.zeros(g.num_nodes_padded, device=g.x.device)
    in_degree.index_add_(0, g.receivers.long(), g.edge_mask.float())
    return Adjacency(
        num_nodes=g.num_nodes, num_nodes_padded=g.num_nodes_padded,
        senders=g.senders[span], receivers=g.receivers[span],
        edge_mask=g.edge_mask[span], in_degree=in_degree, group=group)


def sharded_spmm(adj: Adjacency, x: torch.Tensor,
                 edge_weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Edge-sharded SpMM (sum) on a :func:`shard_adjacency`: this rank's
    gather and segment sum, all-reduced over ``adj.group``
    (``[num_nodes_padded, D]``). ``edge_weights`` [span] per edge of the
    rank's span, or None."""
    msg = x[adj.senders.long()]
    if edge_weights is not None:
        msg = msg * edge_weights[:, None].to(msg.dtype)
    return segment_sum(msg, adj.receivers, adj.num_nodes_padded,
                       mask=adj.edge_mask, group=adj.group)
