"""Placements of a graph over a process group's ranks.

Port of ``bridged_gnn_tpu/parallel/gspmd.py``. The JAX package places
arrays with ``NamedSharding`` and lets XLA's partitioner insert the
collectives into the unmodified step. The port has no partitioner: each
placement here is what a rank holds, and the model code takes the
collectives explicitly.

Stage 2, the edge-span placement (:func:`shard_graph`,
:func:`gspmd_setup`): the edge arrays padded so that they split into one
span of whole 128-edge blocks per rank, the node arrays whole on every
rank, and the gather adjacency of this rank's span, its destination
reductions all-reduced over the group. It is the edge-shard layout's
(``parallel/edgeshard.py``): ``Stage2Config(shard_layout="edgeshard")``
places its graph with :func:`gspmd_setup`.

Stage 1, the node-row placement (:func:`repad_graph_nodes`,
:func:`shard_stage1_graph`): both domain graphs repadded so that their
rows split evenly, and each rank given a block of rows
(:class:`RowShard`): its features and node mask and, for the ``gnn``
backbone, the slot layout of the edges into its rows over every sender
row, on which the SAGE aggregation runs the padded SpMM kernel. The
encoders run on the rank's rows; a conv's input rows are all-gathered
(``parallel/collectives.py::all_gather_rows``), PairNorm takes global
moments, and the final embeddings are all-gathered into whole tables
that every rank scores alike. The features themselves stay whole on
every rank with the rest of the graph (the loss reads its labels and
masks); what the placement divides is the encoders' activations, their
width times the rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.graph import NODE_BLOCK, Graph, round_up
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, build_adjacency
from bridged_gnn_tpu_torch.parallel.collectives import all_gather_rows
from bridged_gnn_tpu_torch.parallel.edgeshard import (
    pad_graph_edges_for_sharding,
    shard_adjacency,
)

# ------------------------------------------------------------------ stage 2


def shard_graph(g: Graph, n_shards: int) -> Graph:
    """``g`` with its edge arrays padded to ``n_shards`` spans of whole
    128-edge blocks (JAX ``shard_graph``): every rank holds this graph
    and reads its own span of the edges."""
    return pad_graph_edges_for_sharding(g, n_shards)


def gspmd_setup(group, g: Graph, device="cuda") -> Tuple[Graph, Adjacency]:
    """This rank's (graph, adjacency) of the edge-span placement (JAX
    ``gspmd_setup``): the graph on ``device`` with every node array and
    the padded edge arrays, and the gather adjacency of the rank's span,
    which a model's aggregations all-reduce over ``group``."""
    g = shard_graph(g, dist.get_world_size(group)).to(device)
    return g, shard_adjacency(g, dist.get_world_size(group),
                              dist.get_rank(group), group)


# ------------------------------------------------------------------ stage 1


def repad_graph_nodes(g: Graph, multiple: int) -> Graph:
    """``g`` with its node padding extended so that ``num_nodes_padded``
    is a multiple of ``multiple`` (JAX ``repad_graph_nodes``): the new
    rows are pure padding (node mask False, ``y = -1``); padded edges
    keep pointing at the old last padded row, still a masked padding
    row, so every aggregation is unchanged."""
    n_pad = g.num_nodes_padded
    extra = round_up(n_pad, multiple) - n_pad
    if extra == 0:
        return g

    def ext(a, fill):
        return torch.cat([a, a.new_full((extra,) + tuple(a.shape[1:]),
                                        fill)])

    return g.replace(
        x=ext(g.x, 0), y=ext(g.y, -1), node_mask=ext(g.node_mask, False),
        train_mask=ext(g.train_mask, False),
        val_mask=ext(g.val_mask, False), test_mask=ext(g.test_mask, False),
        central_mask=ext(g.central_mask, False))


@dataclasses.dataclass
class RowShard:
    """One rank's block of a domain graph's rows, which the stage-1
    encoders take as ``shard=`` (``nn/stage1.py``): rows ``[rank·rows,
    (rank+1)·rows)`` of the repadded graph.

    ``num_rows_whole`` is the unsharded graph's padded row count: the
    gathered tables are cut to it, so that everything after the encoders
    (the heads' batch norms over every row, the losses) sees the single
    device's tables, and dropout draws the single device's ``[rows,
    width]`` mask from the generator every rank holds in one state, each
    rank keeping its rows: the masks are the single device's bit for
    bit."""

    group: object
    rank: int
    num_shards: int
    rows: int
    num_rows_whole: int
    x: torch.Tensor             # [rows, F]
    node_mask: torch.Tensor     # [rows] bool
    adj: Optional[Adjacency]    # the edges into the rows (gnn backbone)

    def gather_all(self, h: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``h``, ``[num_shards·rows, D]``."""
        return all_gather_rows(h, self.group)

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """The whole table of ``h``, cut to the unsharded graph's rows."""
        return self.gather_all(h)[: self.num_rows_whole]

    def dropout(self, x: torch.Tensor, p: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout of this rank's rows with the single device's mask;
        rows past the unsharded graph's (padding) are dropped."""
        if p == 0.0:
            return x
        if generator is None:
            raise ValueError(f"train-mode dropout ({p}) needs a "
                             f"torch.Generator on {x.device}")
        first = self.rank * self.rows
        have = max(0, min(self.rows, self.num_rows_whole - first))
        keep = x.new_empty((self.num_rows_whole,) + tuple(x.shape[1:]))
        keep = keep.bernoulli_(1.0 - p, generator=generator)[
            first:first + have]
        if have < self.rows:
            keep = torch.cat([keep, keep.new_zeros(
                (self.rows - have,) + tuple(x.shape[1:]))])
        return x * keep * (1.0 / (1.0 - p))


def shard_stage1_graph(group, g: Graph, backbone: str, device
                       ) -> Tuple[Graph, RowShard]:
    """``g`` (one domain, on any device) repadded to a multiple of
    ``n·NODE_BLOCK`` rows and this rank's :class:`RowShard` of it on
    ``device`` (JAX ``shard_stage1_graph``): its rows of the features and
    the node mask, and for the ``gnn`` backbone the slot layout of the
    edges into them, senders over all the repadded rows (the padded SpMM
    kernel's ``"blocked"`` layout, degree tiers where the skew rule
    fires).
    Returns the repadded graph on ``device`` with it."""
    n, q = dist.get_world_size(group), dist.get_rank(group)
    n_whole = g.num_nodes_padded
    g = repad_graph_nodes(g, n * NODE_BLOCK).to(device)
    rows = g.num_nodes_padded // n
    lo, hi = q * rows, (q + 1) * rows
    adj = None
    if backbone == "gnn":
        r = g.receivers.cpu().numpy().astype(np.int64)
        s = g.senders.cpu().numpy()
        em = g.edge_mask.cpu().numpy()
        a, b = np.searchsorted(r, [lo, hi], side="left")
        adj = build_adjacency(s[a:b], r[a:b] - lo, em[a:b], rows, rows,
                              method="blocked", device=device,
                              num_senders=g.num_nodes_padded)
    return g, RowShard(group=group, rank=q, num_shards=n, rows=rows,
                       num_rows_whole=n_whole, x=g.x[lo:hi],
                       node_mask=g.node_mask[lo:hi], adj=adj)
