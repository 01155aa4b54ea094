"""Cached adjacency operator and the SpMM aggregation.

Port of ``bridged_gnn_tpu/ops/spmm.py::build_adjacency`` and ``spmm``,
with its four methods:

* ``"blocked"``: one padded dst-keyed slot layout, or degree-tiered
  layouts when the graph's degree skew would make the single layout pad
  more than 2× the real edges; the KT-GNN attention kernels and the
  padded SpMM kernel run on them;
* ``"tiered"``: the degree tiers, whatever the skew;
* ``"dense"``: the ``[N_pad, N_pad]`` matrix of edge multiplicities,
  ``dense[dst, src]``; aggregation is one ``torch.matmul`` (JAX
  ``jnp.dot``; no Pallas kernel there either);
* ``"gather"``: the edge arrays alone; aggregation gathers ``x[senders]``
  and sums by receiver (``ops/segment.py``), as the JAX package's XLA
  scatter-add.

``"auto"`` is :func:`resolve_adjacency_method`: dense up to
:data:`DENSE_MAX_NODES` padded nodes, blocked above. The JAX package's
one-hot-matmul dense build (``dense_from_edges``, a TPU scatter
workaround) is not ported: the port scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bridged_gnn_tpu_torch.ops.blocked_segment import (
    BlockedOps,
    TieredOps,
    make_blocked_ops,
    make_tiered_blocked_ops,
)
from bridged_gnn_tpu_torch.ops.padded_spmm import padded_spmm, tiered_spmm
from bridged_gnn_tpu_torch.ops.segment import segment_sum
from bridged_gnn_tpu_torch.utils.platform import resolve_device


# "auto" takes dense up to this many padded nodes; 0: never. On an NVIDIA
# H100 80GB HBM3 (700.00 W), chip_smoke.py phase 20 found KT-GNN slower on
# dense than on the blocked kernels at both sizes the JAX package's rule
# (8192) sends to dense: at 3,504 padded nodes loop epoch 43.9 against
# 27.5 ms, scan epoch 9.48 against 2.40, predict 11.0 against 3.11; at
# 8,192 nodes 46.5 / 25.7 / 10.7 against 31.9 / 2.85 / 3.16 (PERF.md §5).
DENSE_MAX_NODES = 0

METHODS = ("auto", "blocked", "tiered", "dense", "gather")


def resolve_adjacency_method(method: str, num_nodes_padded: int) -> str:
    """The method ``method`` names, with ``"auto"`` resolved by the padded
    node count: ``"dense"`` up to :data:`DENSE_MAX_NODES`, else
    ``"blocked"`` (JAX ``ops/spmm.py:99-100``, with the port's own
    threshold, which the H100 measurement set to 0: "auto" is blocked at
    every size). The rule is the same on every device; the trainer and
    the predictor both resolve through it."""
    if method not in METHODS:
        raise ValueError(f"adjacency method must be one of {list(METHODS)},"
                         f" got {method!r}")
    if method == "auto":
        return ("dense" if num_nodes_padded <= DENSE_MAX_NODES
                else "blocked")
    return method


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """The graph's dst-sorted edge arrays and in-degrees (real edges into
    each node) on one device, and what the method built once per graph
    for every conv to reuse: ``fast_fn`` (the single padded layout),
    ``tiered_fn`` (degree-tiered layouts) or ``dense`` (``[N_pad,
    N_pad]`` f32, ``dense[dst, src]`` the count of real edges), at most
    one of them; none for ``"gather"``. ``group``: on the edge-shard
    layout (``parallel/edgeshard.py``) the process group whose ranks hold
    the other spans of the edge array; KT-GNN's per-edge attention
    all-reduces its destination reductions over it."""

    num_nodes: int
    num_nodes_padded: int
    senders: torch.Tensor      # [E_pad] int32
    receivers: torch.Tensor    # [E_pad] int32
    edge_mask: torch.Tensor    # [E_pad] bool
    in_degree: torch.Tensor    # [N_pad] float32
    fast_fn: Optional[BlockedOps] = None
    tiered_fn: Optional[TieredOps] = None
    dense: Optional[torch.Tensor] = None
    group: Optional[object] = None


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def is_skewed(receivers: np.ndarray, edge_mask: np.ndarray,
              num_nodes_padded: int, node_block: int) -> bool:
    """The JAX package's skew rule: the single layout's slot count
    (blocks × the heaviest block's padded load) exceeds 2× the real edges,
    after a floor of one 128-slot tile per block."""
    n_blocks = -(-num_nodes_padded // node_block)
    counts = np.bincount(receivers[edge_mask] // node_block,
                         minlength=n_blocks)
    et_single = max(((int(counts.max()) + 127) // 128) * 128, 128)
    return n_blocks * et_single > 2 * max(
        int(edge_mask.sum()), n_blocks * 128
    )


def build_adjacency(
    senders,
    receivers,
    edge_mask,
    num_nodes: int,
    num_nodes_padded: Optional[int] = None,
    method: str = "blocked",
    node_block: int = 256,
    device="cuda",
    num_senders: Optional[int] = None,
) -> Adjacency:
    """``method``: one of :data:`METHODS` (``"blocked"`` takes tiers when
    the skew rule fires; ``"auto"`` is :func:`resolve_adjacency_method`).
    Edges must be dst-sorted, as the Graph keeps them. ``num_senders``:
    the sender table's rows where they are not the destinations' (a row
    shard's, ``parallel/gspmd.py``); only the slot layouts take it, so
    ``"gather"`` and ``"dense"`` refuse it."""
    dev = resolve_device(device)
    n_pad = num_nodes_padded or num_nodes
    method = resolve_adjacency_method(method, n_pad)
    if num_senders is not None and method in ("gather", "dense"):
        raise ValueError(f"num_senders: the {method!r} adjacency keys its "
                         "senders by the destinations' rows; only the "
                         "slot layouts (blocked, tiered) take it")
    s_np, r_np, em_np = _host(senders), _host(receivers), _host(edge_mask)
    edges = dict(
        num_nodes=num_nodes, num_nodes_padded=n_pad,
        senders=torch.from_numpy(s_np.astype(np.int32)).to(dev),
        receivers=torch.from_numpy(r_np.astype(np.int32)).to(dev),
        edge_mask=torch.from_numpy(em_np.astype(bool)).to(dev),
        in_degree=torch.from_numpy(np.bincount(
            r_np[em_np], minlength=n_pad).astype(np.float32)).to(dev))
    if method == "gather":
        return Adjacency(**edges)
    if method == "dense":
        dense = torch.zeros(n_pad, n_pad, dtype=torch.float32, device=dev)
        dense.index_put_(
            (edges["receivers"].long(), edges["senders"].long()),
            edges["edge_mask"].float(), accumulate=True)
        return Adjacency(**edges, dense=dense)
    if method == "tiered" or is_skewed(r_np, em_np, n_pad, node_block):
        return Adjacency(
            **edges,
            tiered_fn=make_tiered_blocked_ops(
                s_np, r_np, em_np, n_pad, node_block=min(node_block, 128),
                device=dev, num_senders=num_senders,
            ),
        )
    return Adjacency(
        **edges,
        fast_fn=make_blocked_ops(
            s_np, r_np, em_np, n_pad, node_block=node_block, device=dev,
            num_senders=num_senders,
        ),
    )


def adjacency_from_graph(graph, method: str = "blocked",
                         node_block: int = 256,
                         device="cuda") -> Adjacency:
    return build_adjacency(
        graph.senders,
        graph.receivers,
        graph.edge_mask,
        graph.num_nodes,
        graph.num_nodes_padded,
        method=method,
        node_block=node_block,
        device=device,
    )


def dense_matrix(adj: Adjacency, weights: torch.Tensor) -> torch.Tensor:
    """``[N_pad, N_pad]`` with ``[r, s]`` the sum of ``weights`` over the
    edges from s to r (``weights`` [E_pad], already 0 on padded edges),
    in their dtype. Differentiable in ``weights``: the scatter's backward
    gathers the matrix's gradient at the edges."""
    n = adj.num_nodes_padded
    return weights.new_zeros(n, n).index_put(
        (adj.receivers.long(), adj.senders.long()), weights,
        accumulate=True)


def spmm(adj: Adjacency, x: torch.Tensor, reduce: str = "sum",
         edge_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[v] = reduce_{(u,v) in E} w_uv · x[u]`` over the real edges,
    ``[num_nodes_padded, D]`` (JAX ``ops/spmm.py::spmm``, :204-293).

    ``reduce``: ``"sum"`` or ``"mean"``, which divides by
    ``max(in_degree, 1)``. ``edge_weights`` [E_pad] per edge, or None for
    the unweighted sum. The padded SpMM kernel runs on the single layout
    or once per tier (``ops/padded_spmm.py``); a dense adjacency is one
    matmul, the weighted matrix rebuilt by a scatter when weights are
    given; without either, the gather and a masked segment sum."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    if adj.fast_fn is not None:
        out = padded_spmm(adj.fast_fn.lay_dst, x, edge_weights)
    elif adj.tiered_fn is not None:
        out = tiered_spmm(adj.tiered_fn, x, edge_weights)
    elif adj.dense is not None:
        mat = adj.dense.to(x.dtype) if edge_weights is None else dense_matrix(
            adj, torch.where(adj.edge_mask, edge_weights, 0.0).to(x.dtype))
        out = mat @ x
    else:
        msg = x[adj.senders.long()]
        if edge_weights is not None:
            msg = msg * edge_weights.reshape(
                edge_weights.shape + (1,) * (msg.dim() - edge_weights.dim()))
        out = segment_sum(msg, adj.receivers, adj.num_nodes_padded,
                          mask=adj.edge_mask)
    if reduce == "mean":
        out = out / adj.in_degree.clamp(min=1.0)[:, None]
    return out.to(x.dtype)
