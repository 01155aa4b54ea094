"""Cached adjacency operator and the SpMM aggregation.

Port of the ``"blocked"`` and ``"tiered"`` methods of
``bridged_gnn_tpu/ops/spmm.py::build_adjacency``: one padded dst-keyed
slot layout, or degree-tiered layouts when the graph's degree skew would
make the single layout pad more than 2× the real edges; the KT-GNN
attention conv and :func:`spmm`, the model zoo's aggregation, run on
them. The dense path is not ported yet.
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
from bridged_gnn_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """Slot layouts built once per graph and reused by every conv, and
    the graph's dst-sorted edge arrays and in-degrees (real edges into
    each node) on the same device.

    Exactly one of ``fast_fn`` (single padded layout) and ``tiered_fn``
    (degree-tiered layouts) is set."""

    num_nodes: int
    num_nodes_padded: int
    senders: torch.Tensor      # [E_pad] int32
    receivers: torch.Tensor    # [E_pad] int32
    edge_mask: torch.Tensor    # [E_pad] bool
    in_degree: torch.Tensor    # [N_pad] float32
    fast_fn: Optional[BlockedOps] = None
    tiered_fn: Optional[TieredOps] = None


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
) -> Adjacency:
    """``method``: ``"blocked"`` (tiered when the skew rule fires) or
    ``"tiered"``. Edges must be dst-sorted, as the Graph keeps them."""
    dev = resolve_device(device)
    n_pad = num_nodes_padded or num_nodes
    if method not in ("blocked", "tiered"):
        raise ValueError(
            f"adjacency method {method!r} is not ported; use 'blocked' or "
            "'tiered'")
    s_np, r_np, em_np = _host(senders), _host(receivers), _host(edge_mask)
    edges = dict(
        num_nodes=num_nodes, num_nodes_padded=n_pad,
        senders=torch.from_numpy(s_np.astype(np.int32)).to(dev),
        receivers=torch.from_numpy(r_np.astype(np.int32)).to(dev),
        edge_mask=torch.from_numpy(em_np.astype(bool)).to(dev),
        in_degree=torch.from_numpy(np.bincount(
            r_np[em_np], minlength=n_pad).astype(np.float32)).to(dev))
    if method == "tiered" or is_skewed(r_np, em_np, n_pad, node_block):
        return Adjacency(
            **edges,
            tiered_fn=make_tiered_blocked_ops(
                s_np, r_np, em_np, n_pad, node_block=min(node_block, 128),
                device=dev,
            ),
        )
    return Adjacency(
        **edges,
        fast_fn=make_blocked_ops(
            s_np, r_np, em_np, n_pad, node_block=node_block, device=dev,
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


def spmm(adj: Adjacency, x: torch.Tensor, reduce: str = "sum",
         edge_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[v] = reduce_{(u,v) in E} w_uv · x[u]`` over the real edges,
    ``[num_nodes_padded, D]`` (JAX ``ops/spmm.py::spmm``, :204-293).

    ``reduce``: ``"sum"`` or ``"mean"``, which divides by
    ``max(in_degree, 1)``. ``edge_weights`` [E_pad] per edge, or None for
    the unweighted sum. The padded SpMM kernel runs on the single layout
    or once per tier (``ops/padded_spmm.py``)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unknown reduce: {reduce}")
    if adj.fast_fn is not None:
        out = padded_spmm(adj.fast_fn.lay_dst, x, edge_weights)
    elif adj.tiered_fn is not None:
        out = tiered_spmm(adj.tiered_fn, x, edge_weights)
    else:
        raise ValueError("spmm needs a blocked or tiered adjacency")
    if reduce == "mean":
        out = out / adj.in_degree.clamp(min=1.0)[:, None]
    return out.to(x.dtype)
