"""Padded graph container and the host-side graph builders.

Port of ``bridged_gnn_tpu/graph.py``. The builders are numpy, as in the
JAX package, and give the same arrays; the container holds torch tensors:

  * node and edge arrays are padded to block multiples;
  * validity is tracked with boolean masks;
  * edges are kept sorted by destination (receiver), ties broken by
    sender, so every destination owns a contiguous run of edges.

The native C++ sort/coalesce the JAX package dispatches to above a
million edges is not ported yet; numpy runs at every size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

NODE_BLOCK = 8
EDGE_BLOCK = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded graph of torch tensors.

    Edge arrays are sorted by ``receivers`` (ties broken by ``senders``).
    Padded edge slots have ``edge_mask == False`` and point at node
    ``num_nodes_padded - 1``; every aggregation masks them out.
    """

    x: torch.Tensor          # [N_pad, D] float32
    y: torch.Tensor          # [N_pad] int32, -1 = missing / padding
    senders: torch.Tensor    # [E_pad] int32
    receivers: torch.Tensor  # [E_pad] int32
    edge_mask: torch.Tensor  # [E_pad] bool
    node_mask: torch.Tensor  # [N_pad] bool
    train_mask: torch.Tensor
    val_mask: torch.Tensor
    test_mask: torch.Tensor
    central_mask: torch.Tensor
    num_nodes: int
    num_edges: int

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]

    @property
    def num_features(self) -> int:
        return self.x.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1

    def edge_index_np(self) -> np.ndarray:
        """Dense [2, E] int64 edge index of real edges (host-side)."""
        m = self.edge_mask.cpu().numpy()
        return np.stack([
            self.senders.cpu().numpy()[m], self.receivers.cpu().numpy()[m],
        ]).astype(np.int64)

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Graph":
        """The same graph with every tensor on ``device``."""
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        })


# ---------------------------------------------------------------------------
# Host-side edge utilities (numpy, build time)
# ---------------------------------------------------------------------------


def coalesce_np(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Sort edges lexicographically by (dst, src) and drop duplicates."""
    if edge_index.size == 0:
        return edge_index.reshape(2, 0)
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    key = dst * num_nodes + src
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    keep = np.ones(len(key_sorted), dtype=bool)
    keep[1:] = key_sorted[1:] != key_sorted[:-1]
    sel = order[keep]
    return np.stack([src[sel], dst[sel]])


def sort_edges_by_dst(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    order = np.argsort(dst * num_nodes + src, kind="stable")
    return np.stack([src[order], dst[order]])


def remove_self_loops_np(edge_index: np.ndarray) -> np.ndarray:
    keep = edge_index[0] != edge_index[1]
    return edge_index[:, keep]


def add_self_loops_np(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Append one self loop per node (the caller removes existing self
    loops first, as the reference KT-GNN's graph partition does)."""
    loops = np.arange(num_nodes, dtype=np.int64)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)


# ---------------------------------------------------------------------------
# Graph construction
# ---------------------------------------------------------------------------


def build_graph(
    x: np.ndarray,
    edge_index: np.ndarray,
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    central_mask: Optional[np.ndarray] = None,
) -> Graph:
    """Build a padded :class:`Graph` (CPU tensors) from host arrays."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    e = edge_index.shape[1]
    n_pad = round_up(max(n, 1), NODE_BLOCK)
    e_pad = round_up(max(e, 1), EDGE_BLOCK)

    if e > 0:
        edge_index = sort_edges_by_dst(np.asarray(edge_index), n)

    def pad_nodes(a, fill, dt):
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=dt)
        out[:n] = a
        return out

    x_p = np.zeros((n_pad, d), dtype=np.float32)
    x_p[:n] = x

    y = np.full(n, -1, dtype=np.int32) if y is None else np.asarray(y)
    y_p = pad_nodes(y.astype(np.int32), -1, np.int32)

    def mask_or_false(mask):
        if mask is None:
            mask = np.zeros(n, dtype=bool)
        return torch.from_numpy(
            pad_nodes(np.asarray(mask, dtype=bool), False, bool))

    senders = np.full(e_pad, n_pad - 1, dtype=np.int32)
    receivers = np.full(e_pad, n_pad - 1, dtype=np.int32)
    senders[:e] = edge_index[0]
    receivers[:e] = edge_index[1]
    edge_mask = np.zeros(e_pad, dtype=bool)
    edge_mask[:e] = True
    node_mask = np.zeros(n_pad, dtype=bool)
    node_mask[:n] = True

    return Graph(
        x=torch.from_numpy(x_p),
        y=torch.from_numpy(y_p),
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        edge_mask=torch.from_numpy(edge_mask),
        node_mask=torch.from_numpy(node_mask),
        train_mask=mask_or_false(train_mask),
        val_mask=mask_or_false(val_mask),
        test_mask=mask_or_false(test_mask),
        central_mask=mask_or_false(central_mask),
        num_nodes=n,
        num_edges=e,
    )


def with_self_loops(g: Graph) -> Graph:
    """Return a new Graph whose edges are (edges minus self loops) plus one
    self loop per real node, re-sorted by destination (the reference
    KT-GNN ``graph_partition`` preprocessing)."""
    ei = remove_self_loops_np(g.edge_index_np())
    ei = add_self_loops_np(ei, g.num_nodes)
    n = g.num_nodes

    def host(t):
        return t.cpu().numpy()[:n]

    return build_graph(
        host(g.x), ei, y=host(g.y),
        train_mask=host(g.train_mask), val_mask=host(g.val_mask),
        test_mask=host(g.test_mask), central_mask=host(g.central_mask),
    )


def graph_from_dict(data: Dict[str, np.ndarray]) -> Graph:
    return build_graph(
        data["x"],
        data["edge_index"],
        y=data.get("y"),
        train_mask=data.get("train_mask"),
        val_mask=data.get("val_mask"),
        test_mask=data.get("test_mask"),
        central_mask=data.get("central_mask"),
    )
