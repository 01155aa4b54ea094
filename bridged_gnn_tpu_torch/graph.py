"""Padded graph container and the host-side graph builders.

Port of ``bridged_gnn_tpu/graph.py``. The builders are numpy, as in the
JAX package, and give the same arrays; the container holds torch tensors:

  * node and edge arrays are padded to block multiples;
  * validity is tracked with boolean masks;
  * edges are kept sorted by destination (receiver), ties broken by
    sender, so every destination owns a contiguous run of edges.

From :data:`NATIVE_EDGE_THRESHOLD` edges up, :func:`coalesce_np` and
:func:`sort_edges_by_dst` run the native library (``io/native.py``, the
port's ``csrc/graphcore.cpp``), as the JAX package dispatches
(graph.py:104-127); it gives the same arrays as the numpy versions
below, and raises where it cannot be built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

NODE_BLOCK = 8
EDGE_BLOCK = 128
# edges from which the host sort and coalesce run natively (JAX graph.py:34)
NATIVE_EDGE_THRESHOLD = 1_000_000


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
    """Sort edges lexicographically by (dst, src) and drop duplicates;
    natively from :data:`NATIVE_EDGE_THRESHOLD` edges."""
    if edge_index.size == 0:
        return edge_index.reshape(2, 0)
    if edge_index.shape[1] >= NATIVE_EDGE_THRESHOLD:
        from bridged_gnn_tpu_torch.io import native

        return native.coalesce(edge_index)
    return coalesce_numpy(edge_index, num_nodes)


def coalesce_numpy(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """:func:`coalesce_np` in numpy, at any size."""
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    key = dst * num_nodes + src
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    keep = np.ones(len(key_sorted), dtype=bool)
    keep[1:] = key_sorted[1:] != key_sorted[:-1]
    sel = order[keep]
    return np.stack([src[sel], dst[sel]])


def dst_order(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """The permutation that sorts edges by (dst, src), stable: the order
    :func:`build_graph` keeps them in (and per-edge attributes follow)."""
    src, dst = edge_index[0].astype(np.int64), edge_index[1].astype(np.int64)
    return np.argsort(dst * num_nodes + src, kind="stable")


def sort_edges_by_dst(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Edges in :func:`dst_order`, duplicates kept; natively from
    :data:`NATIVE_EDGE_THRESHOLD` edges."""
    if edge_index.shape[1] >= NATIVE_EDGE_THRESHOLD:
        from bridged_gnn_tpu_torch.io import native

        return native.sort_by_dst(edge_index)
    return sort_edges_numpy(edge_index, num_nodes)


def sort_edges_numpy(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """:func:`sort_edges_by_dst` in numpy, at any size."""
    order = dst_order(edge_index, num_nodes)
    return np.stack([edge_index[0].astype(np.int64)[order],
                     edge_index[1].astype(np.int64)[order]])


def remove_self_loops_np(edge_index: np.ndarray) -> np.ndarray:
    keep = edge_index[0] != edge_index[1]
    return edge_index[:, keep]


def add_self_loops_np(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Append one self loop per node (the caller removes existing self
    loops first, as the reference KT-GNN's graph partition does)."""
    loops = np.arange(num_nodes, dtype=np.int64)
    return np.concatenate([edge_index, np.stack([loops, loops])], axis=1)


def to_undirected_np(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """PyG ToUndirected(merge=True): union of edges and reversed edges,
    coalesced (reference main_graph_knowledge_transfer.py:410-411)."""
    ei = data["edge_index"]
    both = np.concatenate([ei, ei[::-1]], axis=1)
    out = dict(data)
    out["edge_index"] = coalesce_np(both, data["x"].shape[0])
    return out


def slot_node_block(ktgnn_family: bool) -> int:
    """The node block of a stage-2 model's slot layouts, in training and
    in serving: 128 for the KT-GNN family's attention kernels, 256 for
    the zoo's padded SpMM."""
    return 128 if ktgnn_family else 256


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


# ---------------------------------------------------------------------------
# Domain split, merge and reorder (stage 1's front and back end; JAX
# graph.py:249-364, host numpy)
# ---------------------------------------------------------------------------


def merge_graphs_np(
    src: Dict[str, np.ndarray],
    tar: Dict[str, np.ndarray],
    edge_index_cross: np.ndarray,
    edge_index_within_src: Optional[np.ndarray] = None,
    edge_index_within_tar: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Union of the source graph, the target graph and the proposed bridge
    edges (reference ``merge_graphs``, main_bridged_graph.py:163-193):
    target ids are offset by N_src, cross edges run src → tar, every
    labeled source node is train and central, and the edges are
    coalesced."""
    n_src = src["x"].shape[0]
    n_tar = tar["x"].shape[0]
    n = n_src + n_tar
    x = np.concatenate([src["x"], tar["x"]], axis=0)
    y = np.concatenate([src["y"], tar["y"]], axis=0)

    parts = [src["edge_index"], tar["edge_index"] + n_src]
    cross = edge_index_cross.copy()
    cross[1, :] += n_src
    parts.append(cross)
    if edge_index_within_src is not None:
        parts.append(edge_index_within_src)
    if edge_index_within_tar is not None:
        parts.append(edge_index_within_tar + n_src)
    edge_index = np.concatenate(parts, axis=1)

    central_mask = np.zeros(n, dtype=bool)
    central_mask[:n_src] = True
    train_mask = np.zeros(n, dtype=bool)
    val_mask = np.zeros(n, dtype=bool)
    test_mask = np.zeros(n, dtype=bool)
    train_mask[:n_src] = True
    train_mask[: n_src][src["y"] == -1] = False
    train_mask[n_src:][tar["train_mask"]] = True
    val_mask[n_src:][tar["val_mask"]] = True
    test_mask[n_src:][tar["test_mask"]] = True

    edge_index = coalesce_np(edge_index, n)
    return dict(
        x=x, y=y, edge_index=edge_index, train_mask=train_mask,
        val_mask=val_mask, test_mask=test_mask, central_mask=central_mask,
    )


def reorder_np(
    merged: Dict[str, np.ndarray],
    n_src: int,
    mapper_idx_src: Dict[int, int],
    mapper_idx_tar: Dict[int, int],
) -> Dict[str, np.ndarray]:
    """Permute the merged graph back to the original VS-graph's node order
    (reference ``reorder``, main_bridged_graph.py:195-222); the mappers
    take original ids to per-domain ids, target ids offset by N_src in
    the merged order."""
    n = merged["x"].shape[0]
    perm = np.empty(n, dtype=np.int64)          # original id -> merged id
    for orig, new in mapper_idx_src.items():
        perm[orig] = new
    for orig, new in mapper_idx_tar.items():
        perm[orig] = new + n_src
    inv = np.empty(n, dtype=np.int64)           # merged id -> original id
    inv[perm] = np.arange(n)

    out = {}
    for key in ("x", "y", "train_mask", "val_mask", "test_mask",
                "central_mask"):
        out[key] = merged[key][perm]
    out["edge_index"] = inv[merged["edge_index"]]
    return out


def domain_split_np(
    data: Dict[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], Dict[int, int],
           Dict[int, int]]:
    """Split a merged VS-graph into per-domain graphs with contiguous ids
    (reference ``dataset_conversion`` core, utils.py:41-79): edges across
    the domains are dropped; the mappers take original ids to new ids."""
    central = data["central_mask"].astype(bool)
    idxs_src = np.where(central)[0]
    idxs_tar = np.where(~central)[0]
    mapper_src = {int(o): i for i, o in enumerate(idxs_src)}
    mapper_tar = {int(o): i for i, o in enumerate(idxs_tar)}

    ei = data["edge_index"]
    lut = np.full(len(central), -1, dtype=np.int64)
    lut[idxs_src] = np.arange(len(idxs_src))
    lut_t = np.full(len(central), -1, dtype=np.int64)
    lut_t[idxs_tar] = np.arange(len(idxs_tar))

    m_src = central[ei[0]] & central[ei[1]]
    m_tar = (~central[ei[0]]) & (~central[ei[1]])
    ei_src = lut[ei[:, m_src]]
    ei_tar = lut_t[ei[:, m_tar]]

    def sub(idxs, ei_new):
        return dict(
            x=data["x"][idxs],
            y=data["y"][idxs],
            edge_index=ei_new,
            train_mask=np.zeros(len(idxs), dtype=bool),
            val_mask=np.zeros(len(idxs), dtype=bool),
            test_mask=np.zeros(len(idxs), dtype=bool),
        )

    return (sub(idxs_src, ei_src), sub(idxs_tar, ei_tar), mapper_src,
            mapper_tar)


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
