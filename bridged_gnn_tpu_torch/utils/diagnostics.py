"""Graph health diagnostics: homophily ratios, degrees and local label
homophily (port of ``bridged_gnn_tpu/utils/diagnostics.py``, numpy and
scipy only; reference utils.py:101-131). Second-order neighbours come
from a sparse product, as in the JAX package, not the reference's dense
``A @ A``."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.sparse as sp


def edge_homophily(edge_index: np.ndarray, y: np.ndarray) -> float:
    """Share of labeled edges whose endpoints share a label."""
    labeled = (y[edge_index[0]] != -1) & (y[edge_index[1]] != -1)
    if labeled.sum() == 0:
        return float("nan")
    return float(
        ((y[edge_index[0]] == y[edge_index[1]]) & labeled).sum()
        / labeled.sum()
    )


def eval_homophily(data: Dict[str, np.ndarray]) -> Tuple[float, float]:
    """First- and second-order edge homophily (reference
    utils.py:115-131)."""
    ei = np.asarray(data["edge_index"])
    y = np.asarray(data["y"])
    n = data["x"].shape[0]
    h1 = edge_homophily(ei, y)
    a = sp.coo_matrix(
        (np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(n, n)
    ).tocsr()
    a2 = (a @ a).tocoo()
    h2 = edge_homophily(np.stack([a2.row, a2.col]), y)
    return h1, h2


def degree_stats(edge_index: np.ndarray, num_nodes: int
                 ) -> Dict[str, float]:
    """In- and out-degree summary of a graph (the JAX package counts them
    in its native library, here ``np.bincount``: the same counts)."""
    ei = np.asarray(edge_index)
    in_deg = np.bincount(ei[1], minlength=num_nodes)
    out_deg = np.bincount(ei[0], minlength=num_nodes)
    return dict(
        in_mean=float(in_deg.mean()), in_max=int(in_deg.max(initial=0)),
        out_mean=float(out_deg.mean()), out_max=int(out_deg.max(initial=0)),
        isolated=int(((in_deg == 0) & (out_deg == 0)).sum()),
    )


def eval_bridged_graph(data: Dict[str, np.ndarray]) -> float:
    """Share of test nodes whose labeled in-neighborhood is majority
    same-label (reference eval_bridged_Graph, utils.py:101-113)."""
    ei = np.asarray(data["edge_index"])
    y = np.asarray(data["y"])
    n = data["x"].shape[0]
    c = int(y.max()) + 1
    onehot = np.zeros((n, c), dtype=np.float64)
    labeled = y != -1
    onehot[labeled, y[labeled]] = 1.0
    # in-neighbor label histogram: adj_t[dst, src] (utils.py:104-106)
    a_t = sp.coo_matrix(
        (np.ones(ei.shape[1]), (ei[1], ei[0])), shape=(n, n)
    ).tocsr()
    lbl_dist = a_t @ onehot
    deg = lbl_dist.sum(1)
    valid = (deg != 0) & labeled
    deg = np.where(valid, deg, deg + 1e-3)
    local = (lbl_dist * onehot).sum(1) / deg
    test_mask = np.asarray(data["test_mask"])
    return float((local[test_mask] > 0.5).sum() / max(test_mask.sum(), 1))
