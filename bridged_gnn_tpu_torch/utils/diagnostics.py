"""Graph health diagnostics (port of ``bridged_gnn_tpu/utils/
diagnostics.py::eval_bridged_graph``, numpy and scipy only)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp


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
