"""The benchmark's graph generators, frozen here so that a change to the
program cannot change the inputs it is measured on.

``make_benchmark_graph`` is a copy of
``bridged_gnn_tpu_torch/data/synthetic.py::make_benchmark_graph`` and
``hub_graph`` of ``chip_smoke.py::hub_graph``: the same numpy draws in
the same order, so the same seed gives the same arrays
(``benchmark/tests/test_bench_inputs.py`` holds them to the program's).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_benchmark_graph(n: int, avg_degree: int, dim: int,
                         num_classes: int, seed: int) -> Dict[str, np.ndarray]:
    """A uniform random directed graph of ``n · avg_degree`` edges, normal
    features, uniform labels, the first half of the nodes central (source
    domain) and a 0.6 / 0.2 / 0.2 train / val / test split."""
    rng = np.random.default_rng(seed)
    e = n * avg_degree
    central = np.zeros(n, dtype=bool)
    central[: n // 2] = True
    r = rng.random(n)
    return dict(
        x=rng.normal(size=(n, dim)).astype(np.float32),
        y=rng.integers(0, num_classes, size=n).astype(np.int64),
        edge_index=np.stack([
            rng.integers(0, n, size=e), rng.integers(0, n, size=e)
        ]).astype(np.int64),
        central_mask=central,
        train_mask=r < 0.6,
        val_mask=(r >= 0.6) & (r < 0.8),
        test_mask=r >= 0.8,
    )


def hub_graph(data: Dict[str, np.ndarray], seed: int, every: int,
              hubs: int) -> Dict[str, np.ndarray]:
    """``data`` with the destination of every ``every``-th edge (before any
    symmetrisation) replaced by a hub id drawn from ``[0, hubs)``: a few
    hundred nodes with tens of thousands of in-edges, as real graphs'
    degree skew gives."""
    rng = np.random.default_rng(seed)
    ei = data["edge_index"].copy()
    ei[1, ::every] = rng.integers(0, hubs, size=ei[1, ::every].shape[0])
    return dict(data, edge_index=ei)


def make_graph(params: dict, seed: int) -> Dict[str, np.ndarray]:
    """The graph a configuration's sizes (``num_nodes``, ``avg_degree``,
    ``num_features``, ``num_classes``) and a traffic mix's ``skew``
    describe, from ``seed``: the benchmark graph, then the hub rule when
    the skew names one."""
    data = make_benchmark_graph(
        params["num_nodes"], params["avg_degree"], params["num_features"],
        params["num_classes"], seed)
    skew = params.get("skew") or {}
    if skew.get("rule") == "hub":
        data = hub_graph(data, seed, skew["every"], skew["hubs"])
    elif skew:
        raise ValueError(f"unknown skew rule {skew.get('rule')!r}")
    return data
