"""Synthetic Sync-UD / Sync-RD datasets and the benchmark graph.

Port of ``bridged_gnn_tpu/data/synthetic.py``: the same numpy draws in
the same order, so the same seed gives the same arrays as the JAX
package. Source and target samples come from two distinct multivariate
Gaussians; the relational variants add random edges at a fixed
homophilous ratio.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_sync_dataset(
    variant: str = "unrelational",
    n_src: int = 2000,
    n_tar: int = 1500,
    dim: int = 64,
    num_classes: int = 4,
    homophily: float = 0.7,
    avg_degree: int = 8,
    domain_shift: float = 1.5,
    class_sep: float = 2.0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Returns a merged VS-graph dict (source nodes first, central=source).

    variants: 'unrelational' (UD — self loops only), 'relational-intra'
    (RD_intra — edges within each domain), 'relational-intra-inter'
    (RD_intra+inter — plus cross-domain edges).
    """
    rng = np.random.default_rng(seed)
    n = n_src + n_tar

    means = rng.normal(size=(num_classes, dim)) * class_sep
    shift = rng.normal(size=dim) * domain_shift / np.sqrt(dim)
    scale_tar = 1.0 + 0.5 * rng.random(dim)

    y = np.concatenate([
        rng.integers(0, num_classes, size=n_src),
        rng.integers(0, num_classes, size=n_tar),
    ])
    x = np.empty((n, dim), dtype=np.float32)
    x[:n_src] = means[y[:n_src]] + rng.normal(size=(n_src, dim))
    x[n_src:] = (
        (means[y[n_src:]] + rng.normal(size=(n_tar, dim))) * scale_tar
        + shift
    )

    central = np.zeros(n, dtype=bool)
    central[:n_src] = True

    if variant in ("unrelational", "ud"):
        loops = np.arange(n, dtype=np.int64)
        edge_index = np.stack([loops, loops])
    else:
        inter = variant in ("relational-intra-inter", "rd-intra-inter",
                            "relational_intra_inter")
        edge_index = _homophilous_edges(
            y, central, rng, avg_degree=avg_degree, homophily=homophily,
            allow_inter=inter,
        )

    return dict(
        x=x, y=y.astype(np.int64), edge_index=edge_index,
        central_mask=central,
    )


def _homophilous_edges(
    y: np.ndarray,
    central: np.ndarray,
    rng: np.random.Generator,
    avg_degree: int,
    homophily: float,
    allow_inter: bool,
) -> np.ndarray:
    """Random edges with a fixed expected homophilous ratio; intra-domain
    unless ``allow_inter``."""
    n = len(y)
    num_edges = n * avg_degree
    num_classes = int(y.max()) + 1
    pools = {}
    for dom in (True, False):
        for c in range(num_classes):
            pools[(dom, c)] = np.where((central == dom) & (y == c))[0]
        pools[(dom, -1)] = np.where(central == dom)[0]

    src = rng.integers(0, n, size=num_edges)
    same_class = rng.random(num_edges) < homophily
    if allow_inter:
        dst_dom = rng.integers(0, 2, size=num_edges).astype(bool)
    else:
        dst_dom = central[src]
    dst_cls = np.where(
        same_class, y[src], rng.integers(0, num_classes, size=num_edges)
    )
    dst = np.empty(num_edges, dtype=np.int64)
    for dom in (True, False):
        for c in range(num_classes):
            m = (dst_dom == dom) & (dst_cls == c)
            if not m.any():
                continue
            pool = pools[(dom, c)]
            if len(pool) == 0:
                pool = pools[(dom, -1)]
            dst[m] = pool[rng.integers(0, len(pool), size=m.sum())]
    return np.stack([src.astype(np.int64), dst])


def make_benchmark_graph(
    n: int = 131072,
    avg_degree: int = 16,
    dim: int = 128,
    num_classes: int = 8,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Large uniform random graph for throughput benchmarks."""
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
