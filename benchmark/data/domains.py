"""The two domains of a stage-1 cell, frozen here so that a change to the
program cannot change the inputs it is measured on.

``split_domains`` is a copy of
``bridged_gnn_tpu_torch/data/datasets.py::dataset_conversion`` as a
stage-1 run of a merged graph calls it (``split_data=True``, no
unobserved feature columns): ``graph.py::domain_split_np``'s rule (the
central nodes are the source domain, the rest the target, each with
contiguous ids and the edges inside it), then a 0.6 / 0.2 / 0.2 split of
each domain stratified by class, one ``torch.randperm`` a class from one
CPU generator seeded with ``seed``, the source's classes first. The same
seed gives the same arrays (``benchmark/tests/test_bench_stage1.py``
holds them to the program's).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Domain = Dict[str, np.ndarray]


def _domain(data: Domain, ids: np.ndarray, lut: np.ndarray,
            inside: np.ndarray) -> Domain:
    n = len(ids)
    return dict(x=data["x"][ids], y=data["y"][ids],
                edge_index=lut[data["edge_index"][:, inside]],
                train_mask=np.zeros(n, dtype=bool),
                val_mask=np.zeros(n, dtype=bool),
                test_mask=np.zeros(n, dtype=bool))


def _stratified(d: Domain, num_classes: int, gen: torch.Generator,
                ratio=(0.6, 0.2, 0.2)) -> None:
    """Per class: the first ``ceil(0.6·n)`` of a random order to train,
    the next ``floor(0.2·n)`` to val, the rest to test."""
    for c in range(num_classes):
        idx = np.where(d["y"] == c)[0]
        n = len(idx)
        n_train = int(np.ceil(n * ratio[0]))
        n_val = int(np.floor(n * ratio[1]))
        perm = torch.randperm(n, generator=gen).numpy()
        d["train_mask"][idx[perm[:n_train]]] = True
        d["val_mask"][idx[perm[n_train:n_train + n_val]]] = True
        d["test_mask"][idx[perm[n_train + n_val:]]] = True


def split_domains(data: Domain, seed: int) -> Tuple[Domain, Domain]:
    """The source and target domains of the merged graph ``data``."""
    central = np.asarray(data["central_mask"]).astype(bool)
    ei = data["edge_index"]
    out = []
    for side in (central, ~central):
        ids = np.where(side)[0]
        lut = np.full(len(central), -1, dtype=np.int64)
        lut[ids] = np.arange(len(ids))
        out.append(_domain(data, ids, lut, side[ei[0]] & side[ei[1]]))
    num_classes = int(np.asarray(data["y"]).max()) + 1
    gen = torch.Generator().manual_seed(seed)
    for d in out:
        _stratified(d, num_classes, gen)
    return out[0], out[1]
