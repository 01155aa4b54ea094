"""Facebook100 (.mat) dataset pipeline.

Port of ``bridged_gnn_tpu/data/facebook100.py``: the splits draw
``torch.randperm`` from explicit generators seeded and consumed as the
reference's global one is, so the masks are the JAX package's.
Re-design of the reference FB100 handling (dataset_facebook100.py:15-141,
datasets.py:69-130) as explicit APIs (the reference runs the cross-network
assembler at module import time — datasets.py:134-138 — and hardcodes a
personal data path — dataset_facebook100.py:117-119; both dropped).

Raw data layout: ``<Univ>.mat`` with adjacency ``A`` and ``local_info``
whose column 0 is the label (student/faculty status flag) and columns 1+
are the categorical features.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.data.datasets import (
    dataset_split,
    split_generator,
)


def onehot_encode_columns(x: np.ndarray) -> np.ndarray:
    """Per-column one-hot over observed categories (reference
    onehot_encoder, dataset_facebook100.py:15-24)."""
    cols = []
    for j in range(x.shape[1]):
        vals, inv = np.unique(x[:, j], return_inverse=True)
        oh = np.zeros((x.shape[0], len(vals)), dtype=np.float32)
        oh[np.arange(x.shape[0]), inv] = 1.0
        cols.append(oh)
    return np.concatenate(cols, axis=1)


def load_fb100_mat(path: str, heterophily: bool = False
                   ) -> Dict[str, np.ndarray]:
    """Read one university graph from its .mat file
    (dataset_facebook100.py:123-131): adjacency → COO edges,
    local_info[:,0] → label, local_info[:,1:] → raw categorical features.

    ``heterophily=True`` is the gender-label variant
    (Facebook100_heterphily, dataset_facebook100.py:249-267): label =
    local_info[:,1] (gender) shifted by -1; features = the remaining
    columns [0,2,3,4,5,6] (status flag, major, minor, dorm, year,
    high school)."""
    from scipy.io import loadmat
    import scipy.sparse as sp

    mat = loadmat(path)
    a = sp.csr_matrix(mat["A"]).tocoo()
    edge_index = np.stack([a.row, a.col]).astype(np.int64)
    info = np.asarray(mat["local_info"], dtype=np.int64)
    if heterophily:
        y = info[:, 1] - 1      # gender; raw 0 (missing) → -1
        x_raw = info[:, [0, 2, 3, 4, 5, 6]]
    else:
        y = info[:, 0] - 1      # status flag; raw value 0 → -1 (missing)
        x_raw = info[:, 1:]
    return dict(edge_index=edge_index, y=y, x_raw=x_raw)


def count_based_split(
    data: Dict[str, np.ndarray],
    num_classes: int,
    num_train_per_class: int = 20,
    num_val: int = 500,
    num_test: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Count-based split (reference Facebook100.split_ with
    ``train_val_test_ratio=None``, dataset_facebook100.py:76-90):
    ``num_train_per_class`` random nodes per class → train; then the
    remaining nodes are shuffled and the first ``num_val`` become val, the
    next ``num_test`` (or all the rest) become test. torch-RNG parity via
    ``torch.randperm``, matching the reference draw order (one perm per
    class, then one over the remainder) from ``generator`` (default: seed
    0)."""
    gen = split_generator(0) if generator is None else generator
    y = np.asarray(data["y"])
    for c in range(num_classes):
        idx = np.where(y == c)[0]
        perm = torch.randperm(len(idx), generator=gen).numpy()[
            :num_train_per_class]
        data["train_mask"][idx[perm]] = True
    remaining = np.where(~data["train_mask"])[0]
    perm = torch.randperm(len(remaining), generator=gen).numpy()
    remaining = remaining[perm]
    data["val_mask"][remaining[:num_val]] = True
    if num_test is not None:
        data["test_mask"][remaining[num_val:num_val + num_test]] = True
    else:
        data["test_mask"][remaining[num_val:]] = True


def build_fb100_graph(
    path: str,
    split: str = "random",
    train_val_test_ratio=(0.4, 0.3, 0.3),
    to_onehot: bool = False,
    seed: int = 0,
    heterophily: bool = False,
    num_train_per_class: int = 20,
    num_val: int = 500,
    num_test: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Build one university graph.

    ``train_val_test_ratio=None`` selects the count-based split (reference
    dataset_facebook100.py:76-90); a ratio tuple selects the per-class
    stratified ratio split (:91-108). ``heterophily=True`` selects the
    gender-label variant (Facebook100_heterphily,
    dataset_facebook100.py:169-276)."""
    raw = load_fb100_mat(path, heterophily=heterophily)
    x = (
        onehot_encode_columns(raw["x_raw"])
        if to_onehot
        else raw["x_raw"].astype(np.float32)
    )
    n = x.shape[0]
    data = dict(
        x=x, y=raw["y"], edge_index=raw["edge_index"],
        train_mask=np.zeros(n, dtype=bool),
        val_mask=np.zeros(n, dtype=bool),
        test_mask=np.zeros(n, dtype=bool),
    )
    if split == "random":
        gen = split_generator(seed)
        num_classes = int(data["y"].max()) + 1
        if train_val_test_ratio is None:
            count_based_split(
                data, num_classes, num_train_per_class, num_val, num_test,
                generator=gen,
            )
        else:
            dataset_split(data, num_classes, train_val_test_ratio,
                          generator=gen)
    return data


def facebook100_kt(
    source_path: str,
    target_path: str,
    to_onehot: bool = True,
    split_ratio_src=(0.4, 0.3, 0.3),
    split_ratio_tar=(0.2, 0.4, 0.4),
    seed: int = 0,
    min_sample_per_cls: int = 150,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Assemble a cross-network FB dataset (reference Facebook100_KT,
    datasets.py:69-130): drop classes with too few samples, relabel
    contiguously, one-hot encode features jointly over both domains.
    Each domain's split reseeds, as the reference's does."""
    src = build_fb100_graph(source_path, "random", split_ratio_src,
                            to_onehot=False, seed=seed)
    tar = build_fb100_graph(target_path, "random", split_ratio_tar,
                            to_onehot=False, seed=seed)
    num_classes = max(int(src["y"].max()), int(tar["y"].max())) + 1
    cnt_src = Counter(src["y"].tolist())
    cnt_tar = Counter(tar["y"].tolist())

    if min_sample_per_cls > 0:
        remap = {}
        rm_src = np.zeros(len(src["y"]), dtype=bool)
        rm_tar = np.zeros(len(tar["y"]), dtype=bool)
        new_src = src["y"].copy()
        new_tar = tar["y"].copy()
        for lbl in range(num_classes):
            # reference condition kept verbatim (datasets.py:97): the second
            # clause is redundant but harmless
            if cnt_src[lbl] < min_sample_per_cls or (
                cnt_tar[lbl] < min_sample_per_cls
                and cnt_src[lbl] < min_sample_per_cls
            ):
                rm_src |= src["y"] == lbl
                rm_tar |= tar["y"] == lbl
                new_src[src["y"] == lbl] = -1
                new_tar[tar["y"] == lbl] = -1
            else:
                remap[lbl] = len(remap)
                new_src[src["y"] == lbl] = remap[lbl]
                new_tar[tar["y"] == lbl] = remap[lbl]
        src["y"], tar["y"] = new_src, new_tar
        for m in ("train_mask", "val_mask", "test_mask"):
            src[m][rm_src] = False
            tar[m][rm_tar] = False

    if to_onehot:
        x_merge = np.concatenate([src["x"], tar["x"]], axis=0)
        x_oh = onehot_encode_columns(x_merge)
        src["x"] = x_oh[: len(src["y"])]
        tar["x"] = x_oh[len(src["y"]):]
    return src, tar


def merge_fb_vsgraph(src, tar) -> Dict[str, np.ndarray]:
    """Merge the two university graphs into a single VS-graph with
    central=source — the on-disk layout of the shipped fb_*.dat files."""
    n_src = src["x"].shape[0]
    n = n_src + tar["x"].shape[0]
    central = np.zeros(n, dtype=bool)
    central[:n_src] = True
    out = dict(
        x=np.concatenate([src["x"], tar["x"]]),
        y=np.concatenate([src["y"], tar["y"]]),
        edge_index=np.concatenate(
            [src["edge_index"], tar["edge_index"] + n_src], axis=1
        ),
        central_mask=central,
    )
    for m in ("train_mask", "val_mask", "test_mask"):
        out[m] = np.concatenate([src[m], tar[m]])
    return out
