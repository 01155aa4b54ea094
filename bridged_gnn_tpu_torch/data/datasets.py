"""Dataset preparation: named datasets → per-domain graph dicts.

Port of ``bridged_gnn_tpu/data/datasets.py``. Mirror of the reference
data layer (datasets.py, dataset_ktgnn.py,
utils.py:20-99) with the import-time Facebook100 execution removed
(reference datasets.py:134-138 runs at import — an explicit API here) and
hardcoded personal paths replaced by a ``data_root`` argument.

Split parity: per-class stratified splits draw ``torch.randperm`` from an
explicit CPU ``torch.Generator`` seeded as the reference seeds torch's
global one (``torch.manual_seed``), and consume it in the reference's
order, so a given seed gives the reference's and the JAX package's exact
masks without touching any global RNG.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import (
    add_self_loops_np,
    coalesce_np,
    domain_split_np,
)
from bridged_gnn_tpu_torch.io.pyg_compat import load_pyg_data_dict

UNOBSERVED_DIM = {"twitter": 300, "company": 33}


def split_generator(seed: int) -> torch.Generator:
    """The CPU generator a split draws from: torch's global generator as
    ``torch.manual_seed(seed)`` leaves it (reference datasets.py:27-32)."""
    return torch.Generator().manual_seed(seed)


def dataset_split(
    data: Dict[str, np.ndarray],
    num_classes: int,
    ratio=(0.6, 0.2, 0.2),
    restrict_mask: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
) -> None:
    """Per-class stratified split with ceil/floor rounding, in-place
    (reference utils.py:20-38 / dataset_ktgnn.py:54-75). ``restrict_mask``
    limits candidates (the raw Twitter split only assigns non-central
    nodes). One ``torch.randperm`` per class from ``generator`` (default:
    seed 0)."""
    gen = split_generator(0) if generator is None else generator
    y = np.asarray(data["y"])
    for c in range(num_classes):
        sel = y == c
        if restrict_mask is not None:
            sel = sel & restrict_mask
        idx = np.where(sel)[0]
        n = len(idx)
        n_train = int(np.ceil(n * ratio[0]))
        n_val = int(np.floor(n * ratio[1]))
        assert n - n_train - n_val >= 0
        perm = torch.randperm(n, generator=gen).numpy()
        data["train_mask"][idx[perm[:n_train]]] = True
        data["val_mask"][idx[perm[n_train:n_train + n_val]]] = True
        data["test_mask"][idx[perm[n_train + n_val:]]] = True


def dataset_conversion(
    data: Dict[str, np.ndarray],
    seed: int = 0,
    train_val_test_ratio=(0.6, 0.2, 0.2),
    dataset_name: Optional[str] = None,
    split_data: bool = True,
):
    """Split a merged VS-graph into per-domain graphs (reference
    utils.py:41-99): source keeps full features; for twitter/company the
    target keeps only the domain-shared feature prefix; source always gets a
    fresh stratified split; target gets one only when ``split_data``;
    both splits draw from one generator seeded with ``seed``."""
    gen = split_generator(seed)
    key = (dataset_name or "").split("_")[0]
    src_d, tar_d, mapper_src, mapper_tar = domain_split_np(data)
    if key in UNOBSERVED_DIM:
        tar_d["x"] = tar_d["x"][:, : UNOBSERVED_DIM[key]]

    num_classes = int(np.asarray(data["y"]).max()) + 1
    dataset_split(src_d, num_classes, train_val_test_ratio, generator=gen)
    if split_data:
        dataset_split(tar_d, num_classes, train_val_test_ratio,
                      generator=gen)
    else:
        # keep the original target split from the merged graph
        central = np.asarray(data["central_mask"]).astype(bool)
        idxs_tar = np.where(~central)[0]
        lut = np.full(len(central), -1, dtype=np.int64)
        lut[idxs_tar] = np.arange(len(idxs_tar))
        for mask_name in ("train_mask", "val_mask", "test_mask"):
            orig = np.where(np.asarray(data[mask_name]) & ~central)[0]
            tar_d[mask_name][lut[orig]] = True
    return src_d, tar_d, mapper_src, mapper_tar


def load_npy_vsgraph(
    root: str, remove_unobserved_feats: bool = False,
    observed_dim: int = 300,
) -> Dict[str, np.ndarray]:
    """Raw VS-graph from X.npy/Y.npy/central_mask.npy/edge_index.npy
    (reference dataset_ktgnn.py:40-41,80-85)."""
    x = np.load(os.path.join(root, "X.npy")).astype(np.float32)
    if remove_unobserved_feats:
        x = x[:, :observed_dim]
    return dict(
        x=x,
        y=np.load(os.path.join(root, "Y.npy")).astype(np.int64),
        central_mask=np.load(os.path.join(root, "central_mask.npy")).astype(
            bool
        ),
        edge_index=np.load(os.path.join(root, "edge_index.npy")).astype(
            np.int64
        ),
    )


def _self_loops_only(data: Dict[str, np.ndarray]) -> None:
    n = data["x"].shape[0]
    loops = np.arange(n, dtype=np.int64)
    data["edge_index"] = np.stack([loops, loops])


def reconstruct_office_domains(bridged: Dict[str, np.ndarray],
                               dataset_name: str):
    """Recover the per-domain stage-1 inputs of an office run from its
    *output* bridged graph.

    The shipped office bridged graphs (reference data_bridged_graph/,
    written at main_bridged_graph.py:320) contain everything the pipeline
    consumed: office is a non-graph setting, so the raw VS-graph's edges
    were self-loops only, and merge+reorder (main_bridged_graph.py:163-222)
    carried x, y, central_mask and the original target split through in
    the original node order. The source split is regenerated by replaying
    the reference's seeded torch.randperm stream
    (dataset_conversion(seed=1), reference datasets.py:64 +
    utils.py:20-38). Returns (src_dict, tar_dict, mapper_src, mapper_tar)
    — the exact inputs gen_bridged_graph needs to reproduce the shipped
    edge set (tests/test_bridge_repro.py)."""
    vs = dict(
        x=np.asarray(bridged["x"]),
        y=np.asarray(bridged["y"]),
        central_mask=np.asarray(bridged["central_mask"]).astype(bool),
        train_mask=np.asarray(bridged["train_mask"]).astype(bool),
        val_mask=np.asarray(bridged["val_mask"]).astype(bool),
        test_mask=np.asarray(bridged["test_mask"]).astype(bool),
    )
    _self_loops_only(vs)
    return dataset_conversion(
        vs, seed=1, dataset_name=dataset_name, split_data=False
    )


def _fresh_masks(data: Dict[str, np.ndarray]) -> None:
    n = data["x"].shape[0]
    for m in ("train_mask", "val_mask", "test_mask"):
        data.setdefault(m, np.zeros(n, dtype=bool))


def prepare_datasets(
    dataset_name: str = "twitter_unrelational",
    data_root: str = "../datasets",
    split_seed: int = 1,
):
    """Named-dataset dispatcher (reference datasets.py:16-66). Returns
    (src_dict, tar_dict, merged_dict, mapper_idx_src, mapper_idx_tar)."""
    observed = {"twitter": 300, "company": 33}
    if dataset_name.startswith("twitter") or dataset_name.startswith(
        "company"
    ):
        base = dataset_name.split("_")[0]
        root = os.path.join(data_root, f"{base}_observed", "raw")
        if not os.path.isdir(root):
            root = os.path.join(data_root, base, "raw")
        data = load_npy_vsgraph(
            root, remove_unobserved_feats=True, observed_dim=observed[base]
        )
        _fresh_masks(data)
        # raw split over non-central nodes; labeled central → train
        # (dataset_ktgnn.py:54-75)
        dataset_split(
            data, int(data["y"].max()) + 1, (0.6, 0.2, 0.2),
            restrict_mask=~data["central_mask"],
            generator=split_generator(0),
        )
        data["train_mask"][data["central_mask"] & (data["y"] != -1)] = True
        if dataset_name.endswith("unrelational"):
            _self_loops_only(data)
        else:
            # relational variant: undirected + self loops
            # (reference datasets.py:24-29)
            n = data["x"].shape[0]
            ei = data["edge_index"]
            both = coalesce_np(
                np.concatenate([ei, ei[::-1]], axis=1), n
            )
            data["edge_index"] = add_self_loops_np(both, n)
        split_data = True
    elif dataset_name.startswith("office"):
        data = load_pyg_data_dict(
            os.path.join(data_root, f"{dataset_name}_pyg.dat")
        )
        _fresh_masks(data)
        split_data = False
    elif dataset_name.startswith("fb_"):
        fname = {
            "fb_hamilton2caltech":
                "dataset_FB(Hamilton->Caltech)_pyg_relational_intra.dat",
            "fb_howard2simmons":
                "dataset_FB(Howard->Simmons)_pyg_relational_intra.dat",
        }[dataset_name]
        path = os.path.join(data_root, fname)
        if os.path.exists(path):
            data = load_pyg_data_dict(path)
            if "source_mask" in data:
                data["central_mask"] = data.pop("source_mask")
        else:
            # assemble from raw .mat files under <data_root>/facebook100/
            # (reference Facebook100_KT, datasets.py:69-138, with the
            # import-time execution made an explicit fallback here)
            from bridged_gnn_tpu_torch.data.facebook100 import (
                facebook100_kt,
                merge_fb_vsgraph,
            )

            univs = {
                "fb_hamilton2caltech": ("Hamilton46", "Caltech36"),
                "fb_howard2simmons": ("Howard90", "Simmons81"),
            }[dataset_name]
            mat_dir = os.path.join(data_root, "facebook100")
            src, tar = facebook100_kt(
                os.path.join(mat_dir, univs[0] + ".mat"),
                os.path.join(mat_dir, univs[1] + ".mat"),
                to_onehot=True, min_sample_per_cls=50,
            )
            data = merge_fb_vsgraph(src, tar)
        _fresh_masks(data)
        split_data = False
    elif dataset_name.startswith("sync"):
        from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset

        variant = dataset_name.split("_", 1)[1] if "_" in dataset_name \
            else "unrelational"
        data = make_sync_dataset(variant=variant)
        _fresh_masks(data)
        split_data = True
    else:
        raise NotImplementedError(
            f"Not Recognized Dataset Name:{dataset_name}"
        )

    if dataset_name.split("_")[-1] == "unrelational":
        _self_loops_only(data)

    src_d, tar_d, m_src, m_tar = dataset_conversion(
        data, seed=split_seed, dataset_name=dataset_name,
        split_data=split_data,
    )
    return src_d, tar_d, data, m_src, m_tar
