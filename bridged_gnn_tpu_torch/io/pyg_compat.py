"""Readers for the reference's pickle formats, without PyG installed.

Port of ``bridged_gnn_tpu/io/pyg_compat.py`` (the port keeps its own copy:
importing the JAX package's module would import JAX). The reference
writes two kinds of artifact with ``torch.save``:

  * bridged graphs: a PyG ``Data`` with fields ``x, edge_index, y,
    train_mask, val_mask, test_mask, central_mask`` (the ``.dat`` files of
    reference main_bridged_graph.py:320, read at
    main_graph_knowledge_transfer.py:401);
  * model checkpoints: plain ``state_dict`` pickles.

A PyG ``Data`` pickle names ``torch_geometric.data.data.Data`` and
``torch_geometric.data.storage.GlobalStorage``. When PyG is absent, stand-in
classes are registered under those module paths (at the first load, never
at import) so that ``torch.load`` can rebuild the object, which is then
turned into a dict of numpy arrays at once. These files are unpickled
with ``weights_only=False``: load only files from a source you trust.
"""

from __future__ import annotations

import sys
import types
from typing import Dict

import numpy as np
import torch


class _ShimData:
    """Stands in for ``torch_geometric.data.data.Data`` while unpickling."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def to_dict(self) -> Dict[str, np.ndarray]:
        # PyG >= 2.0 keeps the tensors in _store (GlobalStorage), < 2.0 on
        # the object itself
        store = self.__dict__.get("_store")
        if store is not None:
            mapping = store.__dict__.get("_mapping", store.__dict__)
        else:
            mapping = self.__dict__
        return {k: v.cpu().numpy() for k, v in dict(mapping).items()
                if isinstance(v, torch.Tensor)}


class _ShimStorage:
    def __setstate__(self, state):
        self.__dict__.update(state)


def _install_shims() -> None:
    if "torch_geometric" in sys.modules and not getattr(
            sys.modules["torch_geometric"], "_bgt_shim", False):
        return  # the real PyG is loaded
    root = types.ModuleType("torch_geometric")
    root._bgt_shim = True
    data_pkg = types.ModuleType("torch_geometric.data")
    data_mod = types.ModuleType("torch_geometric.data.data")
    storage_mod = types.ModuleType("torch_geometric.data.storage")
    data_mod.Data = _ShimData
    data_mod.DataEdgeAttr = type("DataEdgeAttr", (), {})
    data_mod.DataTensorAttr = type("DataTensorAttr", (), {})
    storage_mod.GlobalStorage = _ShimStorage
    storage_mod.NodeStorage = _ShimStorage
    storage_mod.EdgeStorage = _ShimStorage
    data_pkg.data = data_mod
    data_pkg.storage = storage_mod
    data_pkg.Data = _ShimData
    root.data = data_pkg
    sys.modules["torch_geometric"] = root
    sys.modules["torch_geometric.data"] = data_pkg
    sys.modules["torch_geometric.data.data"] = data_mod
    sys.modules["torch_geometric.data.storage"] = storage_mod


def load_pyg_data_dict(path: str) -> Dict[str, np.ndarray]:
    """A pickled PyG ``Data`` file as a dict of numpy arrays."""
    _install_shims()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, _ShimData):
        return obj.to_dict()
    if hasattr(obj, "to_dict"):
        return {k: v.cpu().numpy() for k, v in obj.to_dict().items()
                if isinstance(v, torch.Tensor)}
    raise TypeError(f"Unsupported pickled object type: {type(obj)}")


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch ``state_dict`` checkpoint as ``{name: numpy array}``."""
    _install_shims()
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.cpu().numpy() for k, v in sd.items()}
