"""Stage-2 configuration and model construction for serving.

Port of the parts of ``bridged_gnn_tpu/train/stage2.py`` the predictor
reads: the KT-GNN fields of ``Stage2Config``, ``to_undirected_np`` and
``build_model`` for KTGNN. The training loop arrives with the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from bridged_gnn_tpu_torch.graph import coalesce_np
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class Stage2Config:
    model_name: str = "KTGNN"
    num_layer: int = 2
    hidden: int = 64
    dropout: float = 0.5
    use_bn: bool = True
    seed: int = 0
    to_undirected: bool = False


def to_undirected_np(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """PyG ToUndirected(merge=True): union of edges and reversed edges,
    coalesced (reference main_graph_knowledge_transfer.py:410-411)."""
    ei = data["edge_index"]
    both = np.concatenate([ei, ei[::-1]], axis=1)
    out = dict(data)
    out["edge_index"] = coalesce_np(both, data["x"].shape[0])
    return out


def build_model(cfg: Stage2Config, num_classes: int, in_channels: int,
                device="cuda") -> KTGNN:
    """KT-GNN with the torch-default init drawn from ``cfg.seed``, on
    ``device``. Only ``model_name='KTGNN'`` is ported."""
    if cfg.model_name != "KTGNN":
        raise ValueError(
            f"model {cfg.model_name!r} is not ported; only KTGNN is")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    model = KTGNN(
        num_classes=num_classes,
        in_channels=in_channels,
        layer_num=cfg.num_layer,
        hidden=cfg.hidden,
        dropout=cfg.dropout,
        use_bn=cfg.use_bn,
        generator=gen,
    )
    return model.to(dev)
