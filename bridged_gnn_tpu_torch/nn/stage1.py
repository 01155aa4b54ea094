"""Stage-1 building blocks (port of ``bridged_gnn_tpu/nn/stage1.py``).

Only :class:`SAGEConv` is ported so far: the stage-2 GraphSAGE backbone
(``nn/backbones.py``) and the ``--no_dtc`` recipe use it. The rest of
stage 1 comes with ROADMAP.md Queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bridged_gnn_tpu_torch.nn.common import TorchLinear
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, spmm


class SAGEConv(nn.Module):
    """GraphSAGE conv: ``lin_l(mean-aggregate(x)) [+ lin_r(x)]`` (PyG
    SAGEConv defaults: mean aggregation, bias on ``lin_l`` only; JAX
    ``nn/stage1.py:47-65``). The aggregation is the padded SpMM
    kernel."""

    def __init__(self, in_channels: int, out_channels: int,
                 root_weight: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = TorchLinear(in_channels, out_channels,
                                 generator=generator)
        self.lin_r = (TorchLinear(in_channels, out_channels, bias=False,
                                  generator=generator)
                      if root_weight else None)

    def forward(self, x: torch.Tensor, adj: Adjacency) -> torch.Tensor:
        out = self.lin_l(spmm(adj, x, reduce="mean"))
        if self.lin_r is not None:
            out = out + self.lin_r(x)
        return out
