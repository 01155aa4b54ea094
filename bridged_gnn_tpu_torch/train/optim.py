"""Optimizer and schedule of the stage-2 recipe.

Port of ``bridged_gnn_tpu/train/optim.py``. The JAX package rebuilt
torch's semantics with optax: ``torch_adam`` adds ``weight_decay · param``
to the gradient before the moment updates (L2, not AdamW), and
``step_lr`` multiplies the rate by ``gamma`` every ``step_size`` updates
(reference main_graph_knowledge_transfer.py:205-207). Here they are
torch's own ``Adam(weight_decay=…)`` and ``StepLR``, stepped once per
epoch, which give ``base · gamma ** (epoch // step_size)``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float,
    use_scheduler: bool, step_size: int, gamma: float,
) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.StepLR]]:
    """Adam with L2 weight decay, and StepLR when ``use_scheduler``."""
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    sched = (torch.optim.lr_scheduler.StepLR(opt, step_size, gamma)
             if use_scheduler else None)
    return opt, sched
