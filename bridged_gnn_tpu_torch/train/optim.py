"""Optimizer and schedule of the stage-2 recipe.

Port of ``bridged_gnn_tpu/train/optim.py``. The JAX package rebuilt
torch's semantics with optax: ``torch_adam`` adds ``weight_decay · param``
to the gradient before the moment updates (L2, not AdamW), and
``step_lr`` multiplies the rate by ``gamma`` every ``step_size`` updates
(reference main_graph_knowledge_transfer.py:205-207). Here they are
torch's own ``Adam(weight_decay=…)`` and ``StepLR``, stepped once per
epoch, which give ``base · gamma ** (epoch // step_size)`` as a chained
product. The trainer's per-epoch loop hands Adam a float rate. Scan mode
hands it a float64 tensor that its epoch body updates on the device: on
a card that Adam is capturable (its step counts live on the device too),
as a CUDA graph's replays need; on the CPU Adam reads the float the
tensor holds, so the two modes take the same steps bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple, Union

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter], lr: Union[float, torch.Tensor],
    weight_decay: float, use_scheduler: bool, step_size: int, gamma: float,
) -> Tuple[torch.optim.Adam, Optional[torch.optim.lr_scheduler.StepLR]]:
    """Adam with L2 weight decay, and StepLR when ``use_scheduler``. A
    tensor ``lr`` is read at every step, so an in-place update of it sets
    the rate; on a card it makes Adam capturable, its step counts on the
    device."""
    capturable = isinstance(lr, torch.Tensor) and lr.device.type == "cuda"
    opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                           capturable=capturable)
    sched = (torch.optim.lr_scheduler.StepLR(opt, step_size, gamma)
             if use_scheduler else None)
    return opt, sched


def load_optimizer_state(opt: torch.optim.Adam, state: Dict[str, Any],
                         lr: Union[float, torch.Tensor]) -> None:
    """Load a checkpoint's optimizer ``state``, saved by either of the
    trainer's modes, into ``opt`` and keep ``opt``'s own kind: its
    ``capturable`` flag, the rate it was built with (``lr``, which takes
    the saved rate; a tensor is filled in place) and, as that flag
    wants, its step counts on the parameters' device or on the host."""
    capturable = [group["capturable"] for group in opt.param_groups]
    opt.load_state_dict(state)
    saved = float(opt.param_groups[0]["lr"])
    if isinstance(lr, torch.Tensor):
        lr.fill_(saved)
    for group, cap in zip(opt.param_groups, capturable):
        group["capturable"] = cap
        group["lr"] = lr if isinstance(lr, torch.Tensor) else saved
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if cap else "cpu", dtype=torch.float32)
