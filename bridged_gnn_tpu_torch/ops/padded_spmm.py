"""Padded SpMM ``y[v] = Σ_{(u,v)} w_uv · x[u]`` with its gradients.

Port of the custom VJPs ``spmm_fast`` and ``spmm_unw`` of
``bridged_gnn_tpu/ops/blocked_segment.py`` (:639-682), which
``BlockedOps.spmm`` runs for every aggregation of the model zoo. The
forward is one launch of the destination-keyed kernel
(``fused_kernels.gather_reduce``) over the layout's slots; the backward's
``dx[u] = Σ_{(u,v)} w_uv · dy[v]`` is one launch of the same kernel
walking the sender CSR (the transposed SpMM of JAX ``spmm_bwd``); the
edge weights' gradient ``dw_uv = dy[v] · x[u]`` is plain PyTorch, as JAX
computes it outside its kernel too, and only when asked for.

On degree-tiered layouts the kernel runs once per tier on that tier's
destination rows, and one row permutation takes the tier-concat output
back to global rows, as ``adapted_attention_tiered`` does: the JAX
package's zoo falls back to a gather and ``segment_sum`` there
(ops/spmm.py:279-288); this is the same function summed in another
order.
"""

from __future__ import annotations

from typing import Optional

import torch

from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.ops.blocked_segment import (
    PaddedLayout,
    TieredOps,
    slot_rows,
)


class PaddedSpmm(torch.autograd.Function):
    """``apply(lay, x, w_slot)`` → ``[lay.num_nodes_padded, D]``: the
    layout's destination rows summed over their real slots, each slot's
    sender row of ``x`` times its weight (``w_slot`` [B·Et], or None for
    the unweighted sum). Gradients flow to ``x`` and ``w_slot``."""

    @staticmethod
    def forward(ctx, lay, x, w_slot):
        ctx.lay = lay
        ctx.save_for_backward(x, w_slot)
        return fused_kernels.gather_reduce(lay, x, lay.num_nodes_padded,
                                           w_slot)

    @staticmethod
    def backward(ctx, dout):
        x, w_slot = ctx.saved_tensors
        lay = ctx.lay
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = fused_kernels.gather_reduce(lay, dout, x.shape[0], w_slot,
                                             transpose=True)
        if w_slot is not None and ctx.needs_input_grad[2]:
            row, valid = slot_rows(lay)
            src = lay.slot_src.clamp(min=0).long()
            dw = torch.where(valid, (dout[row] * x[src]).sum(-1), 0.0)
        return None, dx, dw


def _slot_weights(lay: PaddedLayout, x: torch.Tensor,
                  w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-edge weights in the layout's slot order (pad slots read edge
    0; the kernel skips them)."""
    return None if w is None else w.to(x.dtype)[lay.slot_edge]


def padded_spmm(lay: PaddedLayout, x: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SpMM over one padded layout: ``[num_nodes_padded, D]``; ``w`` per
    edge of the adjacency's edge array, or None (JAX ``spmm_fast`` and
    ``spmm_unw``)."""
    x = x.contiguous()
    return PaddedSpmm.apply(lay, x, _slot_weights(lay, x, w))


def tiered_spmm(tops: TieredOps, x: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SpMM over degree-tiered layouts: the kernel once per tier, the
    tier-concat rows permuted back to global rows,
    ``[num_nodes_padded, D]``."""
    x = x.contiguous()
    outs = [PaddedSpmm.apply(t.lay_dst, x, _slot_weights(t.lay_dst, x, w))
            for t in tops.tiers]
    return torch.cat(outs, dim=0)[tops.inv_order][: tops.num_nodes_padded]
