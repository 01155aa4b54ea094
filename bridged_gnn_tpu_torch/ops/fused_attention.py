"""Fused domain-adapted attention message passing, forward and backward.

Port of the kernel paths of ``bridged_gnn_tpu/ops/fused_attention.py``:
``make_adapted_attention_sel`` on one padded layout (the single-layout
path, here :class:`AttentionSel` through :func:`attention_sel`), and
``make_adapted_attention`` once per tier inside
:func:`adapted_attention_tiered` on degree-tiered layouts (here
:class:`AttentionCat`). The whole attention pass — sender-row gather,
GATv2 logits, per-destination softmax and weighted aggregation — is one
kernel launch per layout, and so is each backward, followed by one
sender-keyed reduce (``ops/fused_kernels.py``).

Both compute, for each destination ``v``,
``out[v] = Σ_u softmax_v(a·leaky_relu(u[s] + u[v])) · u[s]`` with the
branch (``u1``/``a1`` when ``central[v]``, else ``u2``/``a2``) chosen by
the destination's domain (reference models/KTGNN.py:263-315). The
destination's own row ``ud`` enters each Function as an input of its own,
built outside from the same tables; autograd sums its cotangent back into
``u1``/``u2``. The Functions save their inputs plus per-slot scalars only
(``ex`` and ``den``, or ``alpha``), as the JAX custom VJPs do.
"""

from __future__ import annotations

import torch

from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.ops.blocked_segment import PaddedLayout, TieredOps


class AttentionSel(torch.autograd.Function):
    """Selective attention over one padded layout: the custom VJP of
    ``make_adapted_attention_sel`` (fused_attention.py:652-736) with the
    kernel forward and backward.

    ``apply(lay, u1, u2, ud, central, a1, a2, negative_slope)`` → [n_out,
    D]. Gradients flow to ``u1``, ``u2``, ``ud``, ``a1`` and ``a2``."""

    @staticmethod
    def forward(ctx, lay, u1, u2, ud, central, a1, a2, negative_slope):
        out, ex, den = fused_kernels.attention_sel_fwd(
            lay, u1, u2, ud, central, a1, a2, negative_slope)
        ctx.save_for_backward(u1, u2, ud, central, a1, a2, ex, den)
        ctx.lay, ctx.negative_slope = lay, negative_slope
        return out

    @staticmethod
    def backward(ctx, dout):
        u1, u2, ud, central, a1, a2, ex, den = ctx.saved_tensors
        d = u1.shape[1]
        dm, dud, da, slot_c = fused_kernels.attention_sel_bwd(
            ctx.lay, u1, u2, ud, central, a1, a2, ex, den,
            dout.contiguous(), ctx.negative_slope)
        # du1 and du2 in one sender-keyed reduce, split by slot branch
        du = fused_kernels.slot_reduce(ctx.lay, dm, u1.shape[0], slot_c)
        return (None, du[:, :d], du[:, d:], dud, None, da[:d], da[d:],
                None)


class AttentionCat(torch.autograd.Function):
    """Concatenated attention over one padded layout: the custom VJP of
    ``make_adapted_attention`` (fused_attention.py:173-268) with the
    kernel forward and backward. The destination's branch of the kernel's
    ``[n_out, 2D]`` output is kept inside the Function, as
    ``adapted_attention_fwd_pallas`` does (pallas_fused.py:481-483), so
    the output and its cotangent are [n_out, D]. Same arguments and
    gradients as :class:`AttentionSel`."""

    @staticmethod
    def forward(ctx, lay, u1, u2, ud, central, a1, a2, negative_slope):
        out2, alpha = fused_kernels.attention_fwd(
            lay, u1, u2, ud, central, a1, a2, negative_slope)
        ctx.save_for_backward(u1, u2, ud, central, a1, a2, alpha)
        ctx.lay, ctx.negative_slope = lay, negative_slope
        d = u1.shape[1]
        return torch.where(central[:, None], out2[:, :d], out2[:, d:])

    @staticmethod
    def backward(ctx, dout):
        u1, u2, ud, central, a1, a2, alpha = ctx.saved_tensors
        d = u1.shape[1]
        dm, dud, da = fused_kernels.attention_bwd(
            ctx.lay, u1, u2, ud, central, a1, a2, alpha, dout.contiguous(),
            ctx.negative_slope)
        du = fused_kernels.slot_reduce(ctx.lay, dm, u1.shape[0])
        return (None, du[:, :d], du[:, d:], dud, None, da[:d], da[d:],
                None)


def attention_sel(
    lay: PaddedLayout,
    u1: torch.Tensor,         # [N, D] messages when dst is central
    u2: torch.Tensor,         # [N, D] messages when dst is target
    central: torch.Tensor,    # [N_out] bool destination-domain flag
    a1: torch.Tensor,         # [D] logit vector, central destinations
    a2: torch.Tensor,         # [D] logit vector, target destinations
    negative_slope: float = 0.1,
) -> torch.Tensor:
    """Branch-selected attention over one padded layout (the selective
    kernels). Returns [N_out, D]."""
    n_out = central.shape[0]
    ud = torch.where(central[:, None], u1[:n_out], u2[:n_out])
    return AttentionSel.apply(lay, u1, u2, ud, central, a1, a2,
                              negative_slope)


def adapted_attention_tiered(
    tops: TieredOps,
    u1: torch.Tensor,         # [N_in, D] messages when dst is central
    u2: torch.Tensor,         # [N_in, D] messages when dst is target
    central: torch.Tensor,    # [N_out] bool destination-domain flag
    a1: torch.Tensor,         # [D] logit vector, central destinations
    a2: torch.Tensor,         # [D] logit vector, target destinations
    negative_slope: float = 0.1,
) -> torch.Tensor:
    """Attention over degree-tiered layouts: the concatenated kernels run
    once per tier on that tier's destination rows. One row permutation
    takes the destination rows into tier-concat order and its inverse
    takes the outputs back. Same per-destination softmax as the single
    layout, different padding only."""
    nb = tops.node_block
    n_full = tops.row_order.shape[0]

    def fit_dst(u):
        # destination-side rows: pad up or slice down to the dst space
        if u.shape[0] < n_full:
            pad = u.new_zeros((n_full - u.shape[0],) + tuple(u.shape[1:]))
            return torch.cat([u, pad], dim=0)
        return u[:n_full]

    c_p = fit_dst(central)[tops.row_order]
    ud_p = torch.where(c_p[:, None], fit_dst(u1)[tops.row_order],
                       fit_dst(u2)[tops.row_order])
    outs = []
    for ops_t, (b0, b1) in zip(tops.tiers, tops.tier_spans):
        sl = slice(b0 * nb, b1 * nb)
        outs.append(AttentionCat.apply(
            ops_t.lay_dst, u1, u2, ud_p[sl], c_p[sl], a1, a2,
            negative_slope))
    cat = torch.cat(outs, dim=0)                  # tier-concat order
    return cat[tops.inv_order][: central.shape[0]]
