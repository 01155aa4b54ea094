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
``u1``/``u2``. The Functions save their inputs, per-slot scalars
(``ex`` and ``den``, or ``alpha``) as the JAX custom VJPs do, and their
[n_out, D] output, from which the backward kernels take each
destination's softmax term ``dout · out`` instead of a second pass over
its slots.

Message dtype (JAX ``Stage2Config.message_dtype``). The tables ``u1``,
``u2`` and ``ud`` may be bfloat16. The kernels then read bf16 rows, sum in
f32 and return an f32 output; each Function saves that f32 output for its
backward and returns it rounded to the tables' dtype, as JAX's
``out.astype(u1.dtype)`` (ops/fused_attention.py:151, :607). The backward
takes the cotangent in f32, the kernel writes ``dm`` in bf16, and the
gradients come back in each input's dtype: the tables' for ``u1``, ``u2``
and ``ud``, f32 for ``a1`` and ``a2``.
"""

from __future__ import annotations

from typing import Callable

import torch

from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.ops.blocked_segment import (
    PaddedLayout,
    TieredOps,
    slot_rows,
)
from bridged_gnn_tpu_torch.ops.padded_spmm import PaddedSpmm

_NEG = -1e30


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
        ctx.save_for_backward(u1, u2, ud, central, a1, a2, ex, den, out)
        ctx.lay, ctx.negative_slope = lay, negative_slope
        return out.to(u1.dtype)

    @staticmethod
    def backward(ctx, dout):
        u1, u2, ud, central, a1, a2, ex, den, out = ctx.saved_tensors
        dm, dud, da, slot_c = fused_kernels.attention_sel_bwd(
            ctx.lay, u1, u2, ud, central, a1, a2, ex, den, out,
            dout.float().contiguous(), ctx.negative_slope)
        return _grads(ctx.lay, u1, ud, dm, dud, da, slot_c)


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
        d = u1.shape[1]
        out = torch.where(central[:, None], out2[:, :d], out2[:, d:])
        ctx.save_for_backward(u1, u2, ud, central, a1, a2, alpha, out)
        ctx.lay, ctx.negative_slope = lay, negative_slope
        return out.to(u1.dtype)

    @staticmethod
    def backward(ctx, dout):
        u1, u2, ud, central, a1, a2, alpha, out = ctx.saved_tensors
        dm, dud, da, slot_c = fused_kernels.attention_bwd(
            ctx.lay, u1, u2, ud, central, a1, a2, alpha, out,
            dout.float().contiguous(), ctx.negative_slope)
        return _grads(ctx.lay, u1, ud, dm, dud, da, slot_c)


def _grads(lay, u1, ud, dm, dud, da, slot_c):
    """Both Functions' gradients from their backward kernel's outputs:
    ``du1`` and ``du2`` from one sender-keyed reduce of ``dm`` split by
    slot branch, each table's in its dtype, and ``da1``, ``da2`` in f32."""
    d = u1.shape[1]
    du = fused_kernels.slot_reduce(lay, dm, u1.shape[0], slot_c).to(u1.dtype)
    return (None, du[:, :d], du[:, d:], dud.to(ud.dtype), None, da[:d],
            da[d:], None)


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


def attention_partials(
    lay: PaddedLayout,
    u_cat: torch.Tensor,       # [N_src, 2D] rows the slots gather, [u1‖u2]
    u_dst_cat: torch.Tensor,   # [N_out, 2D] destination-side rows
    central: torch.Tensor,     # [N_out] bool
    a1: torch.Tensor,
    a2: torch.Tensor,
    negative_slope: float,
):
    """Streaming-softmax partials over one slot layout that holds a
    subset of the edges into the same destination rows (JAX
    ``_attention_partials``, fused_attention.py:276-332): per destination
    the subset's logit maximum ``mx`` (−1e30 without an edge), exp-sum
    ``den`` and exp-weighted aggregate ``part`` [N_out, D] of its branch.
    The logits are plain PyTorch, as JAX's XLA; the aggregate is the
    destination-keyed padded SpMM (``gather_reduce``) of ``u_cat`` with
    each slot's ``exp`` as its weight, whose backward is the kernel's
    transpose and the weights' plain gradient.

    Cost: the logits, maxima and exp-sums over ``[S, 2D]`` gathered rows
    are not fused as in the attention kernels. On an H100 (``chip_smoke.py``
    phase 27, bench graph, two ranks) an overlap epoch's device time is
    about five times the plain halo form's, 179 ms against 36, so the
    overlap form is expected to lose to it unless the exchange it hides
    takes longer than that difference."""
    n_out, dch = central.shape[0], u_cat.shape[1] // 2
    row, valid = slot_rows(lay)
    # index_select: its backward is an index_add_, not the sorting
    # accumulate of an indexing backward
    m = u_cat.index_select(0, lay.slot_src.clamp(min=0))    # [S, 2D]
    d = u_dst_cat.index_select(0, row)
    h1 = torch.nn.functional.leaky_relu(m[:, :dch] + d[:, :dch],
                                        negative_slope)
    h2 = torch.nn.functional.leaky_relu(m[:, dch:] + d[:, dch:],
                                        negative_slope)
    is_c = central[row]
    lm = torch.where(valid, torch.where(is_c, h1 @ a1, h2 @ a2), _NEG)
    mx = lm.new_full((n_out,), _NEG).scatter_reduce(
        0, row, lm.detach(), reduce="amax")
    ex = torch.where(valid, torch.exp(lm - mx[row]), 0.0)
    den = ex.new_zeros(n_out).index_add(0, row, ex)
    part2 = PaddedSpmm.apply(lay, u_cat.contiguous(), ex)  # [N_out, 2D]
    part = torch.where(central[:, None], part2[:, :dch], part2[:, dch:])
    return part, mx, den


def adapted_attention_overlap(
    lay_local: PaddedLayout,
    lay_halo: PaddedLayout,
    u_cat_local: torch.Tensor,  # [R, 2D] own-row branch values [u1 ‖ u2]
    halo_rows: Callable[[], torch.Tensor],  # → [H, 2D] halo-row values
    central: torch.Tensor,      # [R] bool destination-domain flag
    a1: torch.Tensor,
    a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> torch.Tensor:
    """The comm/compute-overlap form of the attention for the halo row
    partition (JAX ``adapted_attention_overlap``, fused_attention.py:
    335-389). ``lay_local`` holds the shard's edges whose sender is one
    of its own rows, ``lay_halo`` those whose sender is in the halo
    receive buffer, both keyed by the shard's destination rows. The local
    partials need nothing from the exchange, so they run first; then
    ``halo_rows()``, which completes the exchange and gives the halo
    rows' ``[u1 ‖ u2]``, and the halo partials. The
    two combine by the flash-attention rule
    ``out = (p_l·s_l + p_h·s_h) / (den_l·s_l + den_h·s_h)`` with
    ``s_k = exp(mx_k − max(mx_l, mx_h))``: the softmax of the whole edge
    set, summed in another order. Tables in bf16 are widened to f32 for
    the partials (JAX sums them in f32 too); the output is in
    ``u_cat_local``'s dtype."""
    dtype = u_cat_local.dtype
    u_dst = u_cat_local.float()
    p_l, mx_l, den_l = attention_partials(lay_local, u_dst, u_dst, central,
                                          a1, a2, negative_slope)
    p_h, mx_h, den_h = attention_partials(lay_halo, halo_rows().float(),
                                          u_dst, central, a1, a2,
                                          negative_slope)
    mx = torch.maximum(mx_l, mx_h)
    s_l = torch.exp(mx_l - mx)
    s_h = torch.exp(mx_h - mx)
    den = den_l * s_l + den_h * s_h
    den = torch.where(den == 0, 1.0, den)
    out = (p_l * s_l[:, None] + p_h * s_h[:, None]) / den[:, None]
    return out.to(dtype)
