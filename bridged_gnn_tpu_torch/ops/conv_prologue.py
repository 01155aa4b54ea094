"""AdaptedConv's domain-shift prologue, forward and backward, from one read
of its rows.

The prologue (reference models/KTGNN.py:275-284; JAX ``nn/ktgnn.py``,
which XLA fuses) turns a conv's input rows ``x`` [N, D] into its two
message tables. With ``c`` and ``t`` the central and target row masks,
``dd = mean_c(x) − mean_t(x)`` and the gates' weights ``a_g_s2t.weight =
[p_x ‖ p_d]``, ``a_g_t2s.weight = [q_x ‖ q_d]``::

    a     = tanh([x ‖ dd] · a_g_s2t)      b = tanh([x ‖ dd] · a_g_t2s)
    u_s2t = lin_t(x − a·c·dd)             u_t2s = lin_s(x + b·t·dd)

Here the same arithmetic is regrouped so that no full-width table but the
projection is written: ``a = tanh(x·p_x + dd·p_d)``, ``u_s2t = x W_tᵀ +
β_t − (a·c) ⊗ (W_t dd)`` and ``u_t2s = x W_sᵀ + β_s + (b·t) ⊗ (W_s dd)``.
:class:`ConvPrologue` runs it as the kernels of ``ops/fused_kernels.py``
(``conv_prologue_*``) around one projection GEMM ``x [W_t; W_s]ᵀ`` at the
configured matmul precision: a domain pass over ``x`` (both domains'
column sums and counts, and the gate dots ``x·p_x``, ``x·q_x`` in f32), a
one-block finish (``dd``, ``W_t dd``, ``W_s dd``, ``dd·p_d``, ``dd·q_d``),
the GEMM, and an epilogue that writes both tables in the message dtype.
Its backward is one pass over the tables' cotangents (and ``x``), the two
GEMMs ``dW = dYᵀ x`` and, only when ``x`` needs a gradient, ``dx = dY W``,
a one-block finish and the rank-1 terms added to ``dx`` in place. CPU
tensors run the kernels' plain versions, the same regrouped arithmetic in
torch ops. Counts stay on the device and are clamped at 1, as
``masked_mean`` does; nothing reads a count on the host, so an epoch stays
capturable.

Two forms, one Function: with ``dd`` None the means are taken in the
domain pass over ``x``'s first ``n_sum`` rows (with ``group``, their sums
and counts all-reduced over its ranks first, and the cotangent of ``dd``
all-reduced in the backward, as ``masked_mean(group=...)``); with ``dd``
given (the halo rows of the overlap form) the pass only dots the gates,
and ``dd``'s cotangent is returned to it. Both return ``dd``, so that the
overlap form's halo rows take the means of its own rows.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from bridged_gnn_tpu_torch.ops import fused_kernels as fk


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    from bridged_gnn_tpu_torch.parallel.collectives import all_reduce_sum

    return all_reduce_sum(t, group)


class ConvPrologue(torch.autograd.Function):
    """``apply(x, dd, central, target, n_sum, group, out_dtype, wt, bt, ws,
    bs, wg1, wg2)`` → ``(u_t2s, u_s2t, dd)``: the message tables [N, H] in
    ``out_dtype`` and the domain shift [D]. Gradients flow to ``x``, a
    given ``dd`` and the six parameters (``lin_t``'s and ``lin_s``'s
    weights and biases, the gates' weights)."""

    @staticmethod
    def forward(ctx, x, dd, central, target, n_sum, group, out_dtype,
                wt, bt, ws, bs, wg1, wg2):
        own = dd is None
        parts, gd = fk.conv_prologue_pass(x, central, target,
                                          n_sum if own else 0, wg1, wg2)
        if own and group is not None:
            parts = _all_reduce(parts.sum(0, keepdim=True), group)
        dd, aux = fk.conv_prologue_finish(parts if own else None, wg1, wg2,
                                          wt, ws, None if own else dd)
        w = torch.cat([wt, ws])
        u_t2s, u_s2t, ab = fk.conv_prologue_epilogue(
            F.linear(x, w), gd, aux, bt, bs, central, target, out_dtype,
            x.shape[1])
        ctx.save_for_backward(x, central, target, ab, aux, dd, w, wg1, wg2)
        ctx.own, ctx.n_sum, ctx.group = own, n_sum, group
        return u_t2s, u_s2t, dd

    @staticmethod
    def backward(ctx, g_t2s, g_s2t, g_dd):
        x, central, target, ab, aux, dd, w, wg1, wg2 = ctx.saved_tensors
        h = w.shape[0] // 2
        dy, dz, parts = fk.conv_prologue_bwd(
            g_t2s.contiguous(), g_s2t.contiguous(), x, ab, aux, central,
            target)
        dw = dy.t() @ x
        dbt, dbs, dwg1, dwg2, d_dd = fk.conv_prologue_bwd_finish(
            parts, dd, dw, g_dd.contiguous(), w[:h], w[h:], wg1, wg2)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = dy @ w
            if ctx.own and ctx.group is not None:
                d_dd = _all_reduce(d_dd, ctx.group)
            fk.conv_prologue_dx(dx, dz, d_dd, aux, wg1, wg2, central, target,
                                ctx.n_sum if ctx.own else 0)
        return (dx, None if ctx.own else d_dd, None, None, None, None, None,
                dw[:h], dbt, dw[h:], dbs, dwg1, dwg2)

