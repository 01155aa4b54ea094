"""Fused domain-adapted attention message passing (forward).

Port of the kernel forwards of ``bridged_gnn_tpu/ops/fused_attention.py``:
``make_adapted_attention_sel`` on one padded layout (the serving
default, here :func:`attention_sel`), and ``make_adapted_attention`` once
per tier inside :func:`adapted_attention_tiered` on degree-tiered
layouts. The whole attention pass — sender-row gather, GATv2 logits,
per-destination softmax and weighted aggregation — is one kernel launch
per layout (``ops/fused_kernels.py``).

Both compute, for each destination ``v``,
``out[v] = Σ_u softmax_v(a·leaky_relu(u[s] + u[v])) · u[s]`` with the
branch (``u1``/``a1`` when ``central[v]``, else ``u2``/``a2``) chosen by
the destination's domain (reference models/KTGNN.py:263-315). The
destination's own row ``u[v]`` comes from the same table as the senders'.
Forward only: the custom-VJP backwards arrive with the training slice.
"""

from __future__ import annotations

import torch

from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.ops.blocked_segment import PaddedLayout, TieredOps


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
    kernel). Returns [N_out, D]."""
    n_out = central.shape[0]
    ud = torch.where(central[:, None], u1[:n_out], u2[:n_out])
    out, _ex, _den = fused_kernels.attention_sel_fwd(
        lay, u1, u2, ud, central, a1, a2, negative_slope)
    return out


def adapted_attention_tiered(
    tops: TieredOps,
    u1: torch.Tensor,         # [N_in, D] messages when dst is central
    u2: torch.Tensor,         # [N_in, D] messages when dst is target
    central: torch.Tensor,    # [N_out] bool destination-domain flag
    a1: torch.Tensor,         # [D] logit vector, central destinations
    a2: torch.Tensor,         # [D] logit vector, target destinations
    negative_slope: float = 0.1,
) -> torch.Tensor:
    """Attention over degree-tiered layouts: the concatenated kernel runs
    once per tier on that tier's destination rows, and the destination's
    branch is kept here. One row permutation takes the destination rows
    into tier-concat order and its inverse takes the outputs back. Same
    per-destination softmax as the single layout, different padding
    only."""
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
    d = u1.shape[1]
    outs = []
    for ops_t, (b0, b1) in zip(tops.tiers, tops.tier_spans):
        sl = slice(b0 * nb, b1 * nb)
        out2, _alpha = fused_kernels.attention_fwd(
            ops_t.lay_dst, u1, u2, ud_p[sl], c_p[sl], a1, a2,
            negative_slope)
        outs.append(torch.where(c_p[sl, None], out2[:, :d], out2[:, d:]))
    cat = torch.cat(outs, dim=0)                  # tier-concat order
    return cat[tops.inv_order][: central.shape[0]]
