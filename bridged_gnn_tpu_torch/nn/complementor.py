"""VS-graph feature complementor: completes unobserved target features.

Port of ``bridged_gnn_tpu/nn/complementor.py`` (reference
``Adapted_complementor``/``Adapted_complete_layer``, models/KTGNN.py:22-208):
target-domain nodes observe only a feature prefix; the unobserved suffix
is propagated in from source-domain nodes along BFS frontiers, with a
domain-difference gate on the first (adapted) step.

The frontiers are built once on the host (:func:`build_frontier_edges`,
the reference's ``prepare_graph``) and padded into static-shape device
tensors (:func:`pad_frontiers`), so a CUDA graph captures them. The
frontiers need no destination order (JAX runs them with
``indices_are_sorted=False``): the segment ops of ``ops/segment.py``
take ids in any order. The JAX
package runs this module in XLA segment ops with no
Pallas kernel, so it is plain PyTorch here, on the card as on the CPU.
Parameter names follow the flax modules (``input_layer_o``,
``adapted_layer``, ``lin_f_src_0``, ``layers_{i}``, ...) so that
``io/flax_weights.py`` carries them across by name.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from bridged_gnn_tpu_torch.nn.common import TorchLinear, dropout, masked_mean
from bridged_gnn_tpu_torch.ops.segment import segment_softmax, segment_sum
from bridged_gnn_tpu_torch.utils.platform import resolve_device

# The dropout on the attention coefficients of every step in train mode:
# the JAX package fixes it at the module's default (0.5), whatever the
# model's dropout.
ALPHA_DROPOUT = 0.5

Frontier = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build_frontier_edges(edge_index: np.ndarray, central_mask: np.ndarray,
                         step: int = 2) -> List[np.ndarray]:
    """Per-step frontier edge sets (reference prepare_graph,
    KTGNN.py:166-185): edges from the current source-front into
    still-unreached target nodes; reached targets become the next
    front."""
    mask_src = central_mask.copy()
    mask_tar = ~central_mask
    out = []
    for _ in range(step):
        keep = mask_src[edge_index[0]] & mask_tar[edge_index[1]]
        sub = edge_index[:, keep]
        new_src = np.unique(sub[1])
        out.append(sub)
        mask_tar[new_src] = False
        mask_src[:] = False
        mask_src[new_src] = True
    return out


def pad_frontiers(fronts: Sequence[np.ndarray], num_nodes_padded: int,
                  edge_pad: int = 128, device="cuda") -> List[Frontier]:
    """Each frontier as (senders, receivers, mask) int32/int32/bool
    tensors on ``device``, padded to a multiple of ``edge_pad`` (at least
    one) with masked edges at node ``num_nodes_padded - 1``."""
    dev = resolve_device(device)
    out = []
    for ei in fronts:
        e = ei.shape[1]
        e_pad = max(-(-e // edge_pad) * edge_pad, edge_pad)
        s = np.full(e_pad, num_nodes_padded - 1, dtype=np.int32)
        r = np.full(e_pad, num_nodes_padded - 1, dtype=np.int32)
        m = np.zeros(e_pad, dtype=bool)
        s[:e], r[:e], m[:e] = ei[0], ei[1], True
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (s, r, m)))
    return out


class AdaptedCompleteLayer(nn.Module):
    """One propagation step (reference Adapted_complete_layer,
    KTGNN.py:22-136): importance from the observed features (leaky ReLU of
    ``lin_f_src_0(x_o)[s] + lin_f_tar_0(x_o)[r]``), softmax over each
    receiver's frontier edges, dropout on the coefficients in train mode,
    and the sum of the senders' unobserved features. ``adapted`` adds the
    domain-difference gate: ``add = lin_diff(δ)``, and the source rows'
    messages lose ``lin_g([x_u ‖ add])``."""

    def __init__(self, dim_o: int, dim_u: int, adapted: bool = False,
                 negative_slope: float = 0.1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.adapted = adapted
        self.negative_slope = negative_slope
        self.dropout = ALPHA_DROPOUT
        self.lin_f_src_0 = TorchLinear(dim_o, 1, bias=False, generator=g)
        self.lin_f_tar_0 = TorchLinear(dim_o, 1, bias=False, generator=g)
        if adapted:
            self.lin_diff = TorchLinear(dim_o, dim_u, generator=g)
            self.lin_g = TorchLinear(2 * dim_u, dim_u, bias=False,
                                     generator=g)

    def forward(self, x_o: torch.Tensor, x_u: torch.Tensor,
                frontier: Frontier,
                domain_diff: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``(out [N_pad, D_u], add [1, D_u] or None)``."""
        s, r, em = frontier
        s, r = s.long(), r.long()
        n_pad = x_o.shape[0]
        logits = nn.functional.leaky_relu(
            self.lin_f_src_0(x_o)[s] + self.lin_f_tar_0(x_o)[r],
            self.negative_slope)[:, 0]
        add = None
        message_u = x_u
        if self.adapted:
            add = self.lin_diff(domain_diff[None, :])
            support = self.lin_g(torch.cat([x_u, add.expand_as(x_u)], -1))
            message_u = x_u - support * source_mask[:, None].to(x_u.dtype)
        alpha = segment_softmax(logits, r, n_pad, mask=em)
        if self.training:
            alpha = dropout(alpha, self.dropout, generator)
        out = segment_sum(message_u[s] * alpha[:, None], r, n_pad, mask=em)
        return out, add


class AdaptedComplementor(nn.Module):
    """Reference Adapted_complementor (KTGNN.py:138-208): the observed
    prefix (``dim_o`` features) and the unobserved rest projected to
    ``hidden_o`` and ``hidden_u``; one adapted step over the first
    frontier and a plain step over each later one; central rows keep their
    projected unobserved features, the others take the completed ones.
    Returns ``[N_pad, hidden_o + hidden_u]`` and, in train mode with
    ``use_dist_loss``, the distribution loss (else None)."""

    def __init__(self, dim_o: int, dim_u: int, hidden_o: int = 128,
                 hidden_u: int = 128, step: int = 2,
                 use_dist_loss: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dim_o = dim_o
        self.use_dist_loss = use_dist_loss
        self.input_layer_o = TorchLinear(dim_o, hidden_o, bias=False,
                                         generator=g)
        self.input_layer_u = TorchLinear(dim_u, hidden_u, bias=False,
                                         generator=g)
        self.adapted_layer = AdaptedCompleteLayer(hidden_o, hidden_u,
                                                  adapted=True, generator=g)
        self.layers = nn.ModuleList(
            AdaptedCompleteLayer(hidden_o, hidden_u, generator=g)
            for _ in range(step - 1))

    def forward(self, x: torch.Tensor, frontiers: Sequence[Frontier],
                central_mask: torch.Tensor, node_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        if len(frontiers) != len(self.layers) + 1:
            raise ValueError(f"the complementor takes {len(self.layers) + 1}"
                             f" frontiers, got {len(frontiers)}")
        x_o = self.input_layer_o(x[:, : self.dim_o])
        x_u = self.input_layer_u(x[:, self.dim_o:])
        central = central_mask & node_mask
        target = ~central_mask & node_mask
        delta = masked_mean(x_o, central) - masked_mean(x_o, target)
        x_u_hat, add = self.adapted_layer(x_o, x_u, frontiers[0], delta,
                                          central_mask, generator)
        loss_dist = None
        if self.training and self.use_dist_loss:
            # the new domain difference (central rows against the first
            # front's targets) against the adapted one (KTGNN.py:187-189)
            _, r, em = frontiers[0]
            # the first front's targets: receivers of a real edge (counted
            # without a host sync, so a CUDA graph captures it)
            hits = torch.zeros(central_mask.shape, dtype=torch.int32,
                               device=r.device).index_add_(0, r.long(),
                                                           em.int())
            front = (hits > 0) & ~central_mask
            new_diff = (masked_mean(x_u_hat, central, keepdim=True)
                        - masked_mean(x_u_hat, front, keepdim=True))
            loss_dist = ((new_diff - add) ** 2).mean()
        for layer, fr in zip(self.layers, frontiers[1:]):
            x_u_hat, _ = layer(x_o, x_u_hat, fr, generator=generator)
        cm = central_mask[:, None].to(x_u.dtype)
        return torch.cat([x_o, x_u * cm + x_u_hat * (1 - cm)], 1), loss_dist
