"""KT-GNN: domain-adapted attention message passing.

Port of ``bridged_gnn_tpu/nn/ktgnn.py`` (reference models/KTGNN.py):
``AdaptedConv`` with its single-layout and degree-tiered fused attention
branches and the optional root weight (``lin_r``), ``ClfTransformer``,
``KTGNN`` without the feature complementor, and ``KTGNNNoDTC``, the
single-head stack (reference KTGNN_noDTC). Quirks kept from the
reference:

* ``lin_t`` acts on ``x_s2t`` and ``lin_s`` on ``x_t2s``;
* central destinations attend over ``x_t2s`` messages with ``a_f_t2s``,
  target destinations over ``x_s2t`` with ``a_f_s2t``;
* ``clf_target`` is one conv applied twice (to the embeddings and to the
  transformed embeddings);
* all three heads are log-softmax.

The attention runs through ``ops/fused_attention.py``: the selective
kernels on a single padded layout, the concatenated kernels per tier on
degree-tiered layouts, forward and backward. Dropout in train mode draws
its masks from a ``torch.Generator`` the caller passes, on the model's
device, never from the global generator.

``msg_dtype="bfloat16"`` (JAX ``msg_dtype``, the production stage-2
setting) casts each conv's two linear outputs, the message tables, to
bf16 before the attention and casts the attention's output back to the
input's dtype; parameters, the gated shifts, batch norm and the heads
stay f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bridged_gnn_tpu_torch.graph import Graph
from bridged_gnn_tpu_torch.nn.common import (
    MaskedBatchNorm,
    TorchLinear,
    dropout,
    masked_mean,
    uniform_fan_in_,
)
from bridged_gnn_tpu_torch.ops.fused_attention import (
    adapted_attention_tiered,
    attention_sel,
)
from bridged_gnn_tpu_torch.ops.spmm import Adjacency

# the message dtypes the attention kernels take (None: the input's, f32)
MSG_DTYPES = {None: None, "bfloat16": torch.bfloat16}


class AdaptedConv(nn.Module):
    """Domain-adapted attention conv (reference models/KTGNN.py:218-328).
    ``msg_dtype``: the dtype of the attention's message tables (JAX
    ``nn/ktgnn.py:124-126``); None keeps the input's. ``root_weight``
    adds ``lin_r(x)`` (no bias) to the output (JAX :241-243)."""

    def __init__(self, in_channels: int, out_channels: int,
                 negative_slope: float = 0.1, *,
                 root_weight: bool = False,
                 msg_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.negative_slope = negative_slope
        if msg_dtype not in MSG_DTYPES:
            raise ValueError(f"msg_dtype must be one of {list(MSG_DTYPES)}, "
                             f"got {msg_dtype!r}")
        self.msg_dtype = MSG_DTYPES[msg_dtype]
        g = generator
        self.a_g_s2t = TorchLinear(2 * in_channels, 1, bias=False,
                                   generator=g)
        self.a_g_t2s = TorchLinear(2 * in_channels, 1, bias=False,
                                   generator=g)
        self.lin_t = TorchLinear(in_channels, out_channels, generator=g)
        self.lin_s = TorchLinear(in_channels, out_channels, generator=g)
        # GATv2 logit vectors: a_f_t2s for central destinations (a1),
        # a_f_s2t for target destinations (a2)
        self.a_f_t2s = nn.Parameter(
            uniform_fan_in_(torch.empty(out_channels), out_channels, g))
        self.a_f_s2t = nn.Parameter(
            uniform_fan_in_(torch.empty(out_channels), out_channels, g))
        self.lin_r = (TorchLinear(in_channels, out_channels, bias=False,
                                  generator=g) if root_weight else None)

    def forward(self, x: torch.Tensor, adj: Adjacency,
                central_mask: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        central = central_mask & node_mask
        target = (~central_mask) & node_mask

        # --- g: domain difference and gated shifts (KTGNN.py:275-281)
        mean_c = masked_mean(x, central, dim=0, keepdim=True)    # [1, D]
        mean_t = masked_mean(x, target, dim=0, keepdim=True)
        dd = (mean_c - mean_t).expand_as(x)
        gcat = torch.cat([x, dd], dim=-1)
        shift_s2t = torch.tanh(self.a_g_s2t(gcat)) * dd
        shift_t2s = torch.tanh(self.a_g_t2s(gcat)) * dd
        x_s2t = x - shift_s2t * central[:, None].to(x.dtype)
        x_t2s = x + shift_t2s * target[:, None].to(x.dtype)

        # --- f: two linear paths (KTGNN.py:283-284)
        u_s2t = self.lin_t(x_s2t)
        u_t2s = self.lin_s(x_t2s)
        if self.msg_dtype is not None:
            u_s2t = u_s2t.to(self.msg_dtype)
            u_t2s = u_t2s.to(self.msg_dtype)

        # --- fused attention + segment softmax + aggregation
        if adj.fast_fn is not None:
            out = attention_sel(
                adj.fast_fn.lay_dst, u_t2s, u_s2t, central_mask,
                self.a_f_t2s, self.a_f_s2t, self.negative_slope,
            )
        elif adj.tiered_fn is not None:
            out = adapted_attention_tiered(
                adj.tiered_fn, u_t2s, u_s2t, central_mask,
                self.a_f_t2s, self.a_f_s2t, self.negative_slope,
            )
        else:
            raise ValueError(
                "AdaptedConv needs a blocked or tiered adjacency")
        out = out.to(x.dtype)
        if self.lin_r is not None:
            out = out + self.lin_r(x)
        return out


class ClfTransformer(nn.Module):
    """Linear → BN → ReLU → Linear head adapter (KTGNN.py:363-368)."""

    def __init__(self, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_0 = TorchLinear(hidden, hidden, generator=generator)
        self.bn_1 = MaskedBatchNorm(hidden)
        self.lin_3 = TorchLinear(hidden, hidden, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.lin_0(x)
        x = torch.relu(self.bn_1(x, mask))
        return self.lin_3(x)


class KTGNN(nn.Module):
    """KTGNN_no_complement (reference models/KTGNN.py:330-465).

    ``forward`` returns the log-probabilities of the three heads
    ``(base, target, target_hat)``; ``embed`` the final node embeddings.
    Train/eval mode follows ``nn.Module.train``/``eval``: dropout and
    batch statistics in train mode, running statistics in eval mode.
    Dropout needs ``generator`` (on the model's device) in train mode
    unless ``dropout`` is 0.

    ``remat=True`` (the trainer's ``memory_policy="lean"``, JAX
    ``nn.remat(AdaptedConv)``) runs each conv of ``embed`` under
    ``torch.utils.checkpoint``: the conv keeps none of its activations,
    and the backward runs its forward again, kernels included. Dropout
    stays outside the conv, so the recompute draws no random numbers.

    ``msg_dtype`` and ``root_weight`` go to every conv, the heads'
    included (JAX ``nn/ktgnn.py:587``, :631-661)."""

    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 64, dropout: float = 0.5,
                 use_bn: bool = True, *, remat: bool = False,
                 root_weight: bool = False,
                 msg_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dropout = dropout
        self.remat = remat
        n_convs = max(layer_num - 1, 1)
        dims = [in_channels] + [hidden] * n_convs
        kw = dict(root_weight=root_weight, msg_dtype=msg_dtype, generator=g)
        self.convs = nn.ModuleList(
            AdaptedConv(dims[i], hidden, **kw) for i in range(n_convs)
        )
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden) for _ in range(n_convs)
        ) if use_bn else None
        self.clf_base = AdaptedConv(hidden, num_classes, **kw)
        self.clf_target = AdaptedConv(hidden, num_classes, **kw)
        self.clf_transformer = ClfTransformer(hidden, generator=g)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """Inverted dropout with the mask drawn from ``generator``."""
        return dropout(x, self.dropout, generator) if self.training else x

    def embed(self, g: Graph, adj: Adjacency,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Final node embeddings (reference get_emb, KTGNN.py:436-465)."""
        cm, nm = g.central_mask, g.node_mask
        x = g.x
        for i, conv in enumerate(self.convs):
            if self.remat and torch.is_grad_enabled():
                # no RNG state to keep: the conv draws no random numbers
                x = checkpoint(conv, x, adj, cm, nm, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = conv(x, adj, cm, nm)
            if self.bns is not None:
                x = self.bns[i](x, nm)
            x = torch.relu(x)
            x = self._dropout(x, generator)
        return x

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cm, nm = g.central_mask, g.node_mask
        x = self.embed(g, adj, generator)
        logits_base = self.clf_base(x, adj, cm, nm)
        x_trans = self.clf_transformer(x, nm)
        logits_target_hat = self.clf_target(x_trans, adj, cm, nm)
        logits_target = self.clf_target(x, adj, cm, nm)
        return (
            torch.log_softmax(logits_base, dim=1),
            torch.log_softmax(logits_target, dim=1),
            torch.log_softmax(logits_target_hat, dim=1),
        )


class KTGNNNoDTC(nn.Module):
    """KTGNN_noDTC (reference models/KTGNN.py:467-597, JAX
    ``nn/ktgnn.py:684-726``): ``layer_num − 1`` AdaptedConvs, the last to
    the classes, with batch norm, ReLU and dropout between them, and one
    log-softmax output ``[N, C]``. ``msg_dtype`` and ``root_weight`` go to
    every conv; dropout draws from ``generator`` in train mode."""

    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 64,
                 root_weight: bool = False, dropout: float = 0.5,
                 use_bn: bool = True, *, msg_dtype: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        n = layer_num - 1
        dims = [in_channels] + [hidden] * (n - 1) + [num_classes]
        self.convs = nn.ModuleList(
            AdaptedConv(dims[i], dims[i + 1], root_weight=root_weight,
                        msg_dtype=msg_dtype, generator=generator)
            for i in range(n))
        self.bns = nn.ModuleList(
            MaskedBatchNorm(hidden) for _ in range(n - 1)
        ) if use_bn else None

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cm, nm = g.central_mask, g.node_mask
        x = g.x
        for i, conv in enumerate(self.convs):
            x = conv(x, adj, cm, nm)
            if i < len(self.convs) - 1:
                if self.bns is not None:
                    x = self.bns[i](x, nm)
                x = torch.relu(x)
                if self.training:
                    x = dropout(x, self.dropout, generator)
        return torch.log_softmax(x, dim=1)
