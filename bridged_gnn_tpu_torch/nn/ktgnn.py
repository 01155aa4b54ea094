"""KT-GNN: domain-adapted attention message passing.

Port of ``bridged_gnn_tpu/nn/ktgnn.py`` (reference models/KTGNN.py):
``AdaptedConv`` with its single-layout and degree-tiered fused attention
branches, its per-edge GATv2 branch on a dense or gather adjacency and
the optional root weight (``lin_r``), ``ClfTransformer``, ``KTGNN`` with
the optional feature complementor (``nn/complementor.py``), and
``KTGNNNoDTC``, the single-head stack (reference KTGNN_noDTC). Quirks
kept from the reference:

* ``lin_t`` acts on ``x_s2t`` and ``lin_s`` on ``x_t2s``;
* central destinations attend over ``x_t2s`` messages with ``a_f_t2s``,
  target destinations over ``x_s2t`` with ``a_f_s2t``;
* ``clf_target`` is one conv applied twice (to the embeddings and to the
  transformed embeddings);
* all three heads are log-softmax.

The attention runs through ``ops/fused_attention.py``: the selective
kernels on a single padded layout, the concatenated kernels per tier on
degree-tiered layouts, forward and backward; on a dense or gather
adjacency it runs per edge in plain PyTorch, as the JAX package's XLA.
Dropout in train mode draws its masks from a ``torch.Generator`` the
caller passes, on the model's device, never from the global generator.

``msg_dtype="bfloat16"`` (JAX ``msg_dtype``, the production stage-2
setting) writes each conv's message tables, the two linear outputs, in
bf16 for the attention (rounded once from f32) and casts the attention's
output back to the input's dtype; parameters, the gated shifts, batch
norm and the heads stay f32. The domain means, gated shifts and linears
before the attention run as ``ops/conv_prologue.py`` (hand-written
kernels around one projection GEMM on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from bridged_gnn_tpu_torch.graph import Graph
from bridged_gnn_tpu_torch.nn.complementor import (
    AdaptedComplementor,
    Frontier,
)
from bridged_gnn_tpu_torch.nn.common import (
    MaskedBatchNorm,
    TorchLinear,
    dropout,
    uniform_fan_in_,
)
from bridged_gnn_tpu_torch.ops.conv_prologue import ConvPrologue
from bridged_gnn_tpu_torch.ops.fused_attention import (
    AttentionCat,
    AttentionSel,
    adapted_attention_overlap,
    adapted_attention_tiered,
    attention_sel,
)
from bridged_gnn_tpu_torch.ops.segment import segment_softmax, segment_sum
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, dense_matrix

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

    def _branch(self, x: torch.Tensor, dd_row: Optional[torch.Tensor],
                central: torch.Tensor, target: torch.Tensor,
                n_sum: Optional[int] = None, group=None):
        """The domain means, the gated domain shifts and the two linear
        paths of rows ``x`` (KTGNN.py:275-284), from one read of ``x``
        (``ops/conv_prologue.py``): ``(u_t2s, u_s2t, dd_row)``, the tables
        in the message dtype. ``dd_row`` None: the means are taken over the
        masked rows of ``x``'s first ``n_sum`` (default all), their sums
        and counts all-reduced over ``group`` when given; else the shift
        ``dd_row`` [D] is given."""
        return ConvPrologue.apply(
            x.contiguous(), dd_row, central, target,
            x.shape[0] if n_sum is None else n_sum, group,
            self.msg_dtype or x.dtype, self.lin_t.weight, self.lin_t.bias,
            self.lin_s.weight, self.lin_s.bias, self.a_g_s2t.weight,
            self.a_g_t2s.weight)

    def forward(self, x: torch.Tensor, adj: Optional[Adjacency],
                central_mask: torch.Tensor,
                node_mask: torch.Tensor, halo=None) -> torch.Tensor:
        """``halo``: a ``parallel.halopart.HaloView`` for the row
        partition, which takes the place of ``adj``."""
        if halo is not None:
            out = self._halo_forward(x, central_mask, node_mask, halo)
        else:
            out = self._forward(x, adj, central_mask, node_mask)
        out = out.to(x.dtype)
        if self.lin_r is not None:
            out = out + self.lin_r(x)
        return out

    def _forward(self, x, adj, central_mask, node_mask):
        central = central_mask & node_mask
        target = (~central_mask) & node_mask
        # --- g and f: domain difference, shifts, two linear paths
        u_t2s, u_s2t, _ = self._branch(x, None, central, target)

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
            out = self._edge_attention(adj, u_t2s, u_s2t, central_mask,
                                       x.dtype)
        return out

    def _halo_forward(self, x, central_mask, node_mask, halo):
        """Row-partitioned forward (JAX ``nn/ktgnn.py:383-541``): this rank
        owns node rows ``[0, R)``. The domain means are global, their sums
        and counts all-reduced (2D + 2 floats); the only node-array
        collective is the boundary exchange (``parallel/halopart.py``).
        Every edge into an owned row is on this rank, so the attention runs
        on the shard's slot layout with the kernels of one device: senders
        in ``x_ext = [own ‖ halo]``, destinations the owned rows. With the
        overlap layouts the exchange starts first and the local prologue
        and partials run while it is in flight
        (``adapted_attention_overlap``)."""
        central_l = central_mask & node_mask
        target_l = (~central_mask) & node_mask
        rows = halo.rows
        central_e = halo.central_ext & halo.node_mask_ext
        target_e = (~halo.central_ext) & halo.node_mask_ext
        if halo.overlap:
            recv, wait = halo.exchange_recv_async(x)
            u_t2s_l, u_s2t_l, dd_row = self._branch(
                x, None, central_l, target_l, group=halo.group)

            def halo_rows():
                wait()
                return torch.cat(self._branch(recv, dd_row, central_e[rows:],
                                              target_e[rows:])[:2], dim=-1)

            return adapted_attention_overlap(
                halo.lay_local, halo.lay_halo,
                torch.cat([u_t2s_l, u_s2t_l], dim=-1), halo_rows,
                central_mask, self.a_f_t2s, self.a_f_s2t,
                self.negative_slope)
        # the ext rows' first `rows` are this rank's own, under the same
        # masks (parallel/halopart.py): the means take those
        u_t2s, u_s2t, _ = self._branch(halo.exchange(x), None, central_e,
                                       target_e, n_sum=rows,
                                       group=halo.group)
        ud = torch.where(central_mask[:, None], u_t2s[:rows], u_s2t[:rows])
        fn = AttentionSel if halo.selective else AttentionCat
        return fn.apply(halo.lay, u_t2s, u_s2t, ud, central_mask,
                        self.a_f_t2s, self.a_f_s2t, self.negative_slope)

    def _edge_attention(self, adj: Adjacency, u_t2s: torch.Tensor,
                        u_s2t: torch.Tensor, central_mask: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
        """GATv2 attention per edge on a dense or gather adjacency (JAX
        ``nn/ktgnn.py:298-360``): logits from ``u[s] + u[r]`` of both
        tables, the one of the destination's domain kept, one segment
        softmax over the receivers; then two matmuls with the weighted
        matrices split by the destination's domain (dense), or the sum of
        the domain-selected messages by receiver (gather). Plain PyTorch,
        as the JAX package's XLA. The matrices are built in ``dtype`` (the
        conv's input) and take the message tables in it; the gather sums
        in the messages' dtype, as JAX does. On the edge-shard layout
        (``adj.group`` set, ``parallel/edgeshard.py``) the edges are this
        rank's span and the softmax's maximum and denominator and the sum
        are all-reduced over the group's ranks (JAX ``axis_name``)."""
        s, r, em = adj.senders.long(), adj.receivers.long(), adj.edge_mask
        dst_central = central_mask[r]
        slope = self.negative_slope
        e_t2s = nn.functional.leaky_relu(u_t2s[s] + u_t2s[r], slope)
        e_s2t = nn.functional.leaky_relu(u_s2t[s] + u_s2t[r], slope)
        logits = torch.where(dst_central,
                             e_t2s.to(self.a_f_t2s.dtype) @ self.a_f_t2s,
                             e_s2t.to(self.a_f_s2t.dtype) @ self.a_f_s2t)
        alpha = segment_softmax(logits, r, adj.num_nodes_padded, mask=em,
                                group=adj.group)
        if adj.dense is not None:
            w1 = torch.where(em & dst_central, alpha, 0.0).to(dtype)
            w2 = torch.where(em & ~dst_central, alpha, 0.0).to(dtype)
            return (dense_matrix(adj, w1) @ u_t2s.to(dtype)
                    + dense_matrix(adj, w2) @ u_s2t.to(dtype))
        msg = torch.where(dst_central[:, None], u_t2s[s], u_s2t[s])
        return segment_sum(msg * alpha[:, None].to(msg.dtype), r,
                           adj.num_nodes_padded, mask=em, group=adj.group)


class ClfTransformer(nn.Module):
    """Linear → BN → ReLU → Linear head adapter (KTGNN.py:363-368)."""

    def __init__(self, hidden: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_0 = TorchLinear(hidden, hidden, generator=generator)
        self.bn_1 = MaskedBatchNorm(hidden)
        self.lin_3 = TorchLinear(hidden, hidden, generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                group=None) -> torch.Tensor:
        x = self.lin_0(x)
        x = torch.relu(self.bn_1(x, mask, group))
        return self.lin_3(x)


class KTGNN(nn.Module):
    """KT-GNN (reference models/KTGNN.py:330-465).

    ``forward`` returns JAX's 4-tuple: the log-probabilities of the three
    heads ``(base, target, target_hat)`` and ``loss_dist``, the
    complementor's distribution loss in train mode with
    ``use_dist_loss`` (else None); ``embed`` the final node embeddings.
    ``need_complement`` puts the feature complementor
    (``nn/complementor.py``) before the convs: it reads the first
    ``dim_share`` features as observed, runs ``step`` frontiers (the
    ``frontiers`` both methods then take) and gives the convs ``hidden_o
    + hidden_u`` features.
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
    included (JAX ``nn/ktgnn.py:587``, :631-661).

    ``halo`` (a ``parallel.halopart.HaloView``; ``adj`` is then None):
    ``g`` holds this rank's rows of the row partition, every conv runs
    its halo forward, the batch norms take their statistics over the
    view's group and dropout draws the masks of all ranks' rows
    (``HaloView.dropout``). The parameters are the single-device ones."""

    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 64, dropout: float = 0.5,
                 use_bn: bool = True, *, remat: bool = False,
                 root_weight: bool = False,
                 msg_dtype: Optional[str] = None,
                 need_complement: bool = False, dim_share: int = 0,
                 hidden_o: int = 128, hidden_u: int = 128, step: int = 1,
                 use_dist_loss: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.dropout = dropout
        self.remat = remat
        self.complementor = AdaptedComplementor(
            dim_share, in_channels - dim_share, hidden_o, hidden_u, step,
            use_dist_loss, generator=g) if need_complement else None
        if need_complement:
            in_channels = hidden_o + hidden_u
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
                 generator: Optional[torch.Generator],
                 halo=None) -> torch.Tensor:
        """Inverted dropout with the mask drawn from ``generator``."""
        if not self.training:
            return x
        if halo is not None:
            return halo.dropout(x, self.dropout, generator)
        return dropout(x, self.dropout, generator)

    def _embed(self, g: Graph, adj: Optional[Adjacency],
               generator: Optional[torch.Generator],
               frontiers: Optional[Sequence[Frontier]], halo=None):
        """The final node embeddings and ``loss_dist``."""
        cm, nm = g.central_mask, g.node_mask
        group = None if halo is None else halo.group
        x, loss_dist = g.x, None
        if self.complementor is not None:
            if frontiers is None:
                raise TypeError("KTGNN with the feature complementor needs "
                                "frontiers (nn/complementor.py)")
            x, loss_dist = self.complementor(x, frontiers, cm, nm,
                                             generator)
        for i, conv in enumerate(self.convs):
            if self.remat and torch.is_grad_enabled():
                # no RNG state to keep: the conv draws no random numbers
                x = checkpoint(conv, x, adj, cm, nm, halo,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = conv(x, adj, cm, nm, halo)
            if self.bns is not None:
                x = self.bns[i](x, nm, group)
            x = torch.relu(x)
            x = self._dropout(x, generator, halo)
        return x, loss_dist

    def embed(self, g: Graph, adj: Adjacency,
              generator: Optional[torch.Generator] = None,
              frontiers: Optional[Sequence[Frontier]] = None
              ) -> torch.Tensor:
        """Final node embeddings (reference get_emb, KTGNN.py:436-465)."""
        return self._embed(g, adj, generator, frontiers)[0]

    def forward(self, g: Graph, adj: Optional[Adjacency],
                generator: Optional[torch.Generator] = None,
                frontiers: Optional[Sequence[Frontier]] = None, halo=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
        cm, nm = g.central_mask, g.node_mask
        x, loss_dist = self._embed(g, adj, generator, frontiers, halo)
        logits_base = self.clf_base(x, adj, cm, nm, halo)
        x_trans = self.clf_transformer(
            x, nm, None if halo is None else halo.group)
        logits_target_hat = self.clf_target(x_trans, adj, cm, nm, halo)
        logits_target = self.clf_target(x, adj, cm, nm, halo)
        return (
            torch.log_softmax(logits_base, dim=1),
            torch.log_softmax(logits_target, dim=1),
            torch.log_softmax(logits_target_hat, dim=1),
            loss_dist,
        )


class KTGNNNoDTC(nn.Module):
    """KTGNN_noDTC (reference models/KTGNN.py:467-597, JAX
    ``nn/ktgnn.py:684-726``): ``layer_num − 1`` AdaptedConvs, the last to
    the classes, with batch norm, ReLU and dropout between them, and one
    log-softmax output ``[N, C]``. ``msg_dtype`` and ``root_weight`` go to
    every conv; dropout draws from ``generator`` in train mode. ``halo``
    runs the row partition as in :class:`KTGNN`."""

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

    def forward(self, g: Graph, adj: Optional[Adjacency],
                generator: Optional[torch.Generator] = None, halo=None
                ) -> torch.Tensor:
        cm, nm = g.central_mask, g.node_mask
        group = None if halo is None else halo.group
        x = g.x
        for i, conv in enumerate(self.convs):
            x = conv(x, adj, cm, nm, halo)
            if i < len(self.convs) - 1:
                if self.bns is not None:
                    x = self.bns[i](x, nm, group)
                x = torch.relu(x)
                if self.training:
                    x = (dropout(x, self.dropout, generator) if halo is None
                         else halo.dropout(x, self.dropout, generator))
        return torch.log_softmax(x, dim=1)
