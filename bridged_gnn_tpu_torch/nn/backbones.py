"""The stage-2 model zoo (port of ``bridged_gnn_tpu/nn/backbones.py``).

GCN, GraphSAGE, GAT, GATv2, MLP, GIN, JKNet, APPNP, GCN2, DeeperGCN and
ConvNet (reference models/backbones.py). Each model takes the Graph and
its Adjacency and returns per-node log-probabilities ``[N_pad, C]``. On
a blocked or tiered adjacency every ``spmm`` aggregation (GCN,
GraphSAGE, GIN, JKNet, APPNP, GCN2, ConvNet's weighted SpMMs) runs the
padded SpMM kernel, forward and backward; on a dense or gather one the
matmul or the segment sum of ``ops/spmm.py``. GAT, GATv2 and DeeperGCN
aggregate with the segment softmax and sum of ``ops/segment.py``, plain
PyTorch as the JAX package's XLA. Parameter names follow the flax modules
(``convs_{i}``, ``nn_{i}``, ``eps_{i}``, ``lin1``, ``lin_in``,
``node_encoder``, ``msg_{i}``, ``upd_{i}``, ``t_{i}``, ``norm_{i}``, ...)
so that ``io/flax_weights.py`` carries weights across by name; the init
families follow ``glorot_dense`` (:class:`GlorotLinear`) and
``torch_dense`` (:class:`TorchLinear`). Dropout in train mode draws from
the ``generator`` passed to ``forward``.

``ConvNet``/``SplineConv`` are not in either CLI's choices: they need
per-edge pseudo-coordinates, which ``ConvNet.forward`` takes as
``pseudo`` (the trainer passes a graph's ``edge_attr``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bridged_gnn_tpu_torch.graph import Graph
from bridged_gnn_tpu_torch.nn.common import (
    GlorotLinear,
    TorchLinear,
    dropout,
    glorot_,
)
from bridged_gnn_tpu_torch.nn.stage1 import SAGEConv
from bridged_gnn_tpu_torch.ops.segment import segment_softmax, segment_sum
from bridged_gnn_tpu_torch.ops.spmm import Adjacency, spmm

# flax nn.LayerNorm's epsilon (torch.nn.LayerNorm defaults to 1e-5)
FLAX_LAYERNORM_EPS = 1e-6


def gcn_norm_weights(adj: Adjacency) -> torch.Tensor:
    """Symmetric GCN normalization per edge, ``1/√(d_u d_v)``, with the
    self loops already in the degree (PyG ``gcn_norm``); 0 on masked
    edges."""
    dis = torch.rsqrt(adj.in_degree.clamp(min=1.0))
    w = dis[adj.senders] * dis[adj.receivers]
    return torch.where(adj.edge_mask, w, 0.0)


def row_norm_weights(adj: Adjacency) -> torch.Tensor:
    """Row normalization per edge, ``1/d_v`` (0 for a zero degree and on
    masked edges); the reference's ``adj_norm(norm='row')``."""
    deg = adj.in_degree
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)
    return torch.where(adj.edge_mask, inv[adj.receivers], 0.0)


def _layer_dims(layer_num: int, hidden: int, num_classes: int):
    return ([num_classes] if layer_num == 1
            else [hidden] * (layer_num - 1) + [num_classes])


class _Net(nn.Module):
    """Dropout for the zoo's models: in train mode, from ``generator``."""

    def _drop(self, x: torch.Tensor, p: float,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        return dropout(x, p, generator) if self.training else x


class GCNConv(nn.Module):
    """``spmm(Â, lin(x)) + bias`` with the caller's normalized weights."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = GlorotLinear(in_channels, out_channels, bias=False,
                                generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, adj: Adjacency, norm_w) -> torch.Tensor:
        return spmm(adj, self.lin(x), edge_weights=norm_w) + self.bias


class GATConv(nn.Module):
    """Multi-head GAT attention conv (PyG GATConv semantics), GATv1 or,
    with ``v2``, GATv2; attention dropout in train mode from the
    generator passed to ``forward``."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 att_dropout: float = 0.0, v2: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.heads, self.out_channels = heads, out_channels
        self.concat, self.v2 = concat, v2
        self.negative_slope, self.att_dropout = negative_slope, att_dropout
        hc = heads * out_channels
        self.lin = GlorotLinear(in_channels, hc, bias=False, generator=g)
        if v2:
            self.lin_r = GlorotLinear(in_channels, hc, bias=False,
                                      generator=g)
            self.att = nn.Parameter(glorot_(
                torch.empty(heads, out_channels), heads, out_channels, g))
        else:
            self.att_src = nn.Parameter(glorot_(
                torch.empty(heads, out_channels), heads, out_channels, g))
            self.att_dst = nn.Parameter(glorot_(
                torch.empty(heads, out_channels), heads, out_channels, g))
        self.bias = nn.Parameter(torch.zeros(hc if concat else out_channels))

    def forward(self, x, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        h_, c_ = self.heads, self.out_channels
        s, r, em = adj.senders, adj.receivers, adj.edge_mask
        n_pad = adj.num_nodes_padded
        h = self.lin(x).reshape(-1, h_, c_)
        slope = self.negative_slope
        if self.v2:
            hr = self.lin_r(x).reshape(-1, h_, c_)
            e = nn.functional.leaky_relu(h[s] + hr[r], slope)   # [E, H, C]
            logits = torch.einsum("ehc,hc->eh", e, self.att)
        else:
            a_src = torch.einsum("nhc,hc->nh", h, self.att_src)
            a_dst = torch.einsum("nhc,hc->nh", h, self.att_dst)
            logits = nn.functional.leaky_relu(a_src[s] + a_dst[r], slope)
        alpha = segment_softmax(logits, r, n_pad, mask=em)
        if self.training:
            alpha = dropout(alpha, self.att_dropout, generator)
        out = segment_sum(h[s] * alpha[:, :, None], r, n_pad, mask=em)
        out = out.reshape(-1, h_ * c_) if self.concat else out.mean(dim=1)
        return out + self.bias


class GCNNet(_Net):
    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 16,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = [in_channels] + _layer_dims(layer_num, hidden, num_classes)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"convs_{i}", GCNConv(
                dims[i], dims[i + 1], generator=generator))

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        norm_w = gcn_norm_weights(adj)
        x = g.x
        for i in range(self.n):
            x = getattr(self, f"convs_{i}")(x, adj, norm_w)
            if i < self.n - 1:
                x = self._drop(torch.relu(x), self.dropout, generator)
        return torch.log_softmax(x, dim=1)


class GraphSAGENet(_Net):
    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 16,
                 root_weight: bool = True, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = [in_channels] + _layer_dims(layer_num, hidden, num_classes)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.add_module(f"convs_{i}", SAGEConv(
                dims[i], dims[i + 1], root_weight=root_weight,
                generator=generator))

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        x = g.x
        for i in range(self.n):
            x = getattr(self, f"convs_{i}")(x, adj)
            if i < self.n - 1:
                x = self._drop(torch.relu(x), self.dropout, generator)
        return torch.log_softmax(x, dim=1)


class GATNet(_Net):
    """``layer_num − 1`` multi-head GAT convs with ELU, then one
    single-head conv to the classes (reference backbones.py:404-430)."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 16,
                 heads: int = 8, dropout: float = 0.6, v2: bool = False,
                 layer_num: int = 2, att_dropout: float = 0.6, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.layer_num = layer_num
        d = in_channels
        for i in range(layer_num - 1):
            self.add_module(f"convs_{i}", GATConv(
                d, hidden, heads=heads, concat=True,
                att_dropout=att_dropout, v2=v2, generator=generator))
            d = hidden * heads
        self.add_module(f"convs_{layer_num - 1}", GATConv(
            d, num_classes, heads=1, concat=False, att_dropout=att_dropout,
            v2=v2, generator=generator))

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        x = g.x
        for i in range(self.layer_num - 1):
            x = getattr(self, f"convs_{i}")(x, adj, generator)
            x = self._drop(nn.functional.elu(x), self.dropout, generator)
        x = getattr(self, f"convs_{self.layer_num - 1}")(x, adj, generator)
        return torch.log_softmax(x, dim=1)


class MLPNet(_Net):
    """Graph-free MLP (reference backbones.py:214-244)."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 64,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.input_layer = TorchLinear(in_channels, hidden,
                                       generator=generator)
        self.out_layer = TorchLinear(hidden, num_classes,
                                     generator=generator)

    def forward(self, g: Graph, adj: Optional[Adjacency] = None,
                generator: Optional[torch.Generator] = None):
        x = torch.relu(self.input_layer(g.x))
        x = self._drop(x, self.dropout, generator)
        return torch.log_softmax(self.out_layer(x), dim=1)


class GINNet(_Net):
    """GIN with a linear update and a learnable ``eps`` per layer
    (reference backbones.py:26-57)."""

    def __init__(self, num_classes: int, in_channels: int,
                 layer_num: int = 2, hidden: int = 16,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        dims = [in_channels] + _layer_dims(layer_num, hidden, num_classes)
        self.n = len(dims) - 1
        for i in range(self.n):
            self.register_parameter(f"eps_{i}", nn.Parameter(torch.zeros(())))
            self.add_module(f"nn_{i}", TorchLinear(
                dims[i], dims[i + 1], generator=generator))

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        x = g.x
        for i in range(self.n):
            agg = spmm(adj, x) + (1.0 + getattr(self, f"eps_{i}")) * x
            x = getattr(self, f"nn_{i}")(agg)
            if i < self.n - 1:
                x = self._drop(torch.relu(x), self.dropout, generator)
        return torch.log_softmax(x, dim=1)


class JKNet(_Net):
    """GCN stack with jumping-knowledge concatenation (reference
    backbones.py:60-107)."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 16,
                 layer_num: int = 2, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.layer_num = layer_num
        for i in range(layer_num):
            self.add_module(f"convs_{i}", GCNConv(
                in_channels if i == 0 else hidden, hidden,
                generator=generator))
        self.lin = GlorotLinear(hidden * layer_num, num_classes,
                                generator=generator)

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        norm_w = gcn_norm_weights(adj)
        x = g.x
        xs = []
        for i in range(self.layer_num):
            x = torch.relu(getattr(self, f"convs_{i}")(x, adj, norm_w))
            x = self._drop(x, self.dropout, generator)
            xs.append(x)
        return torch.log_softmax(self.lin(torch.cat(xs, dim=1)), dim=1)


class APPNPNet(_Net):
    """MLP and personalized-PageRank propagation, K = 10, α = 0.1
    (reference backbones.py:110-128): ten weighted SpMMs per pass."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 16,
                 K: int = 10, alpha: float = 0.1, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.alpha, self.dropout = K, alpha, dropout
        self.lin1 = TorchLinear(in_channels, hidden, generator=generator)
        self.lin2 = TorchLinear(hidden, num_classes, generator=generator)

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        norm_w = gcn_norm_weights(adj)
        x = self._drop(g.x, self.dropout, generator)
        x = torch.relu(self.lin1(x))
        x = self._drop(x, self.dropout, generator)
        x = h0 = self.lin2(x)
        for _ in range(self.K):
            x = ((1 - self.alpha) * spmm(adj, x, edge_weights=norm_w)
                 + self.alpha * h0)
        return torch.log_softmax(x, dim=1)


class GCN2Net(_Net):
    """GCNII: initial-residual and identity-mapping convs (reference
    backbones.py:163-197), ``x' = ((1-α)Âx + αx₀)((1-β)I + βW)``,
    ``β = log(θ/ℓ + 1)``."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 64,
                 num_layers: int = 8, alpha: float = 0.1,
                 theta: float = 0.5, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_layers, self.alpha, self.theta = num_layers, alpha, theta
        self.dropout = dropout
        self.lin_in = GlorotLinear(in_channels, hidden, generator=g)
        for i in range(num_layers):
            self.add_module(f"convs_{i}", GlorotLinear(
                hidden, hidden, bias=False, generator=g))
        self.lin_out = GlorotLinear(hidden, num_classes, generator=g)

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        norm_w = gcn_norm_weights(adj)
        x = self._drop(g.x, self.dropout, generator)
        x = x0 = torch.relu(self.lin_in(x))
        for layer in range(self.num_layers):
            beta = math.log(self.theta / (layer + 1) + 1.0)
            x = self._drop(x, self.dropout, generator)
            h = ((1 - self.alpha) * spmm(adj, x, edge_weights=norm_w)
                 + self.alpha * x0)
            w = getattr(self, f"convs_{layer}")(h)
            x = torch.relu((1 - beta) * h + beta * w)
        x = self._drop(x, self.dropout, generator)
        return torch.log_softmax(self.lin_out(x), dim=1)


class DeeperGCNNet(_Net):
    """DeeperGCN-style residual stack (reference backbones.py:130-161):
    pre-activation blocks of LayerNorm (flax's ε = 1e-6) → ReLU → a
    softmax-aggregated conv with a learnable temperature per block."""

    def __init__(self, num_classes: int, in_channels: int, hidden: int = 64,
                 num_layers: int = 4, dropout: float = 0.1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_layers, self.dropout = num_layers, dropout
        self.node_encoder = GlorotLinear(in_channels, hidden, generator=g)
        for i in range(num_layers):
            self.add_module(f"norm_{i}", nn.LayerNorm(
                hidden, eps=FLAX_LAYERNORM_EPS))
            self.register_parameter(f"t_{i}", nn.Parameter(torch.ones(())))
            self.add_module(f"msg_{i}", GlorotLinear(hidden, hidden,
                                                     generator=g))
            self.add_module(f"upd_{i}", GlorotLinear(hidden, hidden,
                                                     generator=g))
        self.lin = GlorotLinear(hidden, num_classes, generator=g)

    def _gen_conv(self, h, adj: Adjacency, i: int):
        s, r, em = adj.senders, adj.receivers, adj.edge_mask
        n_pad = adj.num_nodes_padded
        msg_e = torch.relu(getattr(self, f"msg_{i}")(h)[s]) + 1e-7
        w = segment_softmax(msg_e.sum(-1) * getattr(self, f"t_{i}"), r,
                            n_pad, mask=em)
        agg = segment_sum(msg_e * w[:, None], r, n_pad, mask=em)
        return getattr(self, f"upd_{i}")(h + agg)

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None):
        x = self.node_encoder(g.x)
        for i in range(self.num_layers):
            h = torch.relu(getattr(self, f"norm_{i}")(x))
            h = self._drop(h, self.dropout, generator)
            x = x + self._gen_conv(h, adj, i)
        x = self._drop(torch.relu(x), self.dropout, generator)
        return torch.log_softmax(self.lin(x), dim=1)


def spline_basis(pseudo: torch.Tensor, kernel_size,
                 edge_mask: torch.Tensor) -> torch.Tensor:
    """Degree-1 open B-spline basis, densified to ``[E_pad, K]`` (JAX
    ``nn/backbones.py:352-397``; PyG ``SplineConv`` with ``degree=1``,
    ``is_open_spline=True``): pseudo-coordinates clipped to [0, 1] and
    scaled by ``k_i - 1`` per dimension; each edge weights the 2^dim
    surrounding kernel slots with hat functions, slots flattened in
    torch_spline_conv's mixed-radix order (dimension i strides by
    ``prod_{j<i} k_j``); masked edges get 0."""
    if pseudo.dim() == 1:
        pseudo = pseudo[:, None]
    dim = pseudo.shape[1]
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * dim
    if len(kernel_size) != dim:
        raise ValueError(f"kernel_size {kernel_size} for {dim}-dimensional "
                         "pseudo-coordinates")
    strides, k_total = [], 1
    for k_i in kernel_size:
        strides.append(k_total)
        k_total *= k_i
    u = pseudo.float().clamp(0.0, 1.0)
    scaled = u * (torch.tensor(kernel_size, dtype=torch.float32,
                               device=u.device) - 1.0)
    lo = torch.floor(scaled)
    frac = scaled - lo
    lo = lo.long()
    basis = u.new_zeros(u.shape[0], k_total)
    valid = edge_mask.float()
    for corner in range(1 << dim):
        w = valid
        slot = torch.zeros_like(lo[:, 0])
        for i in range(dim):
            bit = (corner >> i) & 1
            w = w * (frac[:, i] if bit else 1.0 - frac[:, i])
            slot = slot + (lo[:, i] + bit).clamp(max=kernel_size[i] - 1) \
                * strides[i]
        basis = basis + w[:, None] * nn.functional.one_hot(
            slot, k_total).float()
    return basis


class SplineConv(nn.Module):
    """Degree-1 B-spline kernel conv (PyG ``SplineConv`` semantics: mean
    aggregation, root weight, bias; JAX ``nn/backbones.py:400-438``):
    ``x @ weight[k]`` for each of the K kernel slots, each aggregated by a
    weighted ``spmm`` with its basis column as the edge weights (the
    padded SpMM kernel on a blocked adjacency), summed, divided by
    ``max(in_degree, 1)``, plus ``root(x)`` and ``bias``. ``weight``
    ``[K, f_in, out]`` has PyG's uniform init, U(±1/√(K·f_in))."""

    def __init__(self, in_channels: int, out_channels: int, dim: int = 1,
                 kernel_size: int = 2, root_weight: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        k = kernel_size ** dim
        bound = 1.0 / math.sqrt(k * in_channels)
        self.weight = nn.Parameter(torch.empty(
            k, in_channels, out_channels).uniform_(-bound, bound,
                                                    generator=generator))
        self.root = (TorchLinear(in_channels, out_channels, bias=False,
                                 generator=generator)
                     if root_weight else None)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, adj: Adjacency,
                pseudo: torch.Tensor) -> torch.Tensor:
        basis = spline_basis(pseudo, self.kernel_size, adj.edge_mask)
        xw = torch.einsum("nf,kfo->kno", x, self.weight)
        agg = sum(spmm(adj, xw[k], edge_weights=basis[:, k])
                  for k in range(xw.shape[0]))
        out = agg / adj.in_degree.clamp(min=1.0)[:, None]
        if self.root is not None:
            out = out + self.root(x)
        return out + self.bias


class ConvNet(_Net):
    """Two-layer SplineConv net (reference backbones.py:199-212; JAX
    ``nn/backbones.py:441-467``): dropout, SplineConv to 16 (dim 1, kernel
    size 2), ELU, dropout, SplineConv to the classes, log-softmax. The
    reference reads the pseudo-coordinates from ``data.edge_attr``, which
    no shipped dataset provides; here they are ``forward``'s ``pseudo``
    ([E_pad] or [E_pad, 1] in [0, 1], in the adjacency's edge order), and
    without them it raises JAX's ValueError."""

    def __init__(self, num_classes: int, in_channels: int,
                 dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = SplineConv(in_channels, 16, generator=generator)
        self.conv2 = SplineConv(16, num_classes, generator=generator)

    def forward(self, g: Graph, adj: Adjacency,
                generator: Optional[torch.Generator] = None,
                pseudo: Optional[torch.Tensor] = None):
        if pseudo is None:
            raise ValueError(
                "ConvNet/SplineConv needs per-edge pseudo-coordinates "
                "(reference data.edge_attr); pass pseudo=[E_pad, dim] "
                "in [0, 1].")
        x = self._drop(g.x, self.dropout, generator)
        x = nn.functional.elu(self.conv1(x, adj, pseudo))
        x = self._drop(x, self.dropout, generator)
        return torch.log_softmax(self.conv2(x, adj, pseudo), dim=1)


_ZOO = {
    "GCN": lambda cfg, c, f, g: GCNNet(c, f, cfg.num_layer, cfg.hidden,
                                       dropout=cfg.dropout, generator=g),
    "GraphSAGE": lambda cfg, c, f, g: GraphSAGENet(
        c, f, cfg.num_layer, cfg.hidden, dropout=cfg.dropout, generator=g),
    "GAT": lambda cfg, c, f, g: GATNet(c, f, cfg.hidden, heads=3,
                                       layer_num=cfg.num_layer, generator=g),
    "GATv2": lambda cfg, c, f, g: GATNet(
        c, f, cfg.hidden, heads=1, v2=True, layer_num=cfg.num_layer,
        att_dropout=0.5, generator=g),
    "MLP": lambda cfg, c, f, g: MLPNet(c, f, cfg.hidden, dropout=cfg.dropout,
                                       generator=g),
    "GIN": lambda cfg, c, f, g: GINNet(c, f, cfg.num_layer, cfg.hidden,
                                       dropout=cfg.dropout, generator=g),
    "JKNet": lambda cfg, c, f, g: JKNet(c, f, cfg.hidden, cfg.num_layer,
                                        dropout=cfg.dropout, generator=g),
    "APPNP": lambda cfg, c, f, g: APPNPNet(c, f, cfg.hidden,
                                           dropout=cfg.dropout, generator=g),
    "GCN2": lambda cfg, c, f, g: GCN2Net(
        c, f, cfg.hidden, num_layers=max(cfg.num_layer, 2), generator=g),
    "DeeperGCN": lambda cfg, c, f, g: DeeperGCNNet(
        c, f, cfg.hidden, num_layers=max(cfg.num_layer, 2), generator=g),
    "ConvNet": lambda cfg, c, f, g: ConvNet(c, f, dropout=cfg.dropout,
                                            generator=g),
}
# the zoo models of the CLIs' --model_name choices: all but ConvNet, which
# needs pseudo-coordinates (JAX has it in neither CLI)
MODEL_NAMES = tuple(m for m in _ZOO if m != "ConvNet")


def build_backbone(name: str, cfg, num_classes: int, in_channels: int,
                   generator: Optional[torch.Generator] = None
                   ) -> nn.Module:
    """The zoo model ``name`` at ``cfg``'s sizes (JAX ``_ZOO``), its init
    drawn from ``generator``."""
    if name not in _ZOO:
        raise NotImplementedError(f"Not Implemented Model: {name}")
    return _ZOO[name](cfg, num_classes, in_channels, generator)
