"""Shared NN building blocks (port of ``bridged_gnn_tpu/nn/common.py``).

Statistics-bearing ops take an explicit node validity mask: node arrays
are padded to block multiples, and statistics must be computed over real
rows only. Weights use the torch layout (``weight`` [out, in]);
``io/flax_weights.py`` carries flax ``[in, out]`` kernels across. The two
init families of the JAX package: :class:`TorchLinear` (``torch_dense``,
the torch/PyG default) and :class:`GlorotLinear` (``glorot_dense``, PyG's
glorot). Dropout draws its mask from a generator the caller passes.
Stage 1's blocks (JAX ``nn/common.py:42-70, 203-286``): PairNorm, the MLP
backbone, the autoencoder's decoder and the domain discriminator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def _masked_sum_count(x: torch.Tensor, mask: torch.Tensor, dim: int,
                      keepdim: bool, group):
    """The masked sum of ``x`` over ``dim`` and the count of masked rows;
    with ``group``, both summed over its ranks in one all-reduce (JAX
    ``psum`` over ``axis_name``), the sum differentiably."""
    m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    s = (x * m).sum(dim=dim, keepdim=keepdim)
    n = m.sum(dim=dim, keepdim=keepdim)
    if group is not None:
        from bridged_gnn_tpu_torch.parallel.collectives import sum_over

        s, n = sum_over(group, s, n)
    return s, n


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 0,
                keepdim: bool = False, group=None) -> torch.Tensor:
    """Mean over rows where mask is True. With ``group`` (rows split over
    its ranks, ``parallel/halopart.py``) the global mean: sums and counts
    all-reduced, [D]-sized (JAX ``nn/common.py:25-38``)."""
    s, n = _masked_sum_count(x, mask, dim, keepdim, group)
    return s / n.clamp(min=1.0)


def masked_nll(log_probs: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean of -log p(y) over masked nodes (torch F.nll_loss semantics):
    both stages' classifier loss."""
    y_safe = y.clamp(min=0).long()
    picked = log_probs.gather(1, y_safe[:, None])[:, 0]
    m = mask.to(log_probs.dtype)
    return -(picked * m).sum() / m.sum().clamp(min=1.0)


def pair_norm(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
              mode: str = "PN", scale: float = 1.0,
              group=None) -> torch.Tensor:
    """PairNorm (reference models/models.py:29-64; JAX
    ``nn/common.py::pair_norm``). Modes ``"None"``, ``"PN"``, ``"PN-SI"``,
    ``"PN-SCS"``; the column mean and PN's mean row norm are over the
    rows where ``mask`` is True, so padded rows move neither. With
    ``group`` (rows split over its ranks, ``parallel/gspmd.py``) both are
    the global ones: the mean first, then the centred squares' mean."""
    if mode == "None":
        return x
    if mask is None:
        mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    col_mean = masked_mean(x, mask, dim=0, keepdim=True, group=group)
    if mode == "PN":
        xc = x - col_mean
        rown = torch.sqrt(1e-6 + masked_mean((xc * xc).sum(1), mask,
                                             group=group))
        return scale * xc / rown
    if mode == "PN-SI":
        xc = x - col_mean
        rown = torch.sqrt(1e-6 + (xc * xc).sum(1, keepdim=True))
        return scale * xc / rown
    if mode == "PN-SCS":
        rown = torch.sqrt(1e-6 + (x * x).sum(1, keepdim=True))
        return scale * x / rown - col_mean
    raise ValueError(f"unknown PairNorm mode: {mode}")


def uniform_fan_in_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator] = None):
    """U(±1/√fan_in): the torch/PyG default Linear init the reference's
    KT-GNN linears use. A tensor without elements (``fan_in`` 0, as the
    complementor's observed prefix at ``dim_share=0``) is left as it
    is."""
    if t.numel() == 0:
        return t
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator] = None):
    """U(±√(6 / (fan_in + fan_out))): flax ``glorot_uniform``."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator],
            draw_rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout`` in train mode) with the mask
    drawn from ``generator``; the identity at ``p == 0``. ``draw_rows=
    (first, total)`` draws the mask for ``total`` rows and keeps rows
    ``first ..`` (a row partition's rank, ``parallel/halopart.py``)."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError(
            f"train-mode dropout ({p}) needs a torch.Generator on "
            f"{x.device}")
    if draw_rows is None:
        keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    else:
        first, total = draw_rows
        keep = x.new_empty((total,) + tuple(x.shape[1:])).bernoulli_(
            1.0 - p, generator=generator)[first:first + x.shape[0]]
    return x * keep * (1.0 / (1.0 - p))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics and row-mask-aware batch statistics.

    eps=1e-5, momentum=0.1 (new = (1-m)·old + m·batch), biased variance
    for normalization, unbiased variance for the running estimate. In eval
    mode it normalizes with the running statistics. With ``group`` (rows
    split over its ranks) the batch statistics are the global ones, in two
    passes as JAX ``nn/common.py:84-112``: the all-reduced sums and count
    give the mean, then the all-reduced sums of ``(x − mean)²`` the
    variance; every rank updates its running statistics alike."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer(
            "running_mean", torch.zeros(num_features))
        self.register_buffer(
            "running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                mask = torch.ones(x.shape[0], dtype=torch.bool,
                                  device=x.device)
            s, n = _masked_sum_count(x, mask, 0, False, group)
            n = n.clamp(min=1.0)
            mean = s / n
            var = _masked_sum_count((x - mean) ** 2, mask, 0, False,
                                    group)[0] / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class TorchLinear(nn.Module):
    """Linear layer with the torch/PyG default init: weight and bias
    ~ U(±1/√fan_in), drawn from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features))
        uniform_fan_in_(self.weight, in_features, generator)
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            uniform_fan_in_(self.bias, in_features, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


class GlorotLinear(nn.Module):
    """Linear layer with the glorot init of ``glorot_dense`` (flax
    ``glorot_uniform`` kernel, zero bias), drawn from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features))
        glorot_(self.weight, in_features, out_features, generator)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


def _layer_dims(dim_out: int, dim_hidden: int, layer_num: int):
    return ([dim_out] if layer_num == 1
            else [dim_hidden] * (layer_num - 1) + [dim_out])


class MLPBackbone(nn.Module):
    """Stage 1's MLP backbone (reference ``MLP``, models/models.py:852-893;
    JAX ``nn/common.py::MLPBackbone``): Linear → [PairNorm] → ReLU →
    dropout → … → Linear, torch-default init. The dropout rate is JAX's
    constant, 0.5; as in JAX, no config sets it."""

    dropout_p = 0.5

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int = 64,
                 layer_num: int = 2, use_norm: bool = False,
                 norm_mode: str = "PN-SCS", norm_scale: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = _layer_dims(dim_out, dim_hidden, layer_num)
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator=generator)
            for a, b in zip([dim_in] + dims[:-1], dims))
        self.use_norm = use_norm
        self.norm_mode = norm_mode
        self.norm_scale = norm_scale

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, shard=None
                ) -> torch.Tensor:
        """``shard``: a ``parallel.gspmd.RowShard`` when ``x`` holds a
        rank's rows; its mask and group then give PairNorm's statistics
        and its dropout draws the masks of all ranks' rows."""
        group = None
        if shard is not None:
            mask, group = shard.node_mask, shard.group
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                if self.use_norm:
                    x = pair_norm(x, mask, self.norm_mode, self.norm_scale,
                                  group)
                x = torch.relu(x)
                if self.training:
                    x = (dropout(x, self.dropout_p, generator)
                         if shard is None
                         else shard.dropout(x, self.dropout_p, generator))
        return x


class Decoder(nn.Module):
    """The stage-1 autoencoder's decoder (reference models/models.py:
    653-701; JAX ``nn/common.py::Decoder``): ``num_layer - 1`` times Linear
    to ``dim_hidden`` → [PairNorm] → ReLU, then Linear to ``dim_out``."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int,
                 num_layer: int = 2, use_norm: bool = True,
                 norm_mode: str = "PN", norm_scale: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [dim_hidden] * (num_layer - 1) + [dim_out]
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator=generator)
            for a, b in zip([dim_in] + widths[:-1], widths))
        self.use_norm = use_norm
        self.norm_mode = norm_mode
        self.norm_scale = norm_scale

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = lin(x)
            if self.use_norm:
                x = pair_norm(x, mask, self.norm_mode, self.norm_scale)
            x = torch.relu(x)
        return self.layers[-1](x)


_ACTIVATIONS = {
    "relu": torch.relu,
    "leakyrelu": lambda v: nn.functional.leaky_relu(v, 0.2),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


class Discriminator(nn.Module):
    """The domain discriminator (reference models/models.py:753-813; JAX
    ``nn/common.py::Discriminator``): ``num_layer - 1`` times Linear to
    ``dim_hidden`` → activation, then Linear to 1 [→ sigmoid]."""

    def __init__(self, dim_in: int, dim_hidden: int, num_layer: int = 2,
                 act_fn: str = "relu", sigmoid_output: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [dim_hidden] * (num_layer - 1) + [1]
        self.layers = nn.ModuleList(
            TorchLinear(a, b, generator=generator)
            for a, b in zip([dim_in] + widths[:-1], widths))
        self.act = _ACTIVATIONS[act_fn]
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = self.act(lin(x))
        x = self.layers[-1](x)
        return torch.sigmoid(x) if self.sigmoid_output else x
