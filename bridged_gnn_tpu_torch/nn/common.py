"""Shared NN building blocks (port of ``bridged_gnn_tpu/nn/common.py``).

Statistics-bearing ops take an explicit node validity mask: node arrays
are padded to block multiples, and statistics must be computed over real
rows only. Weights use the torch layout (``weight`` [out, in]);
``io/flax_weights.py`` carries flax ``[in, out]`` kernels across. The two
init families of the JAX package: :class:`TorchLinear` (``torch_dense``,
the torch/PyG default) and :class:`GlorotLinear` (``glorot_dense``, PyG's
glorot). Dropout draws its mask from a generator the caller passes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 0,
                keepdim: bool = False) -> torch.Tensor:
    """Mean over rows where mask is True."""
    m = mask.to(x.dtype).reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    s = (x * m).sum(dim=dim, keepdim=keepdim)
    n = m.sum(dim=dim, keepdim=keepdim)
    return s / n.clamp(min=1.0)


def uniform_fan_in_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator] = None):
    """U(±1/√fan_in): the torch/PyG default Linear init the reference's
    KT-GNN linears use."""
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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout`` in train mode) with the mask
    drawn from ``generator``; the identity at ``p == 0``."""
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError(
            f"train-mode dropout ({p}) needs a torch.Generator on "
            f"{x.device}")
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep * (1.0 / (1.0 - p))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with torch semantics and row-mask-aware batch statistics.

    eps=1e-5, momentum=0.1 (new = (1-m)·old + m·batch), biased variance
    for normalization, unbiased variance for the running estimate. In eval
    mode it normalizes with the running statistics."""

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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if mask is None:
                mask = torch.ones(x.shape[0], dtype=torch.bool,
                                  device=x.device)
            n = mask.to(x.dtype).sum().clamp(min=1.0)
            mean = masked_mean(x, mask, dim=0)
            var = masked_mean((x - mean) ** 2, mask, dim=0)
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
