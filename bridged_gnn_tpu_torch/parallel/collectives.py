"""Collectives the sharded stage-2 runtime differentiates through.

The JAX package's ``psum`` inside ``shard_map`` transposes to a sum of
the cotangents over the mesh axis. :func:`all_reduce_sum` is that on
``torch.distributed``: forward an all-reduce (SUM), backward an all-reduce
(SUM) of the gradient. With it, a rank's backward through a statistic
summed over ranks (a masked mean, batch-norm moments, a softmax
denominator) gives that rank's share of the gradient, and the shares of
all ranks sum to the gradient of the whole graph, which the runtime
forms with one all-reduce of the parameter gradients after the backward
(``parallel/stage2_runtime.py``). No loss is all-reduced with autograd:
that and the gradient all-reduce would count every gradient once per
rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, differentiable (the
    gradient is all-reduced too)."""
    return _AllReduceSum.apply(t.contiguous(), group)


def sum_over(group, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each tensor summed over the group's ranks, in one all-reduce of
    their concatenation; differentiable, same shapes and dtype as given
    (all of one dtype)."""
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return tuple(out)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the group's ranks, outside
    autograd (it only shifts a softmax, whose gradient does not depend on
    the shift)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
