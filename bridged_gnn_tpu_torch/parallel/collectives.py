"""Collectives the sharded runtimes differentiate through.

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

:func:`all_gather_rows` is the row-sharded stage 1's
(``parallel/gspmd.py``): forward, every rank's rows concatenated
rank-major; backward, the cotangent summed over the ranks and each rank
keeping its own rows (a reduce-scatter). Every rank then holds the whole
loss and backpropagates ``1/n`` of it, so the summed cotangent of a row
is that row's gradient once, and :class:`GradAllReduce` sums the
parameters' shares.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.utils.profiling import collective_span


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        with collective_span("all_reduce"):
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        with collective_span("all_reduce"):
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
    with collective_span("all_reduce_max"):
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _nccl(group) -> bool:
    return dist.get_backend(group) == "nccl"


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        n = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        with collective_span("all_gather"):
            if _nccl(group):
                dist.all_gather_into_tensor(out, x, group=group)
            else:
                # gloo: the list form, on CPU and CUDA tensors alike
                dist.all_gather(list(out.chunk(n)), x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        rows, group = ctx.rows, ctx.group
        if _nccl(group):
            out = grad.new_empty((rows,) + tuple(grad.shape[1:]))
            with collective_span("reduce_scatter"):
                dist.reduce_scatter_tensor(out, grad, group=group)
            return out, None
        # gloo has no reduce-scatter: the whole sum, then this rank's rows
        full = grad.clone()
        with collective_span("all_reduce"):
            dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
        q = dist.get_rank(group)
        return full[q * rows:(q + 1) * rows].contiguous(), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [rows, ...] concatenated rank-major [n·rows,
    ...]; differentiable, the gradient summed over the ranks and split
    back by rows (NCCL's reduce-scatter; under gloo an all-reduce and a
    slice)."""
    return _AllGatherRows.apply(x, group)


class GradAllReduce:
    """Sums the gradients of ``params`` over the group's ranks in one
    all-reduce of a flat buffer allocated once, so a CUDA graph's replays
    find every gradient at the address they were captured with; after
    the call each ``p.grad`` is a view of the buffer (a parameter without
    a gradient adds zeros)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], group):
        self.params = [p for p in params if p.requires_grad]
        self.group = group
        self.n = dist.get_world_size(group)
        self.flat = torch.zeros(sum(p.numel() for p in self.params),
                                dtype=self.params[0].dtype,
                                device=self.params[0].device)

    def __call__(self) -> None:
        torch.cat([(p.grad if p.grad is not None
                    else torch.zeros_like(p)).reshape(-1)
                   for p in self.params], out=self.flat)
        with collective_span("all_reduce_grads"):
            dist.all_reduce(self.flat, op=dist.ReduceOp.SUM,
                            group=self.group)
        k = 0
        for p in self.params:
            p.grad = self.flat[k:k + p.numel()].view_as(p)
            k += p.numel()
