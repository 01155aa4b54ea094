"""Segment reductions over edges keyed by destination node.

Port of ``bridged_gnn_tpu/ops/segment.py``: the scatter-add and
scatter-softmax the GAT, GATv2 and DeeperGCN models, the feature
complementor and the gather adjacency aggregate with. The JAX package
computes these in XLA, outside any Pallas kernel, so the port's are
plain PyTorch (``index_add_`` or ``index_put_``, ``scatter_reduce``), on
the card as on the CPU, with ids in any order. Every function takes an
explicit ``num_segments`` and an optional validity mask, so padded edges
contribute nothing. ``group``: the edges are this rank's span of an edge
array split over the group's ranks (``parallel/edgeshard.py``), and the
per-segment partials are all-reduced (JAX ``axis_name``): sums
differentiably, the softmax's maximum without a gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _masked(data: torch.Tensor, mask: Optional[torch.Tensor],
            fill: float) -> torch.Tensor:
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
    return torch.where(m, data, fill)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
    """``out[s] = Σ_{e: ids[e] = s} data[e]`` over unmasked entries. On the
    card the sum is the sorted accumulate of ``index_put_``, which adds
    each segment's entries in a fixed order (``index_add_`` adds them
    with atomics, in whatever order they land), so a run repeats its
    bits; on the CPU ``index_add_``, which is the deterministic one
    there."""
    data = _masked(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    if data.is_cuda:
        out = out.index_put_((segment_ids.long(),), data, accumulate=True)
    else:
        out = out.index_add_(0, segment_ids.long(), data)
    if group is not None:
        from bridged_gnn_tpu_torch.parallel.collectives import (
            all_reduce_sum,
        )

        out = all_reduce_sum(out, group)
    return out


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`segment_sum` over the count of unmasked entries (at least
    1)."""
    s = segment_sum(data, segment_ids, num_segments, mask)
    ones = torch.ones(segment_ids.shape, dtype=s.dtype, device=s.device)
    cnt = segment_sum(ones, segment_ids, num_segments, mask).clamp(min=1.0)
    return s / cnt.reshape(cnt.shape + (1,) * (s.dim() - cnt.dim()))


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
    """Max per segment; masked entries count as −1e30 and a segment
    without entries is −inf (``jax.ops.segment_max``). With ``group`` the
    maximum over its ranks, detached."""
    data = _masked(data, mask, _NEG_INF)
    idx = segment_ids.long().reshape(
        segment_ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    out = out.scatter_reduce(0, idx, data, reduce="amax",
                             include_self=False)
    if group is not None:
        from bridged_gnn_tpu_torch.parallel.collectives import (
            all_reduce_max,
        )

        out = all_reduce_max(out, group)
    return out


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Softmax within each segment (``torch_geometric.utils.softmax``):
    shifted by the segment's max, detached; masked entries set to −1e30
    before the exp, so they get 0; a zero denominator is replaced by 1."""
    m = segment_max(logits, segment_ids, num_segments, mask, group)
    m = m.clamp(min=_NEG_INF).detach()
    ids = segment_ids.long()
    shifted = _masked(logits - m[ids], mask, _NEG_INF)
    e = torch.exp(shifted)
    denom = segment_sum(e, ids, num_segments, group=group)
    denom = torch.where(denom == 0, 1.0, denom)
    return e / denom[ids]
