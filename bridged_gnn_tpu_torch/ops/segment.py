"""Segment reductions over edges keyed by destination node.

Port of ``bridged_gnn_tpu/ops/segment.py``: the scatter-add and
scatter-softmax the GAT, GATv2 and DeeperGCN models aggregate with. The
JAX package computes these in XLA, outside any Pallas kernel, so the
port's are plain PyTorch (``index_add_``, ``scatter_reduce``), on the
card as on the CPU. Every function takes an explicit ``num_segments`` and
an optional validity mask, so padded edges contribute nothing.
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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[s] = Σ_{e: ids[e] = s} data[e]`` over unmasked entries."""
    data = _masked(data, mask, 0.0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


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
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max per segment; masked entries count as −1e30 and a segment
    without entries is −inf (``jax.ops.segment_max``)."""
    data = _masked(data, mask, _NEG_INF)
    idx = segment_ids.long().reshape(
        segment_ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    return out.scatter_reduce(0, idx, data, reduce="amax",
                              include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax within each segment (``torch_geometric.utils.softmax``):
    shifted by the segment's max, detached; masked entries set to −1e30
    before the exp, so they get 0; a zero denominator is replaced by 1."""
    m = segment_max(logits, segment_ids, num_segments, mask)
    m = m.clamp(min=_NEG_INF).detach()
    ids = segment_ids.long()
    shifted = _masked(logits - m[ids], mask, _NEG_INF)
    e = torch.exp(shifted)
    denom = segment_sum(e, ids, num_segments)
    denom = torch.where(denom == 0, 1.0, denom)
    return e / denom[ids]
