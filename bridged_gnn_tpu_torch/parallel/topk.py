"""Sharded all-pairs top-k: the bridge build's column-split top-k.

Port of ``bridged_gnn_tpu/parallel/topk.py``. Each rank of a process
group owns ``c_pad / n`` of the source (column) embeddings, zero-padded
and masked past ``num_cols``, and runs the blockwise top-k of
``ops/sddmm.py`` on them for every target row with ``min(k, c_local)``;
its column ids are offset to global ones, every rank's candidates are
all-gathered rank-major, and one final top-k (:func:`~bridged_gnn_tpu_
torch.ops.sddmm.topk_lower_index`) merges them: among equal values the
lower global column comes first, as ``lax.top_k``'s merge of the JAX
package keeps it. Every rank returns the same values and columns.

The rerank form (``rerank_candidates``, mlp head) screens each shard's
own columns with the bf16 cosine proxy and scores the exact head at the
shard's top ``M``: its answer is the JAX sharded function's, which may
keep more candidates than the single device's screen.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.graph import round_up
from bridged_gnn_tpu_torch.ops.sddmm import (
    blockwise_pair_scores_topk,
    blockwise_rerank_topk,
    cosine_score_block,
    mlp_score_candidates,
    pair_mlp_score_block,
    topk_lower_index,
)

Tensor = torch.Tensor


def _all_gather_cols(t: Tensor, group) -> Tensor:
    """Every rank's ``t`` [R, k] side by side, rank-major: [R, n·k]."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def sharded_pair_topk(
    group,
    a_rows: Tensor,
    b_cols: Tensor,
    num_rows: int,
    num_cols: int,
    k: int,
    mode: str = "cosine",
    mlp_bias1: Optional[Tensor] = None,
    mlp_w2: Optional[Tensor] = None,
    mlp_b2: Optional[float] = None,
    row_block: int = 512,
    approx_recall: Optional[float] = None,
    rerank_candidates: Optional[int] = None,
    z_rows: Optional[Tensor] = None,
    z_cols: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """(values [num_rows, k], int64 global columns [num_rows, k]), the
    same on every rank of ``group`` (JAX ``sharded_pair_topk``).

    ``a_rows`` [R, H] and ``b_cols`` [C, H] are the head's row and column
    sides (the cosine head's folded embeddings, or the mlp head's per-side
    projections with ``mlp_bias1``, ``mlp_w2`` and ``mlp_b2``), whole on
    every rank; this rank scores its slice of the columns. With
    ``rerank_candidates`` (``mode="mlp"``) ``z_rows``/``z_cols``, the raw
    embeddings, give the bf16 proxy each shard screens with."""
    if rerank_candidates is not None and (
            mode != "mlp" or z_rows is None or z_cols is None):
        raise ValueError(
            "rerank_candidates requires mode='mlp' with z_rows/z_cols")
    n = dist.get_world_size(group)
    q = dist.get_rank(group)
    c_pad = round_up(max(num_cols, 1), n)
    c_local = c_pad // n
    lo = q * c_local
    hi = min(lo + c_local, num_cols)
    dev = a_rows.device

    def shard(cols: Tensor) -> Tensor:
        """This rank's ``c_local`` columns, zero past ``num_cols``."""
        out = cols.new_zeros((c_local,) + tuple(cols.shape[1:]))
        if hi > lo:
            out[: hi - lo] = cols[lo:hi]
        return out

    valid = torch.arange(lo, lo + c_local, device=dev) < num_cols
    k_local = min(k, c_local)
    if rerank_candidates is not None:
        proxy = cosine_score_block(z_rows.float().bfloat16(),
                                   shard(z_cols.float()).bfloat16())
        exact = mlp_score_candidates(a_rows, shard(b_cols), mlp_bias1,
                                     mlp_w2, mlp_b2)
        vals, idxs = blockwise_rerank_topk(
            proxy, exact, num_rows, c_local, k_local,
            candidates=min(int(rerank_candidates), c_local),
            row_block=row_block, col_mask=valid,
            approx_recall=approx_recall, device=dev)
    else:
        if mode == "cosine":
            fn = cosine_score_block(a_rows, shard(b_cols))
        elif mode == "mlp":
            fn = pair_mlp_score_block(a_rows, shard(b_cols), mlp_bias1,
                                      mlp_w2, mlp_b2)
        else:
            raise ValueError(mode)
        vals, idxs = blockwise_pair_scores_topk(
            fn, num_rows, c_local, k_local, row_block=row_block,
            col_mask=valid, approx_recall=approx_recall, device=dev)
    # the k-way merge: every shard's candidates, one final top-k
    vals_all = _all_gather_cols(vals, group)
    idx_all = _all_gather_cols(idxs + lo, group)
    mvals, pos = topk_lower_index(vals_all, k)
    return mvals, idx_all.gather(1, pos)
