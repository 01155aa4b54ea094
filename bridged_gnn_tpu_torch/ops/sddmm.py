"""Blocked all-pairs scoring and row top-k for bridge building (port of
``bridged_gnn_tpu/ops/sddmm.py``).

For every target node, score it against every source node and keep the
top-k (reference main_bridged_graph.py:45-67). The JAX package maps
``lax.top_k`` over row blocks of an implicit score matrix (XLA, no Pallas
kernel). Here the row blocks run in a host loop: a block's scores are a
``torch.matmul`` (cosine head) or the pair-MLP head summed over column
chunks, and its top-k is :func:`topk_lower_index`.

Tie order follows ``lax.top_k``: among equal values the lower column
comes first. ``torch.topk`` promises no order among ties on a card, and
duplicate feature rows (the self-loop-only ``unrelational`` graphs) give
exact ties, so the selection takes every value above the row's k-th and
fills the rest with the lowest columns equal to it, then orders the k by
a stable sort.

``approx_recall`` (``--topk_recall``) is accepted and selects exactly: the
JAX package's ``lax.approx_max_k`` does so on every backend but the TPU
(its sddmm.py:55-56).

Rows are not padded to a block multiple, as the JAX package pads them:
the real rows' results are the same and there are no rows to slice off.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor

_NEG_INF = -1e30
# The live [rows, columns, H] intermediate of one chunk of the pair-MLP
# head is kept within this many bytes: at row block 1000, H = 128 and
# 20,000 source columns the whole intermediate would be 10 GB.
PAIR_CHUNK_BYTES = 1 << 30


def _check_recall(approx_recall: Optional[float]) -> None:
    if approx_recall is not None and not 0.0 < float(approx_recall) <= 1.0:
        raise ValueError(
            f"approx_recall must be in (0, 1], got {approx_recall} "
            "(did you pass a percentage?)")


def topk_lower_index(scores: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """Per-row top-k of ``scores`` [R, C] as ``lax.top_k`` orders it:
    values descending, equal values by ascending column. Returns
    (values [R, k], int64 columns [R, k])."""
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    above = scores > kth
    tied = scores == kth
    need = k - above.sum(1, keepdim=True)
    keep = above | (tied & (torch.cumsum(tied.int(), 1) <= need))
    # nonzero walks each row's columns in ascending order: exactly k a row
    cols = torch.nonzero(keep)[:, 1].reshape(scores.shape[0], k)
    vals, order = torch.sort(scores.gather(1, cols), dim=1, descending=True,
                             stable=True)
    return vals, cols.gather(1, order)


def _valid_columns(scores: Tensor, num_cols: int,
                   col_mask: Optional[Tensor]) -> Tensor:
    """[C] bool: the columns below ``num_cols`` where ``col_mask`` holds."""
    valid = torch.arange(scores.shape[1], device=scores.device) < num_cols
    return valid if col_mask is None else valid & col_mask


def blockwise_pair_scores_topk(
    score_block_fn: Callable[[Tensor], Tensor],
    num_rows: int,
    num_cols: int,
    k: int,
    row_block: int = 512,
    col_mask: Optional[Tensor] = None,
    approx_recall: Optional[float] = None,
    device="cpu",
) -> Tuple[Tensor, Tensor]:
    """Per-row top-k of an implicitly defined score matrix.

    ``score_block_fn`` maps a block of row ids [B] (int64 on ``device``)
    to scores [B, C]; columns at or past ``num_cols``, or where
    ``col_mask`` [C] is False, score -1e30. Returns (values [num_rows,
    k], int64 columns [num_rows, k]) on ``device``."""
    _check_recall(approx_recall)
    vals, idxs = [], []
    for r0 in range(0, num_rows, row_block):
        rows = torch.arange(r0, min(r0 + row_block, num_rows),
                            device=device)
        scores = score_block_fn(rows)
        valid = _valid_columns(scores, num_cols, col_mask)
        v, i = topk_lower_index(
            torch.where(valid[None, :], scores, _NEG_INF), k)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def unit_rows(z: Tensor) -> Tensor:
    """``z / max(‖z‖, 1e-8)`` by rows. A bf16 ``z`` is normalised as XLA
    computes ``jnp.linalg.norm`` of it, so that the rerank's bf16 screen
    keeps the JAX package's candidates: the squares and their sum in f32,
    the sum rounded to bf16, then its square root and the quotient in
    bf16."""
    if z.dtype == torch.bfloat16:
        norm = (z.float() ** 2).sum(-1, keepdim=True).bfloat16().sqrt()
    else:
        norm = torch.linalg.norm(z, dim=-1, keepdim=True)
    return z / norm.clamp(min=1e-8)


def cosine_score_block(z_rows: Tensor, z_cols: Tensor
                       ) -> Callable[[Tensor], Tensor]:
    """Score closure of the cosine head: ``sigmoid(cos(z_rows[i],
    z_cols[j]))``, one matmul of the normalised embeddings per block (the
    caller has folded the biasatt residual in). bf16 inputs (the rerank
    proxy) are normalised in bf16 (:func:`unit_rows`) and multiplied with
    f32 accumulation, as JAX's ``preferred_element_type=float32`` dot."""
    zr, zc = unit_rows(z_rows), unit_rows(z_cols)
    zc_t = zc.float().t()

    def fn(idx_block: Tensor) -> Tensor:
        return torch.sigmoid(zr[idx_block].float() @ zc_t)

    return fn


def _column_chunk(rows: int, dim: int) -> int:
    return max(1, PAIR_CHUNK_BYTES // (4 * max(rows, 1) * max(dim, 1)))


def pair_mlp_score_block(a_rows: Tensor, b_cols: Tensor, bias1: Tensor,
                         w2: Tensor, b2: float
                         ) -> Callable[[Tensor], Tensor]:
    """Score closure of the eval-mode pair-MLP head, decomposed per side
    (:func:`bridge.build.decompose_pair_mlp_head`):
    ``sigmoid(w2 · relu(a_rows[i] + b_cols[j] + bias1) + b2)``.

    The per-pair ReLU makes the H contraction non-factorable, so the
    block's ``[B, C, H]`` intermediate is formed, a chunk of columns at a
    time within :data:`PAIR_CHUNK_BYTES`."""

    def fn(idx_block: Tensor) -> Tensor:
        a = a_rows[idx_block]                              # [B, H]
        step = _column_chunk(a.shape[0], a.shape[1])
        out = []
        for c0 in range(0, b_cols.shape[0], step):
            h = a[:, None, :] + b_cols[None, c0:c0 + step, :]
            out.append(torch.relu_(h.add_(bias1)) @ w2 + b2)
        return torch.sigmoid(torch.cat(out, 1))

    return fn


def mlp_score_candidates(a_rows: Tensor, b_cols: Tensor, bias1: Tensor,
                         w2: Tensor, b2: float
                         ) -> Callable[[Tensor, Tensor], Tensor]:
    """The pair-MLP head of :func:`pair_mlp_score_block` at each row's
    candidate columns only: ``fn(idx_block [B], cand [B, M]) → [B, M]``."""

    def fn(idx_block: Tensor, cand: Tensor) -> Tensor:
        h = a_rows[idx_block][:, None, :] + b_cols[cand]   # [B, M, H]
        return torch.sigmoid(torch.relu_(h.add_(bias1)) @ w2 + b2)

    return fn


def blockwise_rerank_topk(
    proxy_block_fn: Callable[[Tensor], Tensor],
    exact_cand_fn: Callable[[Tensor, Tensor], Tensor],
    num_rows: int,
    num_cols: int,
    k: int,
    candidates: int,
    row_block: int = 512,
    col_mask: Optional[Tensor] = None,
    approx_recall: Optional[float] = None,
    device="cpu",
) -> Tuple[Tensor, Tensor]:
    """Two-phase per-row top-k: the ``candidates`` best columns of a cheap
    proxy, then the exact head at those alone and its top-k, columns
    mapped back. Ties in either phase go to the lower position, as
    ``lax.top_k``'s. With ``candidates >= num_cols`` it is the exact
    sweep. Returns (values [num_rows, k], int64 columns [num_rows, k])."""
    if candidates < k:
        raise ValueError(f"candidates={candidates} < k={k}")
    _check_recall(approx_recall)
    m = min(candidates, num_cols)
    vals, idxs = [], []
    for r0 in range(0, num_rows, row_block):
        rows = torch.arange(r0, min(r0 + row_block, num_rows),
                            device=device)
        proxy = proxy_block_fn(rows)
        valid = _valid_columns(proxy, num_cols, col_mask)
        proxy = torch.where(valid[None, :], proxy, _NEG_INF)
        cand = topk_lower_index(proxy, m)[1]               # [B, M]
        exact = torch.where(valid[cand], exact_cand_fn(rows, cand),
                            _NEG_INF)
        v, pos = topk_lower_index(exact, k)
        vals.append(v)
        idxs.append(cand.gather(1, pos))
    return torch.cat(vals), torch.cat(idxs)
