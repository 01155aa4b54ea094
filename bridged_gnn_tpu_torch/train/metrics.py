"""Evaluation metrics: host-side scores in numpy and scipy, and the
confusion counts that both trainers' scan modes take on the device.

Port of ``bridged_gnn_tpu/train/metrics.py``, which calls scikit-learn
(reference scripts.py:18, main_graph_knowledge_transfer.py:30). The same
results without it: F1 over the label set sklearn uses (every label in
``y_true`` or ``y_pred``), accuracy, and binary ROC-AUC by the rank
formula with tied scores sharing their mean rank. Stage 2 scores its
heads on the splits from the host's predictions (:func:`score_arrays`)
or the device's counts of :data:`TABLES` (:func:`table_scores`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from scipy.stats import rankdata

# The five confusion-count tables of a stage-2 epoch: (head, split) with
# heads 0 source, 1 target, 2 target-hat and splits 0 train, 1 val, 2 test.
# The first three score the splits, the last three the heads on test.
TABLES = ((0, 0), (2, 1), (2, 2), (0, 2), (1, 2))


def _f1_per_label(y_true: np.ndarray, y_pred: np.ndarray, labels):
    """2·tp / (2·tp + fp + fn) per label (0 where the label is absent
    from both, as sklearn's zero_division default gives)."""
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels],
                  dtype=np.float64)
    n_pred = np.array([np.sum(y_pred == c) for c in labels], np.float64)
    n_true = np.array([np.sum(y_true == c) for c in labels], np.float64)
    denom = n_pred + n_true
    return np.divide(2.0 * tp, denom, out=np.zeros_like(tp),
                     where=denom > 0)


def _check_binary(labels: np.ndarray, what: str) -> None:
    if not np.isin(labels, (0, 1)).all():
        raise ValueError(
            f"{what} needs binary labels in {{0, 1}}; got labels "
            f"{labels.tolist()}")


def eval_metric(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    metric: str = "f1",
    f1_average: str = "macro",
    probs_pos: Optional[np.ndarray] = None,
) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if metric == "f1":
        labels = np.union1d(y_true, y_pred)
        if f1_average == "macro":
            if len(labels) == 0:
                return 0.0
            return float(_f1_per_label(y_true, y_pred, labels).mean())
        if f1_average == "binary":
            _check_binary(labels, "f1_average='binary'")
            return float(_f1_per_label(y_true, y_pred, [1])[0])
        raise ValueError(f"unknown f1_average: {f1_average!r}")
    if metric == "auc":
        if probs_pos is None:
            raise ValueError("metric 'auc' needs probs_pos")
        labels = np.unique(y_true)
        _check_binary(labels, "metric 'auc'")
        if len(labels) != 2:
            raise ValueError(
                "metric 'auc' is undefined with one class in y_true")
        pos = y_true == 1
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        ranks = rankdata(np.asarray(probs_pos, dtype=np.float64))
        return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                     / (n_pos * n_neg))
    if metric == "acc":
        return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0
    raise ValueError(f"unknown metric: {metric}")


def score_from_counts(
    tp: np.ndarray,
    pred_cnt: np.ndarray,
    true_cnt: np.ndarray,
    metric: str = "f1",
    f1_average: str = "macro",
) -> float:
    """`eval_metric` computed from per-class confusion counts.

    Bin layout: bin c < C is class c; the final bin C holds y == -1 rows
    (never predicted), which sklearn treats as a label of its own, so the
    macro mean runs over the bins present in y_true or y_pred, exactly
    sklearn's label set. The arithmetic is `eval_metric`'s: F1 per label
    is ``2·tp / (pred + true)`` and the mean takes the labels in sorted
    order, -1 first, so both give the same float on the same rows (the
    JAX package's ``2·P·R / (P + R)`` differs in the last bits)."""
    tp = np.asarray(tp, dtype=np.float64)
    pred_cnt = np.asarray(pred_cnt, dtype=np.float64)
    true_cnt = np.asarray(true_cnt, dtype=np.float64)
    if metric == "acc":
        total = true_cnt.sum()
        return float(tp.sum() / total) if total > 0 else 0.0
    if metric != "f1":
        raise ValueError(
            f"counts-based scoring supports f1/acc, got {metric!r}")
    c = len(tp) - 1
    order = np.r_[c, 0:c]                  # label -1 first, as sorted
    labels = np.r_[-1, 0:c]
    present = ((true_cnt > 0) | (pred_cnt > 0))[order]
    denom = pred_cnt + true_cnt
    f1 = np.divide(2.0 * tp, denom, out=np.zeros_like(tp),
                   where=denom > 0)
    if f1_average == "binary":
        _check_binary(labels[present], "f1_average='binary'")
        return float(f1[1])
    if f1_average != "macro":
        raise ValueError(
            "counts-based scoring supports f1_average in "
            f"{{'macro', 'binary'}}, got {f1_average!r}")
    return float(f1[order][present].mean()) if present.any() else 0.0


def counts_can_score(metric: str, f1_average: str) -> bool:
    """Whether confusion counts can score ``metric``
    (:func:`score_from_counts`): f1 with macro or binary averaging, or
    acc."""
    return metric in ("f1", "acc") and f1_average in ("macro", "binary")


def confusion_counts(preds: torch.Tensor, masks: torch.Tensor,
                     y_bin: torch.Tensor, bins: int) -> torch.Tensor:
    """[T, 3, bins] int64 ``tp``, ``pred`` and ``true`` counts of T
    tables: table t counts the predictions ``preds[t]`` [N] over the rows
    where ``masks[t]`` (int32, 0 or 1) is 1. ``y_bin`` holds each row's
    class, with ``y == -1`` rows in the last bin, which no prediction
    reaches (:func:`score_from_counts`'s layout). As JAX
    ``stage2.py:665-680`` computes them: one-hot rows, the mask multiplied
    in, integer sums over the rows; no atomics and nothing that waits for
    the device."""
    classes = torch.arange(bins, device=y_bin.device)
    true = (y_bin[:, None] == classes).int()                  # [N, bins]
    pred = (preds[:, :, None] == classes).int() * masks[:, :, None]
    return torch.stack([(pred * true).sum(1), pred.sum(1),
                        (masks[:, :, None] * true).sum(1)], 1)


def table_scores(counts: np.ndarray, metric: str, f1_average: str):
    """``(scores, per_head)`` from one epoch's :data:`TABLES` [5, 3, bins]:
    train, val and test by their heads, and every head on test."""
    sc = [score_from_counts(*counts[t], metric=metric, f1_average=f1_average)
          for t in range(len(TABLES))]
    return (dict(train=sc[0], val=sc[1], test=sc[2]),
            dict(source=sc[3], target=sc[4], target_hat=sc[2]))


def score_arrays(preds: np.ndarray, probs: Optional[np.ndarray],
                 y: np.ndarray, masks: Dict[str, np.ndarray], metric: str,
                 f1_average: str):
    """``(scores, per_head)`` of the three heads' predictions [3, N] (and
    positive-class probabilities for auc) on the host: the source head on
    train, the distilled target-hat head on val and test, each head on
    test."""

    def score(head, mask):
        # probs: positive-class probability for auc (reference
        # main_graph_knowledge_transfer.py:88,102 uses column 1)
        return eval_metric(
            y[mask], preds[head][mask], metric, f1_average,
            probs_pos=None if probs is None else probs[head][mask])

    scores = {split: score(0 if split == "train" else 2, mask)
              for split, mask in masks.items()}
    per_head = {name: score(h, masks["test"]) for h, name in
                enumerate(("source", "target", "target_hat"))}
    return scores, per_head
