"""Host-side evaluation metrics, in numpy and scipy.

Port of ``bridged_gnn_tpu/train/metrics.py``, which calls scikit-learn
(reference scripts.py:18, main_graph_knowledge_transfer.py:30). The same
results without it: F1 over the label set sklearn uses (every label in
``y_true`` or ``y_pred``), accuracy, and binary ROC-AUC by the rank
formula with tied scores sharing their mean rank.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.stats import rankdata


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
