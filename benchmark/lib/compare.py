"""The numbers that decide ``correct``, as functions of the program's
readings and the reference's.

Training. The start of a run: each step's loss; the first gradient as
the optimizer took it; the parameters' change over the steps. Each later
sampled step, taken from the same state on both sides: its loss, the
parameters' change in it, the scores after it. Norms are compared leaf
by leaf, as the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and stay out of the change.
"""

from __future__ import annotations

import statistics
from typing import Dict, Sequence

import torch

Leaves = Dict[str, torch.Tensor]

ROUNDOFF_LEAF = 1e-3


def _norms(leaves: Leaves, names: Sequence[str]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(leaves[k].double()))
            for k in names}


def norm_gaps(prog: Dict[str, float],
              ref: Dict[str, float]) -> Dict[str, float]:
    """Each leaf's gap over the larger of its reference norm and the
    median leaf's."""
    floor = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in ref}


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def moving_leaves(grad1: Leaves, names: Sequence[str]) -> list:
    """The leaves whose first reference gradient is a thousandth of the
    median leaf's or more."""
    g = _norms(grad1, names)
    floor = statistics.median(g.values())
    return [k for k in names if g[k] >= ROUNDOFF_LEAF * floor]


def change_gaps(prog: Leaves, ref: Leaves, before: Leaves,
                names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's norm gap of the change from ``before``."""

    def change(state):
        return {k: state[k].to(before[k].device) - before[k] for k in names}

    return norm_gaps(_norms(change(prog), names),
                     _norms(change(ref), names))


def train_numbers(prog: dict, ref: dict, start: Leaves,
                  befores: Dict[int, Leaves],
                  names: Sequence[str]) -> Dict[str, float]:
    """``prog`` and ``ref``: ``start`` (``losses``, ``grad1`` and
    ``state`` after the first steps, both from ``start``) and ``steps``
    (per later epoch t, from ``befores[t]`` on both sides: ``loss``,
    ``after``, ``scores``). Beside the worst leaf's gradient gap, the
    median leaf's: steady from seed to seed where the worst is whichever
    small leaf's gradient cancels most."""
    moving = moving_leaves(ref["start"]["grad1"], names)
    grad = norm_gaps(_norms(prog["start"]["grad1"], names),
                     _norms(ref["start"]["grad1"], names))
    out = dict(
        loss_gap=loss_gap(prog["start"]["losses"], ref["start"]["losses"]),
        grad_norm_gap=max(grad.values()),
        grad_median_gap=statistics.median(grad.values()),
        change_norm_gap=max(change_gaps(prog["start"]["state"],
                                        ref["start"]["state"], start,
                                        moving).values()),
        step_change_gap=0.0, step_change_median=0.0, step_loss_gap=0.0,
        score_gap=0.0)
    if set(prog["steps"]) != set(ref["steps"]):
        return {k: float("inf") for k in out}
    for t, r in ref["steps"].items():
        p = prog["steps"][t]
        gaps = change_gaps(p["after"], r["after"], befores[t], moving)
        out["step_change_gap"] = max(out["step_change_gap"],
                                     max(gaps.values()))
        out["step_change_median"] = max(out["step_change_median"],
                                        statistics.median(gaps.values()))
        out["step_loss_gap"] = max(out["step_loss_gap"],
                                   loss_gap([p["loss"]], [r["loss"]]))
        out["score_gap"] = max(out["score_gap"], max(
            abs(p["scores"][k] - r["scores"][k]) for k in r["scores"]))
    return out


def max_abs_gap(prog: Sequence[torch.Tensor],
                ref: Sequence[torch.Tensor]) -> float:
    return max(float((p.to(r.device) - r).abs().max())
               for p, r in zip(prog, ref))
