"""The comparison that decides ``correct`` for the stage-1 cell, and the
control and faults it has to catch.

The recorder (``systems/stage1.py``) read the window's first run at its
sampled epochs, and the run returned each epoch's three losses, its best
epoch and the weights of that epoch. The reference takes them so:

* the start: from the initial weights it works out itself from the seed,
  the first ``start_steps`` epochs with the program's pairs and dropout
  masks (its own targets, from the labels): each epoch's three losses,
  the first gradient of every leaf as the Adams took it, the leaves'
  change over the start;
* every later sampled epoch t (inside and at the ends of 25-epoch
  segments, at single-epoch segments, the last, a few drawn from the
  seed): both steps from the state the program held before it (weights,
  batch-norm statistics, the three Adams' moments and step counts): the
  three losses against the run's returned history, each leaf's change;
* at the sampled evaluation epochs, the device evaluator's counts of
  both splits, recomputed from the program's weights after the epoch and
  its evaluation pairs;
* the returned best weights against the recorded state at the best
  epoch, bit for bit;
* the draws, held to the configuration: each relation's pairs the full
  product of ``per_class`` ids a class on each side, from ``min(classes,
  max_class_num)`` distinct classes inside the train split, the same
  classes on both sides, targets equal to label equality; the evaluation
  pairs inside their split; each dropout mask a Bernoulli draw at the
  layer's rate over the entries positive before it, the kept values
  scaled by ``1/(1 - p)``;
* every sampled epoch ran, in its place, and the run ran all its epochs.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch

from lib import compare
from lib.spec import load_module

ref = load_module("reference", "stage1")

PLANTED = ("stale_record", "one_class")

# a layer before dropout counts as positive above this: nearer 0,
# rounding may zero it on one side
POSITIVE = 1e-2

SIDES = {"src": ("src", "src"), "tar": ("tar", "tar"),
         "cross": ("src", "tar")}


def rate(site: str) -> float:
    return ref.CLF_DROPOUT if site.startswith("clf.") else ref.HIDDEN_DROPOUT


def unpack(packed: torch.Tensor, shape) -> torch.Tensor:
    """The recorder's mask bits back to a bool keep mask of ``shape``."""
    shifts = torch.arange(8, device=packed.device)
    bits = (packed.long()[:, None] >> shifts) & 1
    return bits.reshape(shape).bool()


def _on(leaves: dict, device) -> dict:
    return {k: v.to(device) for k, v in leaves.items()}


def _part(leaves: dict, part: str) -> dict:
    return {k: v for k, v in leaves.items()
            if k.startswith(ref.PARTS[part])}


def epoch_inputs(rec: dict, t: int, S: dict, device):
    """Epoch ``t``'s pairs, their targets from the labels, and its masks."""
    idxs = _on(rec["pairs"][t], device)
    y = {rel: (S[f"y_{a}"][idxs[f"{rel}1"]]
               == S[f"y_{b}"][idxs[f"{rel}2"]]).float()
         for rel, (a, b) in SIDES.items()}
    keeps = {s: unpack(rec["masks"][t][s].to(device), rec["shapes"][s])
             for s in rec["masks"][t]}
    return idxs, y, keeps


def _moments(rec: dict, t: int, device) -> dict:
    return {part: (rec["step"][t][part], _on(_part(rec["m"][t], part), device),
                   _on(_part(rec["v"][t], part), device))
            for part in ref.PARTS}


def program_side(rec: dict, run: dict, traffic: dict,
                 stale_by: int = 0) -> dict:
    """The program's readings: the start's losses, first gradient (each
    Adam's first moment after step 1 over ``1 - β1``) and state after it;
    at each later sampled epoch its losses and its state after both
    steps. ``stale_by`` plants a fault of the program's record: each epoch
    reports the losses of the epoch ``stale_by`` before it, as a segment
    that copied the previous segment's rows would."""
    losses = run["losses"]
    if stale_by:
        losses = losses[:stale_by] + losses
    k = traffic["start_steps"]
    ran = {t for t, tag in zip(rec["epochs"], rec["tags"])
           if tag == t and t <= len(losses)}
    grad1 = {}
    for part, opts in ref.ADAMS.items():
        for name, m in _part(rec["m"][2], part).items():
            grad1[name] = m / (1 - opts["betas"][0])
    return dict(start=dict(losses=losses[:k], grad1=grad1,
                           state=rec["after"][k]),
                steps={t: dict(loss=losses[t - 1], after=rec["after"][t])
                       for t in sorted(ran & set(rec["epochs"][k:]))})


def reference_side(S: dict, config: dict, traffic: dict, seed: int,
                   rec: dict, precision, fault: Optional[str],
                   device) -> dict:
    """The same readings from the reference in ``precision`` with ``fault``
    planted, from the same inputs: its own initial weights for the start,
    the program's state before each later sampled epoch, the program's
    pairs and masks; the layers before each sampled epoch's dropouts; the
    evaluator's counts at the sampled evaluation epochs."""
    c = config["stage1"]
    k, layers = traffic["start_steps"], c["num_layer"]
    start = ref.train_steps(
        ref.init_state(seed, S, c["hidden_dim"], layers, device), S, layers,
        [epoch_inputs(rec, t, S, device) for t in rec["epochs"][:k]],
        precision, fault)
    out = dict(start=start, steps={}, counts={},
               pre=dict(zip(rec["epochs"][:k], start["pre"])))
    for t in rec["epochs"][k:]:
        one = ref.train_steps(_on(rec["before"][t], device), S, layers,
                              [epoch_inputs(rec, t, S, device)], precision,
                              fault, _moments(rec, t, device))
        out["steps"][t] = dict(loss=one["losses"][0], after=one["state"])
        out["pre"][t] = one["pre"][0]
    for (split, e), pairs in rec["eval_pairs"].items():
        if e in rec["eval_state"]:
            got = ref.eval_counts(_on(rec["eval_state"][e], device), S,
                                  layers, {split: _on_pairs(pairs, device)},
                                  precision)
            out["counts"][(split, e)] = got[split]
    return out


def _on_pairs(pairs: dict, device) -> dict:
    return {rel: (a.to(device), b.to(device)) for rel, (a, b) in pairs.items()}


def _flat(losses) -> list:
    return [float(x) for triple in losses for x in triple]


def train_numbers(prog: dict, judge: dict, start: dict, befores: dict,
                  names) -> Dict[str, float]:
    """The start's loss, first-gradient and change gaps, and each later
    sampled epoch's loss and change gaps (``lib/compare.py``'s norms)."""
    moving = compare.moving_leaves(judge["start"]["grad1"], names)
    grad = compare.norm_gaps(compare._norms(prog["start"]["grad1"], names),
                             compare._norms(judge["start"]["grad1"], names))
    out = dict(
        loss_gap=compare.loss_gap(_flat(prog["start"]["losses"]),
                                  _flat(judge["start"]["losses"])),
        grad_norm_gap=max(grad.values()),
        grad_median_gap=statistics.median(grad.values()),
        change_norm_gap=max(compare.change_gaps(
            prog["start"]["state"], judge["start"]["state"], start,
            moving).values()),
        step_change_gap=0.0, step_change_median=0.0, step_loss_gap=0.0)
    if set(prog["steps"]) != set(judge["steps"]):
        return {k: float("inf") for k in out}
    for t, r in judge["steps"].items():
        p = prog["steps"][t]
        gaps = compare.change_gaps(p["after"], r["after"], befores[t],
                                   moving)
        out["step_change_gap"] = max(out["step_change_gap"],
                                     max(gaps.values()))
        out["step_change_median"] = max(out["step_change_median"],
                                        statistics.median(gaps.values()))
        out["step_loss_gap"] = max(out["step_loss_gap"], compare.loss_gap(
            _flat([p["loss"]]), _flat([r["loss"]])))
    return out


def count_gap(prog: Dict[tuple, torch.Tensor],
              ref_counts: Dict[tuple, torch.Tensor]) -> float:
    """Over the sampled evaluations, the largest share of counts that
    differ: the summed absolute gap over the summed reference counts."""
    if set(prog) != set(ref_counts) or not ref_counts:
        return float("inf")
    gap = 0.0
    for key, r in ref_counts.items():
        p = prog[key].to(r.device)
        if p.shape != r.shape:
            return float("inf")
        gap = max(gap, float((p - r).abs().sum()) / max(float(r.sum()), 1.0))
    return gap


def best_gap(rec: dict, run: dict) -> float:
    """The returned best weights against the state recorded after the best
    epoch (the last, where no evaluation improved on the first score),
    the largest absolute gap."""
    e = run["best_epoch"] if run["best_epoch"] > 0 else rec["epochs"][-1]
    state = rec["eval_state"].get(e, rec["after"].get(e))
    if state is None or set(state) != set(run["state_dict"]):
        return float("inf")
    return max(float((run["state_dict"][k].float() - state[k].cpu())
                     .abs().max()) for k in state)


def draw_errors(rec: dict, S: dict, config: dict) -> float:
    """Pairs and targets that break the configuration's sampling, counted
    over the sampled epochs, and evaluation pairs outside their split."""
    c = config["stage1"]
    per = int(math.sqrt(c["sample_size"]) / c["max_class_num"])
    errors = 0
    for t, tag in zip(rec["epochs"], rec["tags"]):
        if tag != t:
            continue
        pairs = _on(rec["pairs"][t], S["y_src"].device)
        for rel, (d1, d2) in SIDES.items():
            a, b = pairs[f"{rel}1"], pairs[f"{rel}2"]
            y1, y2 = S[f"y_{d1}"], S[f"y_{d2}"]
            tr1, tr2 = S[f"train_{d1}"], S[f"train_{d2}"]
            counts = torch.bincount(y1[tr1], minlength=S["num_classes"])
            if rel == "cross":
                counts = counts * torch.bincount(y2[tr2],
                                                 minlength=S["num_classes"])
            m = min(int((counts > 0).sum()), c["max_class_num"])
            n = per * m
            if len(a) != n * n or len(b) != n * n:
                errors += abs(len(a) - n * n) + abs(len(b) - n * n) + 1
                continue
            ids1, ids2 = a[:n], b[::n]
            errors += int((a != ids1.repeat(n)).sum())
            errors += int((b != ids2.repeat_interleave(n)).sum())
            errors += int((~tr1[ids1]).sum() + (~tr2[ids2]).sum())
            c1, c2 = y1[ids1].reshape(m, per), y2[ids2].reshape(m, per)
            errors += int((c1 != c1[:, :1]).sum() + (c2 != c2[:, :1]).sum())
            errors += int((c1[:, 0] != c2[:, 0]).sum())
            errors += m - len(torch.unique(c1[:, 0]))
            truth = (y1[a] == y2[b]).float()
            errors += int((rec["targets"][t][rel].to(truth.device)
                           != truth).sum())
    for (split, _), by_rel in rec["eval_pairs"].items():
        for rel, (a, b) in by_rel.items():
            d1, d2 = SIDES[rel]
            errors += int((~S[f"{split}_{d1}"][a.to(S["y_src"].device)]).sum())
            errors += int((~S[f"{split}_{d2}"][b.to(S["y_src"].device)]).sum())
    return float(errors)


def dropout_numbers(rec: dict, keeps: dict, pre: dict) -> dict:
    """``keep_rate_z``: over each sampled epoch's and mask's entries
    positive before dropout, the kept share's distance from ``1 - p`` in
    binomial standard deviations, the worst. ``dropout_scale_gap``: at the
    recorded positions, kept and positive, the program's values over
    ``1/(1 - p)`` times the reference's, summed, less 1, the worst."""
    z = scale = 0.0
    for t, by_site in keeps.items():
        for site, keep in by_site.items():
            p = rate(site)
            before = pre[t][site]
            positive = before > POSITIVE
            count = max(int(positive.sum()), 1)
            share = float((keep & positive).sum()) / count
            z = max(z, abs(share - (1 - p)) / math.sqrt(p * (1 - p) / count))
            pos = rec["positions"][site].to(keep.device)
            at = before.reshape(-1)[pos]
            sel = keep.reshape(-1)[pos] & (at > POSITIVE)
            values = rec["values"][t][site].to(keep.device)[sel].double()
            scale = max(scale, abs(float(values.sum() * (1 - p)
                                         / at[sel].double().sum()) - 1))
    return dict(keep_rate_z=z, dropout_scale_gap=scale)


def epochs_missed(rec: dict, run: dict, config: dict) -> float:
    n = config["stage1"]["num_epoch"]
    return float(sum(tag != t for tag, t in zip(rec["tags"], rec["epochs"]))
                 + abs(rec["epochs_run"] - n)
                 + (run["history_epochs"] != list(range(1, n + 1))))


def _plant(rec: dict, fault: Optional[str]) -> dict:
    """The faults planted in the program's own record: ``stale_record``
    (in :func:`program_side`), ``one_class``: every pair of every sampled
    epoch made of its relation's first two ids, one class a side."""
    if fault != "one_class":
        return rec
    pairs = {t: {k: v[:1].expand_as(v) for k, v in by_key.items()}
             for t, by_key in rec["pairs"].items()}
    return dict(rec, pairs=pairs)


def train(S: dict, config: dict, traffic: dict, seed: int, rec: dict,
          run: dict, device, side: Optional[tuple] = None,
          memo: Optional[dict] = None):
    """The numbers compared and what is printed beside them. ``side``:
    ``(precision, fault)`` puts the reference in the program's place (the
    control, the faults in ``ref.FAULTS``), fed the program's recorded
    inputs; the faults in ``PLANTED`` are planted in the program's own
    readings instead. ``memo`` keeps the judge's readings for further
    sides of the same run."""
    memo = {} if memo is None else memo
    if "judge" not in memo:
        memo["judge"] = reference_side(S, config, traffic, seed, rec,
                                       ref.JUDGE, None, device)
    judge = memo["judge"]
    fault = None if side is None else side[1]
    rec = _plant(rec, fault)
    if side is None or fault in PLANTED:
        prog = program_side(rec, run, traffic,
                            config["stage1"]["scan_epochs"]
                            if fault == "stale_record" else 0)
        counts = rec["eval_counts"]
    else:
        prog = reference_side(S, config, traffic, seed, rec, *side, device)
        counts = prog["counts"]
    layers = config["stage1"]["num_layer"]
    start = ref.init_state(seed, S, config["stage1"]["hidden_dim"], layers,
                           device)
    names = ref.trainable(start)
    befores = {t: _on(rec["before"][t], device) for t in judge["steps"]}
    numbers = train_numbers(prog, judge, start, befores, names)
    numbers["eval_count_gap"] = count_gap(counts, judge["counts"])
    numbers["best_state_gap"] = best_gap(rec, run)
    numbers["draw_errors"] = draw_errors(rec, S, config)
    keeps = {t: epoch_inputs(rec, t, S, device)[2] for t in judge["pre"]}
    numbers.update(dropout_numbers(rec, keeps, judge["pre"]))
    numbers["epochs_missed"] = epochs_missed(rec, run, config)
    info = dict(epochs=rec["epochs"], best_epoch=run["best_epoch"],
                captures=run.get("captures"),
                init_gap=max(float((rec["before"][1][k].to(device)
                                    - start[k]).abs().max()) for k in names),
                losses=dict(program=prog["start"]["losses"],
                            reference=judge["start"]["losses"]))
    return numbers, info


def sizes(S: dict, config: dict, rec: Optional[dict]) -> dict:
    """The domains' and the work's sizes as the benchmark counts them."""
    c = config["stage1"]
    out = dict(n_src=int(S["x_src"].shape[0]), n_tar=int(S["x_tar"].shape[0]),
               f_src=int(S["x_src"].shape[1]), f_tar=int(S["x_tar"].shape[1]),
               c=S["num_classes"], h=c["hidden_dim"], layers=c["num_layer"],
               epochs=c["num_epoch"])
    if rec is not None:
        t = rec["epochs"][0]
        out["pairs"] = [len(rec["pairs"][t][f"{r}1"]) for r in ref.RELATIONS]
        by_eval: Dict[int, int] = {}
        for (_, e), by_rel in rec["eval_pairs"].items():
            by_eval[e] = by_eval.get(e, 0) + sum(len(a) for a, _ in
                                                 by_rel.values())
        out["eval_pairs"] = max(by_eval.values()) if by_eval else 0
        out["evals"] = len(rec["evals"])
    return out


def check(kind: str, data, config: dict, traffic: dict, seed: int,
          state: dict, window: dict, device, side: Optional[tuple] = None,
          memo: Optional[dict] = None):
    """The numbers compared, what is printed beside them, and the sizes as
    the benchmark counts them. ``side`` and ``memo``: as :func:`train`'s."""
    if kind != "train_runs":
        raise ValueError(f"stage 1 has no {kind!r} traffic")
    memo = {} if memo is None else memo
    if "domains" not in memo:
        memo["domains"] = ref.domains(state["src"], state["tar"], device)
    S = memo["domains"]
    if "recorded" not in memo:
        memo["recorded"] = state["recorder"].read()
    rec = memo["recorded"]
    numbers, info = train(S, config, traffic, seed, rec,
                          window["records"][0], device, side, memo)
    return numbers, info, sizes(S, config, rec)
