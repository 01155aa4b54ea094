"""The comparison that decides ``correct`` for KT-GNN cells, and the
control and faults that it has to catch.

Training: the recorder (``systems/ktgnn.py``) read the window's first run
at its sampled epochs, and the run returned each epoch's loss and scores
and its final weights. The reference takes them so:

* the start: from the initial weights it works out itself from the seed,
  the first ``start_steps`` steps with the program's dropout masks;
* every later sampled epoch t (the first of each chunk after the first,
  of each StepLR period, the last, a few drawn from the seed): one step
  from the state the program held before it (weights, batch-norm
  statistics, Adam's moments), at the rate StepLR gives epoch t, and the
  eval forward's scores after it. Here it follows the program step by
  step from the program's own state; the start and the epoch counts
  check what that skips;
* the masks themselves: each a Bernoulli(1 - p) draw where the layer
  before dropout is positive, and the kept values 1/(1 - p) times the
  reference's;
* every sampled epoch ran, in its place, and the run ran all its epochs.

The masks are read, not drawn again, so a program that draws the same
Bernoulli masks in another order or from another generator is judged
alike.

Serving: for each sampled answer the reference runs the eval forward on
the request's features with the weights the benchmark made, and the
number is the largest gap of a log-probability, over every node and the
three heads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from lib import compare
from lib.spec import load_module

ref = load_module("reference", "ktgnn")

PLANTED = ("stale_record", "dropout_rate", "dropout_scale")

# the layer before dropout counts as positive above this (it is batch
# normalised, so of order 1): nearer 0, rounding may zero it on one side
POSITIVE = 1e-2


def train_settings(config: dict) -> dict:
    c = config["stage2"]
    return {k: c[k] for k in ("lr", "weight_decay", "use_scheduler",
                              "step_size", "gamma", "Lambda", "dropout")}


def graph(data, config: dict, device) -> dict:
    return ref.prepare_graph(data, config["stage2"]["to_undirected"], device)


def start_state(G: dict, config: dict, seed: int, device):
    return ref.init_state(seed, G["x"].shape[1], config["stage2"]["hidden"],
                          G["num_classes"], device)


def unpack(packed: torch.Tensor, n: int, hidden: int) -> torch.Tensor:
    """The recorder's mask bits back to a bool [n, hidden] keep mask."""
    shifts = torch.arange(8, device=packed.device)
    bits = (packed.long()[:, None] >> shifts) & 1
    return bits.reshape(-1, hidden)[:n].bool()


def _on(leaves: dict, device) -> dict:
    return {k: v.to(device) for k, v in leaves.items()}


def program_side(rec: dict, run: dict, traffic: dict,
                 stale_by: int = 0) -> dict:
    """The program's readings: the start's losses, first gradient (Adam's
    first moment after step 1 over ``1 - β1``) and weights after it; at
    each later sampled epoch its loss, the weights after its step (the
    run's returned weights after the last) and its scores. ``stale_by``
    plants a fault of the program's record: each later epoch reports the
    loss and scores of the epoch ``stale_by`` before it, as a chunk that
    copied the previous chunk's rows would."""
    if stale_by:
        run = dict(run, losses=run["losses"][:stale_by] + run["losses"],
                   scores=run["scores"][:stale_by] + run["scores"])
    k = traffic["start_steps"]
    last = max(rec["epochs"])
    ran = {t for t, tag in zip(rec["epochs"], rec["tags"])
           if tag == t and t <= len(run["losses"])}
    steps = {}
    for t in sorted(ran & set(rec["epochs"][k:])):
        after = run["final"] if t == last else rec["after"][t]
        steps[t] = dict(loss=run["losses"][t - 1], scores=run["scores"][t - 1],
                        after={n: after[n] for n in rec["after"][t]})
    return dict(start=dict(losses=run["losses"][:k],
                           grad1={n: m / (1 - ref.BETAS[0])
                                  for n, m in rec["m"][2].items()},
                           state=rec["after"][k]),
                steps=steps)


def reference_side(G: dict, config: dict, traffic: dict, seed: int,
                   rec: dict, keeps: Dict[int, torch.Tensor],
                   precision, fault: Optional[str], device) -> dict:
    """The same readings from the reference in ``precision`` with
    ``fault`` planted, from the same inputs: its own initial weights for
    the start, the program's state before each later sampled epoch, the
    program's masks; and the layer before each sampled epoch's dropout."""
    s = train_settings(config)
    k = traffic["start_steps"]
    start = ref.train_steps(start_state(G, config, seed, device), G, s,
                            [keeps[t] for t in rec["epochs"][:k]], precision,
                            fault)
    out = dict(start=start, steps={},
               pre={t: start["pre"][i] for i, t in enumerate(rec["epochs"][:k])})
    for t in rec["epochs"][k:]:
        before = _on(rec["before"][t], device)
        moments = (_on(rec["m"][t], device), _on(rec["v"][t], device))
        one = ref.train_steps(before, G, s, [keeps[t]], precision, fault,
                              done=t - 1, moments=moments)
        out["steps"][t] = dict(loss=one["losses"][0], after=one["state"],
                               scores=ref.scores(one["state"], G, precision))
        out["pre"][t] = one["pre"][0]
    return out


def dropout_numbers(rec: dict, keeps: Dict[int, torch.Tensor],
                    pre: Dict[int, torch.Tensor], p: float) -> dict:
    """``keep_rate_z``: over each sampled epoch's positive entries of the
    layer before dropout, the kept share's distance from ``1 - p`` in
    binomial standard deviations, the worst epoch's. ``dropout_scale_gap``:
    at the recorded positions, kept and positive, the program's values
    over ``1/(1 - p)`` times the reference's, summed, less 1, the worst
    epoch's."""
    z = scale = 0.0
    for t, keep in keeps.items():
        positive = pre[t] > POSITIVE
        count = int(positive.sum())
        share = float((keep & positive).sum()) / max(count, 1)
        z = max(z, abs(share - (1 - p)) / math.sqrt(p * (1 - p) / max(count, 1)))
        pos = rec["positions"].to(keep.device)
        at = pre[t].reshape(-1)[pos]
        sel = keep.reshape(-1)[pos] & (at > POSITIVE)
        values = rec["values"][t].to(keep.device)[sel].double().sum()
        scale = max(scale, abs(float(values * (1 - p)
                                     / at[sel].double().sum()) - 1))
    return dict(keep_rate_z=z, dropout_scale_gap=scale)


def train(G: dict, config: dict, traffic: dict, seed: int, rec: dict,
          run: dict, device, side: Optional[tuple] = None,
          memo: Optional[dict] = None) -> Tuple[Dict[str, float], dict]:
    """The numbers compared and what is printed beside them. ``side``:
    ``(precision, fault)`` puts the reference in the program's place (the
    control, the faults), fed the program's recorded inputs; the faults in
    ``PLANTED`` are planted in the program's own readings instead: a
    stale record (``program_side``), masks drawn at another rate, kept
    values left unscaled. ``memo`` keeps the judge's readings for further
    sides of the same run."""
    hidden = config["stage2"]["hidden"]
    keeps = {t: unpack(rec["packed"][t].to(device), G["n"], hidden)
             for t in rec["epochs"]}
    memo = {} if memo is None else memo
    if "judge" not in memo:
        memo["judge"] = reference_side(G, config, traffic, seed, rec, keeps,
                                       ref.JUDGE, None, device)
    judge = memo["judge"]
    fault = None if side is None else side[1]
    p = config["stage2"]["dropout"]
    if side is None or fault in PLANTED:
        prog = program_side(rec, run, traffic,
                            config["stage2"]["scan_epochs"]
                            if fault == "stale_record" else 0)
    else:
        prog = reference_side(G, config, traffic, seed, rec, keeps, *side,
                              device)
    if fault == "dropout_rate":
        # a fifth of the kept entries dropped too: a rate of 0.6 for 0.5
        gen = torch.Generator(device=device).manual_seed(seed)
        keeps = {t: k & (torch.rand(k.shape, generator=gen, device=device)
                         >= 0.2) for t, k in keeps.items()}
    if fault == "dropout_scale":
        # the kept values left unscaled
        rec = dict(rec, values={t: v * (1 - p)
                                for t, v in rec["values"].items()})
    start = start_state(G, config, seed, device)
    names = ref.trainable(start)
    befores = {t: _on(rec["before"][t], device) for t in judge["steps"]}
    numbers = compare.train_numbers(prog, judge, start, befores, names)
    numbers.update(dropout_numbers(rec, keeps, judge["pre"], p))
    numbers["epochs_missed"] = float(
        sum(tag != t for tag, t in zip(rec["tags"], rec["epochs"]))
        + abs(rec["epochs_run"] - config["stage2"]["num_epoch"]))
    info = dict(epochs=rec["epochs"],
                init_gap=max(float((rec["before"][1][k].to(device)
                                    - start[k]).abs().max()) for k in names),
                rates={t: rec["lr"][t] for t in rec["epochs"]},
                losses=dict(program=prog["start"]["losses"],
                            reference=judge["start"]["losses"]))
    return numbers, info


def _request_x(G: dict, request: dict, device) -> torch.Tensor:
    x = G["x"].clone()
    x[torch.as_tensor(request["nodes"], device=device)] = torch.as_tensor(
        request["rows"], device=device)
    return x


def _reference_heads(weights, G, request, precision, device):
    with ref.exact_matmuls(), torch.no_grad():
        return ref.heads(weights, G, precision, x=_request_x(G, request,
                                                             device))


def serve(G: dict, weights, answers: List[Tuple[dict, dict]],
          device) -> Dict[str, float]:
    """``answers``: (request, the program's heads) pairs."""
    gap = 0.0
    for request, out in answers:
        prog = [torch.as_tensor(out[h]) for h in
                ("source", "target", "target_hat")]
        gap = max(gap, compare.max_abs_gap(
            prog, _reference_heads(weights, G, request, ref.JUDGE, device)))
    return dict(heads_gap=gap)


def control_serve(G: dict, weights, requests: List[dict],
                  precision: "ref.Precision", fault: Optional[str],
                  device) -> Dict[str, float]:
    """The reference's eval forward in ``precision`` in the program's
    place; ``fault="altered"`` changes one answer where it is made (node
    0's row of every head takes node 1's)."""
    answers = []
    for request in requests:
        heads = _reference_heads(weights, G, request, precision, device)
        out = {}
        for name, lp in zip(("source", "target", "target_hat"), heads):
            lp = lp.clone()
            if fault == "altered":
                lp[0] = lp[1]
            out[name] = lp.cpu().numpy()
        answers.append((request, out))
    return serve(G, weights, answers, device)


def graph_sizes(G: dict) -> dict:
    return dict(n=G["n"], e=G["num_edges"], f=int(G["x"].shape[1]),
                c=G["num_classes"])



def check(kind: str, data, config: dict, traffic: dict, seed: int,
          state: dict, window: dict, device, side: Optional[tuple] = None,
          memo: Optional[dict] = None):
    """The numbers compared, what is printed beside them, and the graph's
    sizes as the benchmark counts them. ``side`` and ``memo``: as
    :func:`train`'s (serving: the control or a fault on the pool's first
    requests)."""
    memo = {} if memo is None else memo
    if "graph" not in memo:
        memo["graph"] = graph(data, config, device)
    G = memo["graph"]
    if kind == "train_runs":
        if "recorded" not in memo:
            memo["recorded"] = state["recorder"].read()
        numbers, info = train(G, config, traffic, seed, memo["recorded"],
                              window["records"][0], device, side, memo)
    elif side is None:
        pool = state["pool"]
        answers = [(pool[i % len(pool)], out)
                   for i, out in sorted(window["kept"].items())]
        numbers, info = serve(G, state["weights"], answers, device), {}
    else:
        pool = state["pool"]
        numbers = control_serve(G, state["weights"],
                                pool[: traffic["sample_requests"]], *side,
                                device)
        info = {}
    return numbers, info, graph_sizes(G)
