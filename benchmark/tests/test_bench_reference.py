"""The plain reference against the port's CPU path at a small size, with
float32 message tables on both sides: the same steps and the same heads
to float32 rounding. Only this file, of the reference's users, imports
the port."""

import pytest
import torch

from lib import compare, traffic
from lib.spec import load_module

SEED = 2 ** 31 + 11


def test_a_whole_run_matches_the_port_step_by_step(small):
    """The window's first run on the CPU with float32 message tables: the
    start, every sampled step and the scores agree to float32 rounding,
    the masks are Bernoulli(0.5) draws scaled by 2, and every epoch ran."""
    cell = small("ktgnn-train")
    cell.config["stage2"]["message_dtype"] = None
    system = load_module("systems", "ktgnn")
    checks = load_module("checks", "ktgnn")
    data = traffic.make_graph(cell.config, cell.traffic, SEED)
    state = system.setup("train_runs", data, cell.config, cell.traffic,
                         SEED, "cpu")
    window = dict(records=[system.call(state, 0)])
    numbers, info, sizes = checks.check("train_runs", data, cell.config,
                                        cell.traffic, SEED, state, window,
                                        "cpu")
    assert info["init_gap"] == 0.0
    assert sizes["n"] == 600
    # the first chunk's first epoch, the rate's steps, the last, one drawn
    assert {1, 2, 3, 4, 5, 6} >= set(info["epochs"]) >= {1, 2, 3, 4, 5, 6}
    assert info["rates"][6] == pytest.approx(1e-3 * 0.1 ** 2)
    assert numbers.pop("epochs_missed") == 0
    assert numbers.pop("keep_rate_z") < 6
    for name, value in numbers.items():
        assert value < 1e-5, (name, value)


def test_eval_heads_match_the_port(small):
    cell = small("ktgnn-serve")
    cell.config["stage2"].update(message_dtype=None, matmul_precision=None)
    system = load_module("systems", "ktgnn")
    checks = load_module("checks", "ktgnn")
    data = traffic.make_graph(cell.config, cell.traffic, SEED)
    state = system.setup("closed_loop", data, cell.config, cell.traffic,
                         SEED, "cpu")
    window = dict(kept={i: system.request(state, state["pool"][i])
                        for i in range(2)})
    numbers, _, _ = checks.check("closed_loop", data, cell.config,
                                 cell.traffic, SEED, state, window, "cpu")
    assert numbers["heads_gap"] < 1e-5


def test_reference_adam_is_torch_adam():
    ref = load_module("reference", "ktgnn")
    torch.manual_seed(0)
    w = torch.randn(5, 3)
    grads = [torch.randn(5, 3) for _ in range(4)]
    cfg = dict(lr=0.01, weight_decay=5e-3, use_scheduler=True, step_size=2,
               gamma=0.1)
    p = torch.nn.Parameter(w.clone())
    opt = torch.optim.Adam([p], lr=cfg["lr"], weight_decay=cfg["weight_decay"])
    sched = torch.optim.lr_scheduler.StepLR(opt, 2, 0.1)
    mine = ref.Adam(["w"], cfg)
    state = {"w": w.clone()}
    for g in grads:
        p.grad = g.clone()
        opt.step()
        sched.step()
        mine.step(state, {"w": g})
    torch.testing.assert_close(state["w"], p.detach(), rtol=1e-6, atol=1e-7)


def test_norm_gap_takes_the_worst_leaf_over_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-9}
    # c's gap is 1e-9 over the median 1.0, a's 0.1 over 1.0
    gaps = compare.norm_gaps(prog, ref)
    assert abs(gaps["a"] - 0.1) < 1e-12 and gaps["c"] < 1e-8
    assert max(gaps, key=gaps.get) == "a"
