"""``correct`` has to come out false for the control and for a timed path
broken underneath, at a size a CPU test run holds. The harness's look for
a chip is skipped: ``run_cell`` runs on the CPU, the port's plain versions
in place of its kernels. The limits are the cells' own, set from readings
at the cells' sizes on the card; a 600-node graph averages less, so the
sound program may read above them here, and each test also holds the
broken run to at least three times the sound run's number on the number
that fails.

On the card, at the cells' own sizes, the same readings come from
``benchmark/readings.py`` (``test_control_readings_on_the_card``)."""

import functools
import time

import numpy as np
import pytest
import torch

from conftest import small_cell
from lib import traffic
from lib.spec import load_module

SEED = 2 ** 31 + 17


def _run(cell):
    import run

    return run.run_cell(cell, SEED, 0.2, False, device="cpu",
                        t0=time.perf_counter())


@functools.lru_cache(maxsize=None)
def _sound(name):
    return {k: c["value"] for k, c in _run(small_cell(name))["checks"].items()}


def _fails_clearly(numbers, name):
    """A limited number above its limit and three times the sound run's."""
    limits = small_cell(name).limits
    sound = _sound(name)
    return [k for k in limits
            if numbers[k] > limits[k] and numbers[k] >= 3 * sound[k]]


def _in_place(cell, precision, fault):
    """The check with the reference in ``precision``, ``fault`` planted,
    in the program's place, fed a sound run's recorded inputs."""
    system = load_module("systems", "ktgnn")
    checks = load_module("checks", "ktgnn")
    kind = cell.traffic["kind"]
    data = traffic.make_graph(cell.config, cell.traffic, SEED)
    state = system.setup(kind, data, cell.config, cell.traffic, SEED, "cpu")
    window = (dict(records=[system.call(state, 0)])
              if kind == "train_runs" else {})
    numbers, _, _ = checks.check(kind, data, cell.config, cell.traffic, SEED,
                                 state, window, "cpu", (precision, fault))
    return numbers


@pytest.mark.parametrize("name", ["ktgnn-train", "ktgnn-serve"])
def test_the_control_is_not_correct(small, name):
    cell = small(name)
    ref = load_module("checks", "ktgnn").ref
    numbers = _in_place(cell, ref.Precision(**cell.config["control"]), None)
    assert _fails_clearly(numbers, name), (numbers, _sound(name))


@pytest.mark.parametrize("fault", ["half_batch", "frozen", "stale_rate",
                                   "stale_record"])
def test_faults_in_the_reference_are_not_correct(small, fault):
    ref = load_module("checks", "ktgnn").ref
    numbers = _in_place(small("ktgnn-train"), ref.JUDGE, fault)
    assert _fails_clearly(numbers, "ktgnn-train"), (numbers,
                                                    _sound("ktgnn-train"))


def _frozen_adam(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from bridged_gnn_tpu_torch.train import stage2

    plain = stage2.masked_nll

    def half(log_probs, y, mask):
        rows = torch.nonzero(mask)[:, 0]
        kept = mask.clone()
        kept[rows[::2]] = False
        return plain(log_probs, y, kept)

    monkeypatch.setattr(stage2, "masked_nll", half)


def _stale_rate(monkeypatch):
    from bridged_gnn_tpu_torch.train import stage2

    plain = stage2._scan_run

    def stale(*args, **kwargs):
        run = plain(*args, **kwargs)
        run.schedule = False
        return run

    monkeypatch.setattr(stage2, "_scan_run", stale)


def _short_run(monkeypatch):
    from bridged_gnn_tpu_torch.train import stage2

    plain = stage2.train_ktgnn

    def short(data, cfg, *args, **kwargs):
        import dataclasses

        return plain(data, dataclasses.replace(cfg, num_epoch=cfg.num_epoch
                                               - 1), *args, **kwargs)

    monkeypatch.setattr(stage2, "train_ktgnn", short)
    monkeypatch.setattr(load_module("systems", "ktgnn"), "train_ktgnn",
                        short)


def _dropout(monkeypatch, keep: float, scale: float):
    from bridged_gnn_tpu_torch.nn import ktgnn

    def drop(x, p, generator, draw_rows=None):
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
        return x * mask * scale

    monkeypatch.setattr(ktgnn, "dropout", drop)


def _dropout_rate(monkeypatch):
    _dropout(monkeypatch, 0.7, 1 / 0.7)


def _dropout_scale(monkeypatch):
    _dropout(monkeypatch, 0.5, 1.0)


def _altered_answer(monkeypatch):
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    plain = KTGNNPredictor._forward

    def altered(self, g):
        out = plain(self, g)
        for lp in out.values():
            lp[0] = lp[1]
        return out

    monkeypatch.setattr(KTGNNPredictor, "_forward", altered)


def _half_answer(monkeypatch):
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    plain = KTGNNPredictor._forward

    def half(self, g):
        out = plain(self, g)
        return {k: np.concatenate([lp[: len(lp) // 2],
                                   np.zeros_like(lp[len(lp) // 2:])])
                for k, lp in out.items()}

    monkeypatch.setattr(KTGNNPredictor, "_forward", half)


@pytest.mark.parametrize("name,fault", [
    ("ktgnn-train", _frozen_adam),
    ("ktgnn-train", _half_batch),
    ("ktgnn-train", _stale_rate),
    ("ktgnn-train", _short_run),
    ("ktgnn-train", _dropout_rate),
    ("ktgnn-train", _dropout_scale),
    ("ktgnn-serve", _altered_answer),
    ("ktgnn-serve", _half_answer),
])
def test_a_broken_timed_path_is_not_correct(small, monkeypatch, name, fault):
    _sound(name)
    cell = small(name)
    fault(monkeypatch)
    out = _run(cell)
    numbers = {k: c["value"] for k, c in out["checks"].items()}
    assert not out["correct"], out["checks"]
    assert _fails_clearly(numbers, name), (numbers, _sound(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ktgnn-train", "ktgnn-serve"])
def test_control_readings_on_the_card(name):
    """On the card at the cell's own size: the control fails a limit on
    three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    import readings
    from lib.spec import load_cell

    cell = load_cell(name)
    lines = []
    readings.emit = lines.append
    readings.main(["--workload", name, "--seeds", "101", "102", "103",
                   "--what", "control"])
    assert len(lines) == 3
    for line in lines:
        assert any(line["numbers"][k] > cell.limits[k] for k in cell.limits)
