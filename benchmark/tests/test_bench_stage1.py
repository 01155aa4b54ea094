"""The stage-1 cell on the CPU: its frozen domain split gives the
program's arrays; ``correct`` comes out false for the control, for every
fault planted in the reference or in the program's readings, and for a
timed path broken underneath; the stage-1 span readers read their ranges
from a hand-made log; the cost count scales with the work.

The cell is cut to a size a CPU test run holds (512 nodes, 16 features,
4 classes, hidden 16, 12 epochs in segments of 4, evaluations from epoch
9), the same code path. Its limits are the cell's own, set from readings
at the cell's size on the card; each broken run also reads at least
three times the sound run on the number that fails."""

import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lib import traffic
from lib.spec import load_cell, load_metric, load_module
from test_bench_spans import _leaf, _log, _port

SEED = 2 ** 31 + 17
CELL = "stage1-train"


def small():
    cell = load_cell(CELL)
    cell.config.update(num_nodes=512, avg_degree=4, num_features=16,
                       num_classes=4)
    cell.config["stage1"].update(
        hidden_dim=16, max_class_num=4, sample_size=400,
        eval_sample_size=400, num_epoch=12, start_eval_epoch=9,
        scan_epochs=4)
    cell.traffic.update(warmup=dict(num_epoch=3, start_eval_epoch=2),
                        random_epochs=1, mask_samples=512)
    return cell


def _run(cell):
    import run

    return run.run_cell(cell, SEED, 0.2, False, device="cpu",
                        t0=time.perf_counter())


@functools.lru_cache(maxsize=None)
def _sound():
    return {k: c["value"] for k, c in _run(small())["checks"].items()}


def _fails_clearly(numbers):
    """A limited number above its limit and three times the sound run's."""
    limits, sound = small().limits, _sound()
    return [k for k in limits
            if numbers[k] > limits[k] and numbers[k] >= 3 * sound[k]]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_domain_split_matches_the_port(seed):
    from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
    from data.domains import split_domains
    from data.graphs import make_benchmark_graph

    data = make_benchmark_graph(512, 6, 16, 5, seed)
    mine = split_domains(data, seed)
    port = dataset_conversion(data, seed=seed)[:2]
    for a, b in zip(mine, port):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_the_sound_run_is_correct():
    out = _run(small())
    assert out["correct"], out["checks"]
    # the start, the second segment's first epoch, one inside the middle
    # segment, the first two evaluations and the middle one, the last, and
    # one drawn from the seed (6)
    assert out["info"]["epochs"] == [1, 2, 3, 5, 6, 7, 9, 10, 11, 12]


@pytest.mark.parametrize("what", ["control", "disc_skipped",
                                  "generator_grad", "frozen_adam",
                                  "stale_record", "one_class"])
def test_the_control_and_planted_faults_are_not_correct(what):
    """The reference one precision step below in the program's place, or
    a fault planted in the reference or in the program's readings, fed a
    sound run's recorded inputs."""
    cell = small()
    system = load_module("systems", "stage1")
    checks = load_module("checks", "stage1")
    side = ((checks.ref.Precision(**cell.config["control"]), None)
            if what == "control" else (checks.ref.JUDGE, what))
    data = traffic.make_graph(cell.config, cell.traffic, SEED)
    state = system.setup("train_runs", data, cell.config, cell.traffic, SEED,
                         "cpu")
    window = dict(records=[system.call(state, 0)])
    numbers, _, _ = checks.check("train_runs", data, cell.config,
                                 cell.traffic, SEED, state, window, "cpu",
                                 side)
    assert _fails_clearly(numbers), (numbers, _sound())


def _program():
    from bridged_gnn_tpu_torch.train import stage1

    return stage1


def _disc_skipped(monkeypatch):
    ts1 = _program()

    def d_step(model, opts, G, h_src, h_tar):
        return ts1.d_loss(model, h_src, h_tar, G.g_src.node_mask,
                          G.g_tar.node_mask).detach()

    monkeypatch.setattr(ts1, "d_step", d_step)


def _generator_grad(monkeypatch):
    ts1 = _program()

    def d_step(model, opts, G, h_src, h_tar):
        # the similarity step's gradient left on the discriminator
        loss = ts1.d_loss(model, h_src, h_tar, G.g_src.node_mask,
                          G.g_tar.node_mask)
        loss.backward()
        ts1._step((opts["disc"],), list(model.discriminator.parameters()))
        return loss.detach()

    monkeypatch.setattr(ts1, "d_step", d_step)


def _frozen_adam(monkeypatch):
    ts1 = _program()
    plain = ts1.make_optimizers

    def frozen(model, capturable=False):
        opts = plain(model, capturable)
        for group in opts["target"].param_groups:
            group["lr"] = 0.0
        return opts

    monkeypatch.setattr(ts1, "make_optimizers", frozen)


def _one_class(monkeypatch):
    from bridged_gnn_tpu_torch.train.device_sampler import DevicePairSampler

    monkeypatch.setattr(DevicePairSampler, "_rows", lambda self, gen:
                        torch.zeros(self.m, dtype=torch.int64,
                                    device=self.device))


def _swapped_split(monkeypatch):
    ts1 = _program()
    plain = ts1.DeviceStage1Evaluator._counts

    def counts(self, z_src, z_tar, split, epoch):
        # each split's classifiers counted over the other split's rows
        masks = self.masks
        self.masks = dict(val=masks["test"], test=masks["val"])
        try:
            return plain(self, z_src, z_tar, split, epoch)
        finally:
            self.masks = masks

    monkeypatch.setattr(ts1.DeviceStage1Evaluator, "_counts", counts)


def _short_run(monkeypatch):
    import dataclasses

    system = load_module("systems", "stage1")
    plain = system.train_adversarial

    def short(src, tar, cfg, **kwargs):
        return plain(src, tar, dataclasses.replace(
            cfg, num_epoch=cfg.num_epoch - 1), **kwargs)

    monkeypatch.setattr(system, "train_adversarial", short)


def _dropout(monkeypatch, keep: float, scale: float):
    from bridged_gnn_tpu_torch.nn import common, stage1

    def drop(x, p, generator, draw_rows=None):
        mask = torch.empty_like(x).bernoulli_(keep, generator=generator)
        return x * mask * scale

    for module in (common, stage1):
        monkeypatch.setattr(module, "dropout", drop)


def _dropout_rate(monkeypatch):
    _dropout(monkeypatch, 0.8, 1 / 0.8)


def _dropout_scale(monkeypatch):
    _dropout(monkeypatch, 0.5, 1.0)


@pytest.mark.parametrize("fault", [
    _disc_skipped, _generator_grad, _frozen_adam, _one_class,
    _swapped_split, _short_run, _dropout_rate, _dropout_scale])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    _sound()
    fault(monkeypatch)
    out = _run(small())
    numbers = {k: c["value"] for k, c in out["checks"].items()}
    assert not out["correct"], out["checks"]
    assert _fails_clearly(numbers), (numbers, _sound())


# ------------------------------------------------------- the span readers


def _stage1_run(graphs, build, capture, scores, evals):
    kids = [_leaf("stage1.graphs", graphs), _leaf("stage1.build", build),
            _leaf("stage1.capture", capture)]
    for s, e in zip(scores, evals):
        kids.append(("stage1.score", s, {}, [_leaf("stage1.eval", e,
                                                   pairs=600)]))
    return ("stage1.train", 10.0, dict(segments=len(scores),
                                       evaluations=len(evals)), kids)


STAGE1_LOG = _log(_stage1_run(0.3, 0.1, 0.2, [0.02, 0.03], [0.01, 0.02]),
                  _stage1_run(0.5, 0.1, 0.1, [0.04], [0.03]))


@pytest.mark.parametrize("name,want", [
    ("prep_s.stage1", 0.5), ("capture_ms.stage1", 150.0),
    ("score_ms.stage1", 45.0), ("eval_ms.stage1", 30.0)])
def test_each_stage1_reader_reads_its_ranges(monkeypatch, name, want):
    _port(monkeypatch, STAGE1_LOG)
    ctx = SimpleNamespace(kind="train_runs", trace=object(), window={})
    assert load_metric(name).read(ctx) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", ["prep_s.stage1", "capture_ms.stage1",
                                  "score_ms.stage1", "eval_ms.stage1"])
def test_no_stage1_root_reads_nothing(monkeypatch, name):
    """A log of stage 2's ranges only, or none (a program from before the
    stage-1 ranges)."""
    ctx = SimpleNamespace(kind="train_runs", trace=object(), window={})
    _port(monkeypatch, _log(("stage2.train", 1.0, {}, [
        _leaf("stage2.graph", 0.2), _leaf("stage2.score", 0.1)])))
    assert load_metric(name).read(ctx) is None
    _port(monkeypatch, [])
    assert load_metric(name).read(ctx) is None


def test_the_cost_count_scales_with_the_work():
    costs = load_module("costs", "stage1")
    s = dict(n_src=100, n_tar=80, f_src=16, f_tar=16, c=4, h=8, layers=2,
             epochs=10, pairs=[25, 25, 25], eval_pairs=60, evals=5)
    base = costs.model_flops(s, "train")
    assert base > 0
    assert costs.model_flops(dict(s, evals=10), "train") > base
    assert costs.model_flops(dict(s, pairs=[50, 50, 50]), "train") > base
    # the evaluations are spread over the run's epochs
    assert costs.model_flops(dict(s, evals=0), "train") == \
        pytest.approx(costs.step_flops(s))


@pytest.mark.cuda
def test_stage1_control_readings_on_the_card(monkeypatch):
    """On the card at the cell's own size: the control fails a limit on
    three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    import readings

    lines = []
    monkeypatch.setattr(readings, "emit", lines.append)
    readings.main(["--workload", CELL, "--seeds", "101", "102", "103",
                   "--what", "control"])
    limits = load_cell(CELL).limits
    assert len(lines) == 3
    for line in lines:
        assert any(line["numbers"][k] > limits[k] for k in limits)
