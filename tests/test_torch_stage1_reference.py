"""PyTorch port, stage 1 against the benchmark's plain reference
(``benchmark/reference/stage1.py``, loaded by path), on seeded random
weights at a small size on the CPU: 256 nodes a domain, 16 features, 4
classes, hidden 16, 3 epochs, in the loop (host-sampled pairs) and in scan
mode with device sampling and the device evaluator.

The program's own pairs and dropout masks are read from its run (the
masks as the nonzeros of each dropout's output: where the layer before
it is zero the mask changes nothing) and fed to the reference, which
starts from the initial weights it works out itself from the seed. Each
epoch's three losses, every leaf and batch-norm statistic after each
epoch, and at the evaluation epoch the device evaluator's counts are
compared. Imports no JAX.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
from bridged_gnn_tpu_torch.nn import common, stage1 as nn_stage1
from bridged_gnn_tpu_torch.train import stage1 as ts1

ROOT = Path(__file__).resolve().parents[1]
EPOCHS, CLASSES, HIDDEN = 3, 4, 16
# the order train_forward draws its dropout masks in
SITES = ("source.backbone.1", "clf.source", "target.encoder.1",
         "clf.target")
# Both sides run float32 on the CPU with the same operations but not the
# same reductions (the batch norms' masked sums, the gathers' backward):
# the losses agree to a few float32 roundings over three steps, and so do
# the weights (of order 0.1) after three Adam steps.
LOSS_RTOL = 2e-6
LEAF_TOL = dict(rtol=1e-5, atol=1e-7)
# The pair head's first two shifts (the first batch norm's bias and the
# first linear's) reach the second batch norm only as a shift of its
# input, which its batch statistics take out: in exact arithmetic they
# have no gradient, and Adam turns their round-off into steps of either
# sign. They, and that batch norm's running mean, which takes their steps
# in, are compared by their shape alone.
SHIFTS = ("source_learner.sim_net.lin_self_0.bias",
          "source_learner.sim_net.lin_self_1.bias",
          "source_learner.sim_net.lin_self_2.running_mean")


def _reference():
    path = ROOT / "benchmark" / "reference" / "stage1.py"
    spec = importlib.util.spec_from_file_location("bench_reference_stage1",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


ref = _reference()


def _domains():
    data = make_benchmark_graph(n=512, avg_degree=4, dim=16,
                                num_classes=CLASSES, seed=11)
    src, tar, _, _ = dataset_conversion(data, seed=11)
    return src, tar


def _run(monkeypatch, scan: bool):
    """The program's run, its pairs and masks by epoch, its state after
    each epoch, and the device evaluator's pairs and counts."""
    src, tar = _domains()
    cfg = ts1.Stage1Config(
        hidden_dim=HIDDEN, num_epoch=EPOCHS, start_eval_epoch=EPOCHS,
        max_class_num=CLASSES, sample_size=400, eval_sample_size=400,
        seed=7, scan_epochs=2 if scan else 0, device_sampling=scan)
    seen = dict(pairs=[], masks=[], after=[], eval_pairs={}, counts={})
    plain_dropout, plain_sim, plain_d = common.dropout, ts1.sim_step, \
        ts1.d_step

    def dropout(x, p, generator, draw_rows=None):
        out = plain_dropout(x, p, generator, draw_rows)
        seen["masks"][-1].append(out != 0)
        return out

    def sim_step(model, opts, G, idxs, y_pairs, use_clf, generator):
        seen["pairs"].append({k: v.clone() for k, v in idxs.items()})
        seen["masks"].append([])
        return plain_sim(model, opts, G, idxs, y_pairs, use_clf, generator)

    def d_step(model, opts, G, h_src, h_tar):
        loss = plain_d(model, opts, G, h_src, h_tar)
        seen["after"].append({k: v.detach().clone()
                              for k, v in model.state_dict().items()})
        return loss

    plain_draw = ts1.DeviceStage1Evaluator.draw
    plain_counts = ts1.DeviceStage1Evaluator._counts

    def draw(self, split, epoch=0):
        pairs = plain_draw(self, split, epoch)
        seen["eval_pairs"][split] = pairs
        return pairs

    def counts(self, z_src, z_tar, split, epoch):
        out = plain_counts(self, z_src, z_tar, split, epoch)
        seen["counts"][split] = out
        return out

    for module in (common, nn_stage1):
        monkeypatch.setattr(module, "dropout", dropout)
    monkeypatch.setattr(ts1, "sim_step", sim_step)
    monkeypatch.setattr(ts1, "d_step", d_step)
    monkeypatch.setattr(ts1.DeviceStage1Evaluator, "draw", draw)
    monkeypatch.setattr(ts1.DeviceStage1Evaluator, "_counts", counts)
    out = ts1.train_adversarial(src, tar, cfg, device="cpu")
    return src, tar, cfg, out, seen


def _reference_epochs(S, cfg, seen, epochs):
    steps = []
    for idxs, masks in zip(seen["pairs"][:epochs], seen["masks"][:epochs]):
        y = {rel: (S[f"y_{a}"][idxs[f"{rel}1"]]
                   == S[f"y_{b}"][idxs[f"{rel}2"]]).float()
             for rel, (a, b) in (("src", ("src", "src")),
                                 ("tar", ("tar", "tar")),
                                 ("cross", ("src", "tar")))}
        steps.append((idxs, y, dict(zip(SITES, masks))))
    start = ref.init_state(cfg.seed, S, cfg.hidden_dim, cfg.num_layer, "cpu")
    return start, ref.train_steps(start, S, cfg.num_layer, steps, ref.JUDGE)


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scan"])
def test_stage1_follows_the_reference(monkeypatch, scan):
    src, tar, cfg, out, seen = _run(monkeypatch, scan)
    S = ref.domains(src, tar, "cpu")
    assert len(seen["pairs"]) == len(seen["after"]) == EPOCHS
    assert all(len(m) == len(SITES) for m in seen["masks"])
    _, whole = _reference_epochs(S, cfg, seen, EPOCHS)
    for t in range(1, EPOCHS + 1):
        _, upto = _reference_epochs(S, cfg, seen, t)
        prog = seen["after"][t - 1]
        assert set(prog) == set(upto["state"])
        for k, r in upto["state"].items():
            if k in SHIFTS:
                assert prog[k].shape == r.shape, k
                continue
            torch.testing.assert_close(prog[k], r, **LEAF_TOL,
                                       msg=f"{k} after epoch {t}")
    history = [(h["loss"], h["loss_d"], h["loss_ae"]) for h in out["history"]]
    for p, r in zip(history, whole["losses"]):
        assert p == pytest.approx(r, rel=LOSS_RTOL)
    if scan:
        # the device evaluator's counts at the evaluation epoch, from the
        # weights after it; a prediction flips only where a probability
        # lies within float32 rounding of 0.5
        counts = ref.eval_counts(seen["after"][-1], S, cfg.num_layer,
                                 seen["eval_pairs"])
        for split, c in counts.items():
            assert torch.equal(seen["counts"][split], c), split
