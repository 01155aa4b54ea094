"""PyTorch port, the trainer's options: scan mode against the per-epoch
loop and against the JAX package's scan mode, the device-side confusion
counts against numpy, ``check_numerics``, ``memory_policy`` ("lean"
against "plain", "auto"), resuming a scan run, ``--profile_dir`` and the
console entry points. CPU only: on the CPU scan mode runs its epoch body
eagerly with the same buffers and the same host scoring as on the card.
"""

import json
import sys

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.io.serialize import save_graph_npz
from bridged_gnn_tpu.nn.ktgnn import KTGNN as JKTGNN
from bridged_gnn_tpu.train import stage2 as js2

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli2
from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
)
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.checkpoint import TrainCheckpointer
from bridged_gnn_tpu_torch.train.metrics import (
    confusion_counts,
    eval_metric,
    score_from_counts,
)
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    prepare_stage2_graph,
    resolve_memory_policy,
    stage2_loss,
    train_ktgnn,
)

from tests.test_torch_cuda import skewed_data
from tests.test_torch_graph import sync_data


def _data(case):
    """The sync graph with a few unlabeled val/test rows (y == -1), or the
    skewed graph whose layouts are degree tiers."""
    if case == "tiered":
        data = skewed_data(np.random.default_rng(5), n=160, c=3, d=12)
        data["test_mask"] = ~data["train_mask"]
        return data
    data = sync_data()
    data["y"] = data["y"].copy()
    data["y"][np.flatnonzero(~data["train_mask"])[::7]] = -1
    return data


def _cfg(**kw):
    return Stage2Config(**{**dict(num_epoch=9, hidden=8, lr=1e-2,
                                  step_size=3, log_every=0), **kw})


def _method(case):
    return "tiered" if case == "tiered" else "blocked"


# ------------------------------------------------------- scan against loop


@pytest.mark.parametrize("case", ["single", "tiered"])
def test_scan_equals_loop(case):
    """Scan mode (chunks of 4, 4 and 1 epochs; the rate falls at epochs 4
    and 7, inside chunks) gives the per-epoch loop's history, best dict
    and final weights exactly, at dropout 0.5 from one generator."""
    data = _data(case)
    kw = dict(adjacency_method=_method(case), dropout=0.5)
    loop = train_ktgnn(data, _cfg(**kw), device="cpu")
    scan = train_ktgnn(data, _cfg(scan_epochs=4, **kw), device="cpu")
    assert loop["scan"] is None
    assert scan["scan"] == dict(eager_epochs=9, captures=0, replays=0,
                                launches_per_replay={})
    assert [h["epoch"] for h in scan["history"]] == list(range(1, 10))
    assert scan["history"] == loop["history"]
    assert scan["best"] == loop["best"]
    for k, t in loop["state_dict"].items():
        assert torch.equal(scan["state_dict"][k], t), k
    assert scan["throughput"]["steps"] == 9


@pytest.mark.parametrize("metric,average,save,scan", [
    ("f1", "macro", False, True), ("acc", "macro", False, True),
    ("f1", "binary", False, True), ("auc", "macro", False, False),
    ("f1", "macro", True, False),
])
def test_scan_eligibility(tmp_path, metric, average, save, scan):
    """The JAX rule: scan runs for f1 (macro, binary) and acc without a
    best-weights pickle; otherwise the loop runs, with the same history."""
    data = _data("single")
    data["y"] = np.where(data["y"] < 0, 0, data["y"]) % 2      # binary
    kw = dict(metric=metric, f1_average=average, num_epoch=3,
              save_best_path=str(tmp_path / "b.pkl") if save else None)
    res = train_ktgnn(data, _cfg(scan_epochs=2, **kw), device="cpu")
    assert (res["scan"] is not None) == scan
    loop = train_ktgnn(data, _cfg(**kw), device="cpu")
    assert res["history"] == loop["history"]


def test_scan_matches_jax_scan(monkeypatch):
    """The port's scan run against the JAX package's, both from the
    port's seeded init (carried to flax by io/flax_weights.py), at
    dropout 0 and 8 epochs in chunks of 4 with the rate falling at epoch
    4. Losses agree at rtol 1e-4: the JAX package sums in another order
    (its CPU path has no kernels and lays out 256-row blocks, the port
    128) and Adam amplifies that f32 noise over the epochs. The scores
    agree to 1e-12: the confusion counts are the same, and the JAX
    package's F1 formula 2·P·R / (P + R) rounds differently from
    2·tp / (pred + true)."""
    data = _data("single")
    kw = dict(num_epoch=8, hidden=8, lr=1e-2, step_size=4, dropout=0.0,
              scan_epochs=4, adjacency_method="blocked", log_every=0)
    port = train_ktgnn(data, Stage2Config(**kw), device="cpu")

    g, _ = prepare_stage2_graph(data, Stage2Config(**kw), "cpu")
    init = ts2.build_model(Stage2Config(**kw), g.num_classes,
                           g.num_features, "cpu")
    variables = flax_variables_from_state_dict(init, init.state_dict())
    monkeypatch.setattr(JKTGNN, "init", lambda self, *a, **k: variables)
    jres = js2.train_ktgnn(data, js2.Stage2Config(**kw))

    assert [h["epoch"] for h in port["history"]] == \
        [h["epoch"] for h in jres["history"]] == list(range(1, 9))
    for hp, hj in zip(port["history"], jres["history"]):
        for key in ("loss", "loss_t2"):
            assert hp[key] == pytest.approx(hj[key], rel=1e-4), hp["epoch"]
        for key in ("train", "val", "test"):
            assert hp[key] == pytest.approx(hj[key], abs=1e-12), hp["epoch"]
    assert port["best"]["epoch"] == jres["best"]["epoch"]
    for name, v in jres["best"]["per_head"].items():
        assert port["best"]["per_head"][name] == pytest.approx(v, abs=1e-12)


# ------------------------------------------------------------ the counts


def _counts_np(y, pred, mask, c):
    y_bin = np.where(y < 0, c, y)
    return np.stack([
        [np.sum(mask & (y_bin == b) & (pred == b)) for b in range(c + 1)],
        [np.sum(mask & (pred == b)) for b in range(c + 1)],
        [np.sum(mask & (y_bin == b)) for b in range(c + 1)],
    ])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_counts_match_numpy(seed):
    """The device-side tables against numpy counts of the same
    predictions, with y == -1 rows, classes absent from y and classes
    never predicted, and an empty mask; and scoring them gives
    eval_metric's floats."""
    rng = np.random.default_rng(seed)
    t, n, c = 4, 300, 6
    y = rng.integers(0, 4, size=n)              # classes 4, 5 never true
    y[rng.random(n) < 0.15] = -1
    preds = rng.integers(0, 5, size=(t, n))      # class 5 never predicted
    masks = rng.random((t, n)) < 0.6
    masks[-1] = False
    got = confusion_counts(
        torch.from_numpy(preds), torch.from_numpy(masks).int(),
        torch.from_numpy(np.where(y < 0, c, y)), c + 1)
    assert got.dtype == torch.int64 and got.shape == (t, 3, c + 1)
    for k in range(t):
        np.testing.assert_array_equal(got[k].numpy(),
                                      _counts_np(y, preds[k], masks[k], c))
        for metric in ("f1", "acc"):
            want = (eval_metric(y[masks[k]], preds[k][masks[k]], metric)
                    if masks[k].any() else 0.0)
            assert score_from_counts(*got[k].numpy(), metric=metric) == want


# -------------------------------------------------------- check_numerics


@pytest.mark.parametrize("scan_epochs", [0, 2])
def test_check_numerics_clean_run(scan_epochs):
    res = train_ktgnn(_data("single"),
                      _cfg(num_epoch=4, check_numerics=True,
                           scan_epochs=scan_epochs), device="cpu")
    assert np.all(np.isfinite([h["loss"] for h in res["history"]]))
    # no spread probe: the port's kernels shift by each row's own max
    assert res["max_logit_spread"] == 0.0


@pytest.mark.parametrize("scan_epochs", [0, 2])
def test_check_numerics_raises_on_nan_parameter(monkeypatch, scan_epochs):
    build = ts2.build_model

    def poisoned(*a, **k):
        model = build(*a, **k)
        with torch.no_grad():
            model.clf_transformer.lin_3.weight[0, 0] = float("nan")
        return model

    monkeypatch.setattr(ts2, "build_model", poisoned)
    cfg = _cfg(num_epoch=4, scan_epochs=scan_epochs)
    # the guard is off by default
    assert not np.isfinite(
        train_ktgnn(_data("single"), cfg, device="cpu")["history"][0]["loss"])
    cfg.check_numerics = True
    with pytest.raises(FloatingPointError, match="non-finite"):
        train_ktgnn(_data("single"), cfg, device="cpu")


def test_assert_all_finite_names_the_leaf():
    from bridged_gnn_tpu_torch.utils.sanitizers import assert_all_finite

    tree = {"loss": np.array([1.0, 2.0]),
            "params": {"a": torch.ones(3), "b": torch.tensor([0.0, np.inf])},
            "steps": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match=r"\['params'\]\['b'\]"):
        assert_all_finite(tree, "state")
    assert_all_finite({"ok": [torch.zeros(2), np.ones(1)]})


# --------------------------------------------------------- memory_policy


@pytest.mark.parametrize("case", ["single", "tiered"])
def test_lean_step_matches_plain(case):
    """One train step with the embedding conv recomputed in the backward
    gives the plain step's loss, gradients and BN statistics (rtol 1e-5),
    and a lean run the plain run's history."""
    data = _data(case)
    cfg = _cfg(adjacency_method=_method(case), hidden=16, dropout=0.5)
    g, adj = prepare_stage2_graph(data, cfg, "cpu")
    out = {}
    for remat in (False, True):
        model = ts2.build_model(cfg, g.num_classes, g.num_features, "cpu",
                                remat=remat)
        loss, _ = stage2_loss(model, g, adj, cfg.Lambda,
                              torch.Generator().manual_seed(3))
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in
                                      model.named_parameters()},
                      dict(model.named_buffers()))
    (lp, gp, bp), (ll, gl, bl) = out[False], out[True]
    torch.testing.assert_close(ll, lp, rtol=1e-5, atol=0)
    for name in gp:
        torch.testing.assert_close(gl[name], gp[name], rtol=1e-5, atol=1e-8,
                                   msg=name)
    for name in bp:
        torch.testing.assert_close(bl[name], bp[name], rtol=1e-5, atol=0,
                                   msg=name)
    plain = train_ktgnn(data, _cfg(adjacency_method=_method(case),
                                   num_epoch=3), device="cpu")
    lean = train_ktgnn(data, _cfg(adjacency_method=_method(case),
                                  num_epoch=3, memory_policy="lean"),
                       device="cpu")
    assert (plain["memory_policy"], lean["memory_policy"]) == ("plain",
                                                               "lean")
    for hp, hl in zip(plain["history"], lean["history"]):
        assert hl["loss"] == pytest.approx(hp["loss"], rel=1e-5)


def test_auto_memory_policy():
    """'auto' is plain on every device: on the CPU as in JAX, and on the
    card because lean does not lower the step's peak there (the per-slot
    cotangent of the backward sets it). 'plain' and 'lean' are kept."""
    for policy, want in (("auto", "plain"), ("plain", "plain"),
                         ("lean", "lean")):
        assert resolve_memory_policy(_cfg(memory_policy=policy)) == want
    assert train_ktgnn(_data("single"), _cfg(num_epoch=1), device="cpu")[
        "memory_policy"] == "plain"


# ----------------------------------------------------------------- resume


def test_scan_resume_matches_uninterrupted(tmp_path):
    """A scan run stopped at a chunk boundary (epoch 4) and resumed to
    epoch 9 gives the uninterrupted run's history, best and weights, and
    so does the per-epoch loop resumed from it: the checkpoint holds the
    model, Adam (with the scheduled rate), the generator, best and the
    epoch."""
    data = _data("single")
    kw = dict(scan_epochs=2, dropout=0.5)
    full = train_ktgnn(data, _cfg(ckpt_dir=str(tmp_path / "a"), **kw),
                       device="cpu")
    train_ktgnn(data, _cfg(num_epoch=4, ckpt_dir=str(tmp_path / "b"), **kw),
                device="cpu")
    assert TrainCheckpointer(str(tmp_path / "b")).steps() == [2, 4]
    resumed = train_ktgnn(data, _cfg(ckpt_dir=str(tmp_path / "b"),
                                     resume=True, **kw), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == list(range(5, 10))
    assert resumed["history"] == full["history"][4:]
    assert resumed["best"] == full["best"]
    for k, t in full["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], t), k
    assert TrainCheckpointer(str(tmp_path / "b")).steps() == [6, 8, 9]
    # the per-epoch loop resumes a scan checkpoint alike
    train_ktgnn(data, _cfg(num_epoch=4, ckpt_dir=str(tmp_path / "c"), **kw),
                device="cpu")
    looped = train_ktgnn(data, _cfg(ckpt_dir=str(tmp_path / "c"),
                                    resume=True, dropout=0.5), device="cpu")
    assert looped["scan"] is None
    assert looped["history"] == full["history"][4:]


def test_scan_resumes_a_loop_checkpoint(tmp_path):
    """Scan mode resumed from the per-epoch loop's checkpoint (a float
    rate, StepLR) gives the uninterrupted scan run's epochs: the saved
    rate goes into the tensor the epoch body sets, and Adam keeps its own
    kind (``load_optimizer_state``)."""
    data = _data("single")
    full = train_ktgnn(data, _cfg(scan_epochs=2, dropout=0.5),
                       device="cpu")
    train_ktgnn(data, _cfg(num_epoch=4, ckpt_dir=str(tmp_path), dropout=0.5,
                           ckpt_every=4), device="cpu")
    resumed = train_ktgnn(data, _cfg(ckpt_dir=str(tmp_path), resume=True,
                                     scan_epochs=2, dropout=0.5),
                          device="cpu")
    assert resumed["scan"] is not None
    assert resumed["history"] == full["history"][4:]
    for k, t in full["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], t), k


# -------------------------------------------------------- CLI and scripts


def test_cli_profile_dir_writes_a_trace(tmp_path, capsys):
    data = _data("single")
    npz = str(tmp_path / "g.npz")
    save_graph_npz(npz, data)
    prof = tmp_path / "prof"
    argv = ["--path_data", npz, "--num_epoch", "3", "--hidden_dim", "8",
            "--scan_epochs", "2", "--check_numerics", "--memory_policy",
            "lean", "--profile_dir", str(prof), "--log_every", "1",
            "--device", "cpu"]
    res = tcli2.main(tcli2.build_argparser().parse_args(argv))
    out = capsys.readouterr().out
    assert f"profiler trace written to {prof}" in out
    assert "Epoch 003 loss" in out and "[memory_policy] lean" in out
    assert res["scan"] is not None and len(res["history"]) == 3
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("cli", [tcli2, tcli], ids=["train", "serve"])
def test_cli_entry_parses_help(cli, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["prog", "--help"])
    with pytest.raises(SystemExit) as exc:
        cli.cli_entry()
    assert exc.value.code == 0
    assert "--device" in capsys.readouterr().out
