"""PyTorch port, stage 1's scan mode, device sampling and device
evaluator against the JAX package and against the port's own loop, on
the CPU (where every scan epoch runs eagerly; the card's captured
replays are ``tests/test_torch_cuda.py``'s):

  * scan mode with host sampling against JAX's scan mode from the same
    init and pair stream at dropout 0: every epoch's losses, the
    evaluations (the port's against the JAX evaluator on the port's
    weights and pairs), the best epoch and, for v1, the final weights;
  * the segment bounds against the JAX trainer's ``verbose`` lines;
  * CPU scan against the CPU loop, bit for bit on one thread;
  * device sampling end to end, and JAX's ``ValueError`` without scan
    mode;
  * ``DeviceStage1Evaluator``: ``both`` against the two per-split
    calls, its scores against sklearn's F1 on the pairs it drew;
  * a resumed scan run against a straight one, host and device sampled.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch
from sklearn.metrics import f1_score

from bridged_gnn_tpu.train import stage1 as js1

from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.train import stage1 as ts1

from tests.test_torch_stage1 import (  # noqa: F401  (no_dropout: fixture)
    LOSS_RTOL,
    STEP_TOL,
    _cfg,
    _jcfg,
    domains,
    jax_graphs,
    jax_init,
    no_dropout,
)

# each group's learning rate (make_optimizers): an Adam step moves an
# element by about lr at most
GROUP_LR = {"source_learner": 1e-2, "target_learner": 1e-3,
            "discriminator": 1e-3}


@pytest.fixture
def one_thread():
    """One CPU thread: two runs of the same work give the same bits (with
    several, the reductions' order varies between runs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scan_cfg(backbone="gnn", sim_mode="cosine", **kw):
    return _cfg(backbone, sim_mode, **{**dict(
        num_epoch=6, start_eval_epoch=3, eval_per_epoch=3, scan_epochs=3),
        **kw})


def _record_jax_scan_losses(monkeypatch):
    """Per-epoch (sim, d, ae) losses of the JAX host-sampled scan."""
    seen = []
    real = js1.make_train_steps

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        scan_fn = out[4]
        host_scan = scan_fn._host_scan

        def scan(*a, **k):
            carry, ys = host_scan(*a, **k)
            seen.extend(np.stack([np.asarray(y) for y in ys[:3]], 1).tolist())
            return carry, ys

        scan_fn._host_scan = scan
        return out

    monkeypatch.setattr(js1, "make_train_steps", recording)
    return seen


def _with_jax_init(monkeypatch, variables):
    real_build = ts1.build_model

    def build(c, s, t, *_):
        model = real_build(c, s, t, "cpu")
        model.load_state_dict(state_dict_from_flax(model, variables))
        return model

    monkeypatch.setattr(ts1, "build_model", build)


# ------------------------------------------------------------ scan vs JAX


@pytest.mark.parametrize("backbone,sim_mode", [("gnn", "cosine"),
                                               ("mlp", "mlp")],
                         ids=["v1", "v2"])
def test_scan_matches_jax_scan(no_dropout, monkeypatch, backbone, sim_mode):
    """6 epochs in segments of 3 (evaluations at 3 and 6) from JAX's init
    and the same host pair stream: every epoch's losses within LOSS_RTOL
    of JAX's scan; every evaluation equal to the JAX evaluator's on the
    port's weights and pairs; the best epoch JAX's, and its dict the one
    those evaluations select.

    Final weights (v1): all but 1% of the elements within STEP_TOL of
    JAX's, the rest within 2·lr a step, an Adam step's size: they are the
    elements whose gradient is rounding noise (lin_self_0's bias, which
    lin_self_2's batch mean removes in train mode) and what those move.
    The mlp head (v2) has two such biases feeding a 2H×128 linear, and
    after 6 epochs 15% of its elements part by more than STEP_TOL while
    the losses still agree within 1e-5, so v2 is held by its losses and
    evaluations."""
    src, tar = domains()
    cfg = _scan_cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    seen = _record_jax_scan_losses(monkeypatch)
    jres = js1.train_adversarial(src, tar, dataclasses.replace(
        _jcfg(cfg), scan_epochs=cfg.scan_epochs))

    _with_jax_init(monkeypatch, variables)
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    jev = js1.Stage1Evaluator(jmodel, None, gs, adj_s, gt, adj_t, src, tar,
                              _jcfg(cfg), np.random.default_rng(0))
    evals, real_eval = [], ts1.Stage1Evaluator.__call__

    def replayed(self, split, epoch=0):
        rng = np.random.default_rng()
        rng.bit_generator.state = self.enus[split][0].rng.bit_generator.state
        got = real_eval(self, split, epoch)
        for enus in jev.enus.values():
            for e in enus:
                e.rng = rng
        want = jev(flax_variables_from_state_dict(
            self.model, self.model.state_dict()), split, epoch)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   err_msg=f"{split} at epoch {epoch}")
        evals.append((epoch, split, got))
        return got

    monkeypatch.setattr(ts1.Stage1Evaluator, "__call__", replayed)
    got = ts1.train_adversarial(src, tar, cfg, device="cpu")
    assert got["scan"]["segments"] == [(1, 3), (4, 6)]
    assert len(got["history"]) == len(seen) == cfg.num_epoch
    for h, losses in zip(got["history"], seen):
        for key, want in zip(("loss", "loss_d", "loss_ae"), losses):
            assert abs(h[key] - want) <= LOSS_RTOL * abs(want), (h, losses)
    assert [(e, s) for e, s, _ in evals] == [
        (3, "val"), (3, "test"), (6, "val"), (6, "test")]
    vals = {e: v for e, s, v in evals if s == "val"}
    epoch = max(vals, key=lambda e: (vals[e][4], -e))
    assert got["best"]["epoch"] == epoch == jres["best"]["epoch"]
    assert got["best"]["val"] == (vals[epoch][0], vals[epoch][2],
                                  vals[epoch][4])
    if backbone != "gnn":
        return
    want = state_dict_from_flax(got["model"], jres["variables"])
    far_total = total = 0
    for k, v in got["state_dict"].items():
        far = ~torch.isclose(v, want[k], **STEP_TOL)
        far_total += int(far.sum())
        total += v.numel()
        lr = GROUP_LR[k.split(".")[0]]
        d = (v - want[k]).abs()[far]
        assert not far.any() or float(d.max()) <= 2 * lr * epoch, k
    assert far_total <= 0.01 * total, (far_total, total)


GRID = [dict(num_epoch=7, start_eval_epoch=3, eval_per_epoch=2,
             scan_epochs=3),
        dict(num_epoch=9, start_eval_epoch=1, eval_per_epoch=4,
             scan_epochs=3),
        dict(num_epoch=8, start_eval_epoch=5, eval_per_epoch=1,
             scan_epochs=5)]


@pytest.mark.parametrize("grid", GRID, ids=["a", "b", "c"])
def test_segment_bounds_match_jax_verbose_lines(grid):
    """The segments ``segment_bounds`` lays out, and the port trainer's
    ``verbose`` segment lines, are the JAX trainer's ``epochs a-b``
    lines."""
    src, tar = domains()
    cfg = _cfg("mlp", "mlp", hidden_dim=8, verbose=True, **grid)
    pattern = re.compile(r"\] epochs (\d+)-(\d+) ")
    lines = {}
    for name, run in (
            ("jax", lambda: js1.train_adversarial(src, tar, dataclasses.replace(
                _jcfg(cfg), scan_epochs=cfg.scan_epochs, verbose=True))),
            ("port", lambda: ts1.train_adversarial(src, tar, cfg,
                                                   device="cpu"))):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            run()
        lines[name] = [tuple(map(int, m.groups()))
                       for m in pattern.finditer(text.getvalue())]
    assert lines["port"] == lines["jax"] == ts1.segment_bounds(1, cfg)


# ------------------------------------------------------------ scan vs loop


@pytest.mark.parametrize("backbone,sim_mode", [("gnn", "cosine"),
                                               ("mlp", "mlp")],
                         ids=["v1", "v2"])
def test_cpu_scan_equals_cpu_loop(one_thread, backbone, sim_mode):
    """On the CPU scan mode runs the loop's steps on the loop's pairs and
    dropout masks: the same history, best dict and weights, bit for bit,
    at the default dropout."""
    src, tar = domains()
    cfg = _cfg(backbone, sim_mode, num_epoch=7, start_eval_epoch=3,
               eval_per_epoch=2)
    loop = ts1.train_adversarial(src, tar, cfg, device="cpu")
    scan = ts1.train_adversarial(src, tar, dataclasses.replace(
        cfg, scan_epochs=3), device="cpu")
    assert loop["scan"] is None
    assert scan["scan"] == dict(eager_epochs=7, captures=0, replays=0,
                                launches_per_replay={},
                                segments=[(1, 2), (3, 4), (5, 6), (7, 7)])
    assert scan["history"] == loop["history"]
    assert scan["best"] == loop["best"]
    assert scan["eval_s"] and len(scan["eval_s"]) == len(loop["eval_s"])
    for k, t in loop["state_dict"].items():
        assert torch.equal(scan["state_dict"][k], t), k
    assert scan["throughput"]["steps"] == 7


# -------------------------------------------------------- device sampling


def test_device_sampling_runs_and_checks_numerics():
    src, tar = domains()
    cfg = _scan_cfg(device_sampling=True, check_numerics=True)
    res = ts1.train_adversarial(src, tar, cfg, device="cpu")
    assert res["best"]["epoch"] in (3, 6)
    assert all(0.0 <= v <= 1.0 for v in res["best"]["val"])
    assert np.all(np.isfinite([h["loss"] for h in res["history"]]))
    assert [h["epoch"] for h in res["history"]] == list(range(1, 7))


def test_device_sampling_requires_scan_mode():
    src, tar = domains()
    with pytest.raises(ValueError, match="scan_epochs"):
        ts1.train_adversarial(src, tar, _cfg("mlp", "mlp",
                                             device_sampling=True),
                              device="cpu")


# ------------------------------------------------------- device evaluator


def _device_evaluator(seed=0):
    src, tar = domains()
    cfg = _scan_cfg("mlp", "mlp", device_sampling=True, num_epoch=12,
                    scan_epochs=6, start_eval_epoch=13,
                    eval_sample_size=1200)
    res = ts1.train_adversarial(src, tar, cfg, device="cpu")
    G = ts1.prepare_stage1_graphs(src, tar, "mlp", "cpu")
    return ts1.DeviceStage1Evaluator(res["model"], G, src, tar, cfg,
                                     seed), res["model"], G, src, tar


def test_device_evaluator_both_equals_per_split_calls():
    ev, *_ = _device_evaluator()
    val, test = ev.both(7)
    assert val == ev("val", 7) and test == ev("test", 7)
    assert ev.both(7) == (val, test)
    assert 0.0 < val[4] < 1.0

    def drawn(e, split, epoch):
        return torch.cat([torch.cat(p) for p in e.draw(split, epoch).values()])

    # another epoch, split or seed draws other pairs
    for other in ((ev, "val", 8), (ev, "test", 7),
                  (_device_evaluator(seed=1)[0], "val", 7)):
        assert not torch.equal(drawn(*other), drawn(ev, "val", 7)), other[1:]


@pytest.mark.parametrize("split", ["val", "test"])
def test_device_evaluator_scores_equal_sklearn_on_its_pairs(split):
    """Each score the evaluator forms from its counts is sklearn's F1 of
    the same predictions: binary F1 over the pairs it drew (scored on the
    host from the same embeddings), macro F1 of the classifier over the
    split's rows (y == -1 a label of its own, as sklearn takes it)."""
    ev, model, G, src, tar = _device_evaluator()
    got = ev(split, 5)
    z_src, z_tar = ev.encode()
    sim = model.source_learner.sim_net
    pairs = ev.draw(split, 5)
    with torch.no_grad():
        probs = dict(src=sim.similarity(z_src, *pairs["src"]),
                     tar=sim.similarity(z_tar, *pairs["tar"]),
                     cross=sim.similarity_cross_domain(z_src, z_tar,
                                                       *pairs["cross"]))
        preds = [sim.classify(z).argmax(1).numpy() for z in (z_src, z_tar)]
    ys, yt = np.asarray(src["y"]), np.asarray(tar["y"])

    def pair_f1(rel, y1, y2):
        i1, i2 = (p.numpy() for p in pairs[rel])
        return f1_score((y1[i1] == y2[i2]).astype(int),
                        (probs[rel].numpy() > 0.5).astype(int))

    def clf_f1(data, y, pred):
        m = np.asarray(data[f"{split}_mask"])
        return f1_score(y[m], pred[: len(m)][m], average="macro")

    want = [pair_f1("src", ys, ys), clf_f1(src, ys, preds[0]),
            pair_f1("tar", yt, yt), clf_f1(tar, yt, preds[1]),
            pair_f1("cross", ys, yt)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_device_evaluator_is_engaged_by_jax_rule():
    src, tar = domains()
    for kw, device in ((dict(device_sampling=True), True),
                       (dict(device_sampling=True, metric="auc"), False),
                       (dict(device_sampling=True, eval_mode="all"), False),
                       (dict(device_sampling=True, conf_lower_bound=0.3),
                        False),
                       (dict(), False)):
        assert ts1.use_device_evaluator(_scan_cfg(**kw)) == device, kw


# ------------------------------------------------------------------ resume


@pytest.mark.parametrize("device_sampling", [False, True],
                         ids=["host", "device"])
def test_scan_resume_equals_straight_run(one_thread, tmp_path,
                                         device_sampling):
    """A scan run checkpointed at its first segment's end (epoch 3) and
    resumed continues the straight run: the host sampler's, the dropout
    generator's and the device sampler's states come back, so epochs 4-6,
    the evaluation at 6 and the weights are the straight run's, bit for
    bit."""
    src, tar = domains()
    cfg = _scan_cfg(device_sampling=device_sampling, start_eval_epoch=6)
    straight = ts1.train_adversarial(src, tar, cfg, device="cpu")
    ck = str(tmp_path / "ck")
    ts1.train_adversarial(src, tar, dataclasses.replace(
        cfg, num_epoch=3, ckpt_dir=ck), device="cpu")
    resumed = ts1.train_adversarial(src, tar, dataclasses.replace(
        cfg, ckpt_dir=ck, resume=True), device="cpu")
    assert resumed["scan"]["segments"] == [(4, 6)]
    assert resumed["history"] == straight["history"][3:]
    assert resumed["best"] == straight["best"]
    for k, t in straight["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], t), k
