"""PyTorch port, stage-2 training: one train step's gradients and batch
statistics against ``jax.grad`` through the JAX KT-GNN (Pallas forward
and backward in interpret mode), five Adam + StepLR steps against a loop
built from the JAX package's ``torch_adam``/``step_lr``/``masked_nll``/
``kl_batchmean``, the numpy metrics against sklearn, checkpoint resume,
the flax pickle that both serving CLIs load, the training CLI, and the
options that are not ported."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.cli import serve as jcli
from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.io.serialize import save_graph_npz
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.train import metrics as jmetrics
from bridged_gnn_tpu.train import stage2 as js2
from bridged_gnn_tpu.train.optim import step_lr, torch_adam
from bridged_gnn_tpu.utils.diagnostics import (
    eval_bridged_graph as j_eval_bridged_graph,
)

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli2
from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.train import metrics as tmetrics
from bridged_gnn_tpu_torch.train.checkpoint import TrainCheckpointer
from bridged_gnn_tpu_torch.train.optim import make_optimizer
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    prepare_stage2_graph,
    stage2_loss,
    train_ktgnn,
    train_step,
)
from bridged_gnn_tpu_torch.utils.diagnostics import eval_bridged_graph

from tests.test_torch_cuda import skewed_data
from tests.test_torch_graph import sync_data
from tests.test_torch_ktgnn import (
    CLASSES,
    DIM,
    HIDDEN,
    _compare_app_answers,
    _jax_variables,
    _port_model,
)

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _data(case):
    data = (sync_data(dim=DIM, num_classes=CLASSES) if case == "sync"
            else skewed_data(np.random.default_rng(5), n=160, c=CLASSES,
                             d=DIM))
    data = dict(data)
    if not data["test_mask"].any():
        data["test_mask"] = ~data["train_mask"]
    return data


@pytest.fixture(scope="module", params=[("sync", "blocked"),
                                        ("skew", "tiered")],
                ids=["single", "tiered"])
def case(request):
    """Data, JAX model, its variables (random BN statistics), and both
    packages' graphs and adjacencies (node_block 128)."""
    name, method = request.param
    data = _data(name)
    jmodel, variables = _jax_variables(data, seed=2)
    jk = jmodel.clone(fused_kernel_fwd=True, fused_kernel_bwd=True,
                      select_gather=True, dropout=0.0)
    cfg = Stage2Config(hidden=HIDDEN, adjacency_method=method)
    gt, at = prepare_stage2_graph(data, cfg, device="cpu")
    jdata = dict(data, train_mask=gt.train_mask[: gt.num_nodes].numpy())
    gj = j_with_self_loops(j_graph_from_dict(jdata))
    aj = j_adj(gj, method=method, node_block=128)
    assert (at.tiered_fn is None) == (aj.tiered_fn is None) \
        == (method == "blocked")
    return dict(jk=jk, variables=jax.tree.map(np.asarray, variables),
                gj=gj, aj=aj, gt=gt, at=at)


def _jax_loss(jk, gj, aj, lam=1.0):
    def loss_fn(params, batch_stats):
        outs, mut = jk.apply({"params": params, "batch_stats": batch_stats},
                             gj, aj, True, mutable=["batch_stats"])
        lp_s, lp_t, lp_that = outs[:3]
        tar = gj.train_mask & ~gj.central_mask
        loss = ((2.0 * js2.masked_nll(lp_s, gj.y, gj.train_mask)
                 + js2.masked_nll(lp_t, gj.y, tar)
                 + js2.masked_nll(lp_that, gj.y, tar)) / 4.0
                + lam * js2.kl_batchmean(lp_that, lp_t, gj.node_mask))
        return loss, mut["batch_stats"]

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port(case_):
    model = _port_model(case_["variables"])
    model.dropout = 0.0
    return model


def test_train_step_grads_and_bn_match_jax(case):
    """Loss, every parameter's gradient and the BN running statistics of
    one train-mode step, weights carried by state_dict_from_flax."""
    v = case["variables"]
    (loss_j, bs_j), grads_j = _jax_loss(case["jk"], case["gj"], case["aj"])(
        v["params"], v["batch_stats"])
    model = _port(case)
    want = state_dict_from_flax(model, jax.tree.map(
        np.asarray, {"params": grads_j, "batch_stats": bs_j}))
    loss, _ = stage2_loss(model, case["gt"], case["at"], 1.0, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    for name, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_adam_steplr_steps_match_jax_loop(case):
    """Five steps of Adam (L2 weight decay) with StepLR(2, 0.5): the
    losses at rtol 1e-4 and the weights and BN statistics after the last
    step at rtol 1e-3, atol 1e-5."""
    lr, wd, step, gamma = 1e-2, 5e-3, 2, 0.5
    tx = torch_adam(step_lr(lr, step, gamma), weight_decay=wd)
    step_j = _jax_loss(case["jk"], case["gj"], case["aj"])
    params = jax.tree.map(jnp.asarray, case["variables"]["params"])
    bs = case["variables"]["batch_stats"]
    opt_state = tx.init(params)
    losses_j = []
    for _ in range(5):
        (loss, bs), grads = step_j(params, bs)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        losses_j.append(float(loss))
    model = _port(case)
    want = state_dict_from_flax(model, jax.tree.map(
        np.asarray, {"params": params, "batch_stats": bs}))

    opt, sched = make_optimizer(model.parameters(), lr, wd, True, step,
                                gamma)
    losses = []
    for _ in range(5):
        loss, _ = train_step(model, case["gt"], case["at"], opt, 1.0, None)
        sched.step()
        losses.append(float(loss))
    assert sched.get_last_lr() == [lr * gamma ** (5 // step)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------ metrics


def _labels(rng, n, c, with_unlabeled):
    y = rng.integers(0, c, size=n)
    if with_unlabeled:
        y[rng.random(n) < 0.1] = -1
    return y


@pytest.mark.parametrize("metric,average,c,unlabeled", [
    ("f1", "macro", 5, False), ("f1", "macro", 5, True),
    ("f1", "macro", 2, False), ("f1", "binary", 2, False),
    ("acc", "macro", 4, True), ("auc", "macro", 2, False),
])
def test_metrics_match_sklearn(rng, metric, average, c, unlabeled):
    """eval_metric (numpy only) against the JAX package's sklearn-backed
    eval_metric, over random draws, labels missing from either side and
    tied scores; score_from_counts against the JAX version too."""
    for trial in range(20):
        n = int(rng.integers(1, 60))
        y = _labels(rng, n, c, unlabeled)
        pred = rng.integers(0, c - (trial % 2), size=n)
        probs = np.round(rng.random(n), 1)         # ties
        if metric == "auc" and len(np.unique(y)) < 2:
            continue
        kw = dict(metric=metric, f1_average=average, probs_pos=probs)
        assert tmetrics.eval_metric(y, pred, **kw) == pytest.approx(
            jmetrics.eval_metric(y, pred, **kw), abs=1e-12)
        if metric == "auc":
            continue
        ybin = np.where(y < 0, c, y)
        counts = [np.bincount(a, minlength=c + 1) for a in (
            np.where(ybin == pred, ybin, c + 1)[ybin == pred], pred, ybin)]
        counts = [a[: c + 1] for a in counts]
        assert tmetrics.score_from_counts(*counts, metric, average) == \
            pytest.approx(jmetrics.score_from_counts(*counts, metric,
                                                     average), abs=1e-12)


def test_eval_bridged_graph_matches_jax():
    data = _data("sync")
    assert eval_bridged_graph(data) == j_eval_bridged_graph(data)


# -------------------------------------------------------------- the trainer


def _train_cfg(**kw):
    return Stage2Config(**{**dict(num_epoch=4, hidden=8, log_every=0), **kw})


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Two epochs, a checkpoint, then a resumed run to epoch four give the
    history, best dict and weights of one uninterrupted run (dropout 0.5
    from the saved generator state, StepLR state included)."""
    data = _data("sync")
    kw = dict(ckpt_every=2, step_size=3, gamma=0.5)
    full = train_ktgnn(data, _train_cfg(ckpt_dir=str(tmp_path / "a"), **kw),
                       device="cpu")
    train_ktgnn(data, _train_cfg(num_epoch=2, ckpt_dir=str(tmp_path / "b"),
                                 **kw), device="cpu")
    resumed = train_ktgnn(data, _train_cfg(ckpt_dir=str(tmp_path / "b"),
                                           resume=True, **kw), device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [3, 4]
    assert resumed["history"] == full["history"][2:]
    assert resumed["best"] == full["best"]
    for k, t in full["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], t), k
    assert TrainCheckpointer(str(tmp_path / "b")).steps() == [2, 4]


def test_checkpointer_keeps_newest_three(tmp_path):
    ck = TrainCheckpointer(str(tmp_path))
    assert ck.restore() is None
    for step in range(1, 6):
        ck.save(step, dict(epoch=step, w=torch.full((2,), float(step))))
    assert ck.steps() == [3, 4, 5]
    assert ck.restore()["epoch"] == 5
    assert torch.equal(ck.restore(step=4)["w"], torch.full((2,), 4.0))


def test_train_ktgnn_result_and_dropout(rng):
    """The result's keys and history, finite falling losses at dropout 0.5,
    and the same run twice from one seed gives the same history."""
    data = _data("skew")
    cfg = _train_cfg(num_epoch=6, adjacency_method="tiered", lr=1e-2)
    res = train_ktgnn(data, cfg, device="cpu")
    assert set(res) >= {"best", "history", "total_time", "mean_epoch_time",
                        "num_edges", "state_dict"}
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert set(res["best"]["per_head"]) == {"source", "target", "target_hat"}
    assert res["best"]["loss"] == min(h["loss_t2"] for h in res["history"])
    assert train_ktgnn(data, cfg, device="cpu")["history"] == res["history"]


def test_dropout_draws_from_the_generator():
    model = KTGNN(3, 4, hidden=8, dropout=0.5,
                  generator=torch.Generator().manual_seed(0)).train()
    x = torch.ones(64, 8)
    a = model._dropout(x, torch.Generator().manual_seed(1))
    b = model._dropout(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="Generator"):
        model._dropout(x, None)
    assert torch.equal(model.eval()._dropout(x, None), x)


@pytest.mark.parametrize("overrides", [
    dict(model_name="ConvNet"), dict(adjacency_method="gather"),
    dict(memory_policy="xla_plain"), dict(n_shards=4),
    dict(need_complement=True),
    dict(model_name="GCN", need_complement=True),
    dict(adjacency_method="dense"),
], ids=lambda o: "-".join(f"{k}-{v}" for k, v in o.items()))
def test_unported_options_raise(overrides):
    cfg = _train_cfg(**overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_ktgnn(_data("sync"), cfg, device="cpu")


def test_entry_points_default_to_cuda(rng):
    """Without a card the trainer and its CLI raise rather than run on
    the CPU; device='cpu' asks for the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        train_ktgnn(_data("sync"), _train_cfg())
    args = tcli2.build_argparser().parse_args(["--path_data", "g.npz"])
    assert args.device == "cuda"


# --------------------------------------------------- the CLI and the pickle


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The training CLI on a small .npz with --device cpu and --save."""
    tmp = tmp_path_factory.mktemp("cli")
    data = _data("sync")
    npz = str(tmp / "g.npz")
    save_graph_npz(npz, data)
    argv = ["--path_data", npz, "--num_epoch", "5", "--hidden_dim",
            str(HIDDEN), "--to_undirected", "--log_every", "1", "--save",
            "--ckpt_dir", str(tmp / "ck"), "--dataset_name", "sync",
            "--device", "cpu"]
    return data, npz, tmp / "ck" / "model_KTGNN_sync_best.pkl", argv


def test_cli_trains_on_npz(cli_run, capsys):
    _, _, ckpt, argv = cli_run
    res = tcli2.main(tcli2.build_argparser().parse_args(argv))
    out = capsys.readouterr().out
    for line in ("local homophily of test nodes:", "Epoch 005 loss",
                 "[stage-2 best]", "[per-head test]", "mean s/epoch:"):
        assert line in out
    assert len(res["history"]) == 5 and ckpt.is_file()


def test_cli_refuses_what_is_not_ported(cli_run, tmp_path):
    _, npz, _, argv = cli_run
    ap = tcli2.build_argparser()
    for extra in (["--n_shards", "2"], ["--halo_overlap"],
                  ["--shard_layout", "edgeshard"],
                  ["--memory_policy", "xla_plain"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tcli2.main(ap.parse_args(argv[:-2] + ["--device", "cpu"]
                                     + extra))


def test_port_checkpoint_serves_in_both_clis(cli_run):
    """The --save pickle of a port-trained model has the JAX layout, round
    trips through the state dict exactly, and both serving CLIs load it
    and answer alike."""
    data, npz, ckpt, argv = cli_run
    if not ckpt.is_file():
        tcli2.main(tcli2.build_argparser().parse_args(argv))
    with open(ckpt, "rb") as f:
        variables = pickle.load(f)
    jmodel, init = _jax_variables(data)
    assert jax.tree.structure(variables) == jax.tree.structure(
        jax.tree.map(np.asarray, init))
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 variables, jax.tree.map(np.asarray, init))
    model = _port_model(variables)
    sd = state_dict_from_flax(model, variables)
    back = flax_variables_from_state_dict(model, sd)
    jax.tree.map(np.testing.assert_array_equal, back, variables)
    serve_argv = ["--mode", "predictor", "--ckpt", str(ckpt), "--path_data",
                  npz, "--hidden_dim", str(HIDDEN), "--to_undirected"]
    japp = jcli._load_predictor(jcli.build_argparser().parse_args(serve_argv))
    tapp = tcli._load_predictor(tcli.build_argparser().parse_args(
        serve_argv + ["--device", "cpu"]))
    n, d = data["x"].shape
    _compare_app_answers(japp, tapp, n, d)
