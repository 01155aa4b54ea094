"""PyTorch port, the stage-2 model zoo and ``.dat`` loading: the padded
SpMM against the JAX package's ``spmm`` (forward and ``jax.vjp``) on
single and tiered layouts and its plain version against the Pallas
``gather_reduce_pallas`` in interpret mode; every CLI model, KTGNN_noDTC
and KT-GNN with ``root_weight`` against the JAX model with weights carried
across (eval log-probabilities and one step's gradients); Adam steps of
the ``--no_dtc`` recipe against a JAX loop; state-dict round trips; the
reference's ``.dat`` pickle read by both packages; the CLI's ``--no_dtc``.
"""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.io.pyg_compat import (
    load_pyg_data_dict as j_load_pyg_data_dict,
)
from bridged_gnn_tpu.ops import blocked_segment as jbs
from bridged_gnn_tpu.ops import pallas_padded as jpp
from bridged_gnn_tpu.ops.spmm import build_adjacency as j_build_adjacency
from bridged_gnn_tpu.ops.spmm import spmm as j_spmm
from bridged_gnn_tpu.train import stage2 as js2
from bridged_gnn_tpu.train.optim import torch_adam

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.io.pyg_compat import load_pyg_data_dict
from bridged_gnn_tpu_torch.nn.backbones import MODEL_NAMES
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.spmm import build_adjacency, spmm
from bridged_gnn_tpu_torch.train.optim import make_optimizer
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    prepare_stage2_graph,
    stage2_loss,
    train_step,
)

from tests.test_torch_cuda import random_edges, skewed_data
from tests.test_torch_graph import sync_data

HIDDEN, CLASSES, DIM = 16, 3, 12
LOGPROB_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_torch_train.py
SPMM_TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums in another order
# (model, num_layer, config extras): the ten CLI models, KTGNN_noDTC and
# KT-GNN with the root weight
MODELS = [(m, 2, {}) for m in MODEL_NAMES] + [
    ("KTGNN_noDTC", 3, {}), ("KTGNN_noDTC", 3, dict(root_weight=True)),
    ("KTGNN", 2, dict(root_weight=True))]
MODEL_IDS = [m + ("_root" if kw else "") for m, _, kw in MODELS]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ------------------------------------------------------------------- spmm


def _adjacencies(rng, method):
    s, r, em = random_edges(rng)
    if method == "tiered":   # a hot destination, so the tiers differ
        r = np.where(rng.random(r.shape[0]) < 0.4, 3, r).astype(np.int32)
        order = np.argsort(r, kind="stable")
        s, r, em = s[order], r[order], em[order]
    tadj = build_adjacency(s, r, em, 50, 64, method=method, node_block=16,
                           device="cpu")
    jadj = j_build_adjacency(jnp.asarray(s), jnp.asarray(r),
                             jnp.asarray(em), 50, 64, method=method,
                             node_block=16)
    assert (tadj.tiered_fn is not None) == (method == "tiered")
    return tadj, jadj, s.shape[0]


@pytest.mark.parametrize("d", [8, 64, 257])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_spmm_matches_jax(rng, method, weighted, reduce, d):
    """Forward and the vjp to x (and to the edge weights) of the port's
    spmm against the JAX package's on the same adjacency."""
    tadj, jadj, e = _adjacencies(rng, method)
    x = rng.normal(size=(64, d)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32) if weighted else None
    dy = rng.normal(size=(64, d)).astype(np.float32)

    if weighted:
        want, vjp = jax.vjp(
            lambda x_, w_: j_spmm(jadj, x_, reduce, w_), jnp.asarray(x),
            jnp.asarray(w))
    else:
        want, vjp = jax.vjp(lambda x_: j_spmm(jadj, x_, reduce),
                            jnp.asarray(x))
    grads_j = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_() if weighted else None
    got = spmm(tadj, xt, reduce, wt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **SPMM_TOL)
    inputs = (xt, wt) if weighted else (xt,)
    grads = torch.autograd.grad(got, inputs, torch.from_numpy(dy))
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **SPMM_TOL)


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_gather_reduce_plain_matches_pallas_interpret(rng, weighted, d):
    """The plain version against ``gather_reduce_pallas`` in interpret
    mode on the same slot layout, and its transpose against the dense
    transposed product."""
    n_pad, e = 256, 2048
    s = rng.integers(0, n_pad, size=e).astype(np.int32)
    r = np.sort(rng.integers(0, n_pad, size=e)).astype(np.int32)
    em = rng.random(e) < 0.85
    jlay = jbs.build_padded_layout(r, s, np.arange(e), em, n_pad,
                                   node_block=64)
    lay = tbs.make_blocked_ops(s, r, em, n_pad, node_block=64).lay_dst
    np.testing.assert_array_equal(lay.slot_edge.numpy()[
        np.asarray(jlay.slot_mask).reshape(-1)],
        np.asarray(jlay.slot_edge).reshape(-1)[
            np.asarray(jlay.slot_mask).reshape(-1)])
    x = rng.normal(size=(n_pad, d)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32)
    w_slot_j = (jnp.asarray(w)[jlay.slot_edge]
                * jlay.slot_mask.astype(jnp.float32)) if weighted else None
    w_slot = torch.from_numpy(w)[lay.slot_edge] if weighted else None
    want = jpp.gather_reduce_pallas(jlay, jnp.asarray(x), w_slot_j,
                                    interpret=True)
    got = fk.gather_reduce_plain(lay, torch.from_numpy(x), n_pad, w_slot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # the transpose: dx = Aᵀ dy with A[v, u] = Σ w over real edges (u, v)
    a = np.zeros((n_pad, n_pad), np.float64)
    np.add.at(a, (r[em], s[em]), w[em] if weighted else 1.0)
    dy = rng.normal(size=(n_pad, d)).astype(np.float32)
    got_t = fk.gather_reduce_plain(lay, torch.from_numpy(dy), n_pad, w_slot,
                                   transpose=True)
    np.testing.assert_allclose(got_t.numpy(), a.T @ dy, rtol=1e-4,
                               atol=1e-4)


def test_gather_reduce_cpu_routes_to_plain_and_counts_nothing(rng):
    lay = tbs.make_blocked_ops(*random_edges(rng), 64, node_block=16).lay_dst
    x = torch.randn(64, 8)
    w = torch.randn(lay.slot_src.shape[0])
    fk.reset_launch_counts()
    for args in ((lay, x, 64), (lay, x, 64, w), (lay, x, 64, w, True)):
        assert torch.equal(fk.gather_reduce(*args),
                           fk.gather_reduce_plain(*args))
    assert fk.gather_reduce.launches == 0
    with pytest.raises(RuntimeError, match="requires grad"):
        fk.gather_reduce(lay, x.requires_grad_(), 64)


# ------------------------------------------------------------------ models


def _cfgs(name, num_layer, extra):
    kw = dict(dict(model_name=name, num_layer=num_layer, hidden=HIDDEN,
                   adjacency_method="blocked"), **extra)
    jcfg = js2.Stage2Config(**kw)
    return jcfg, Stage2Config(**kw)


def _zero_dropout(jmodel, model):
    """Both models with every dropout at 0 (GAT, GCN2 and DeeperGCN fix
    theirs in the zoo, not from the config)."""
    fields = {f: 0.0 for f in ("dropout", "att_dropout")
              if hasattr(jmodel, f)}
    for m in model.modules():
        for f in ("dropout", "att_dropout"):
            if isinstance(getattr(m, f, None), float):
                setattr(m, f, 0.0)
    return jmodel.clone(**fields)


def _to_port(model, variables):
    return state_dict_from_flax(model, jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def zoo_data():
    data = sync_data(dim=DIM, num_classes=CLASSES)
    return dict(data, test_mask=~data["train_mask"])


def _pair(data, name, num_layer, extra, seed=0):
    """The JAX model, its variables (random BN statistics where it has
    batch norm), the JAX graph and adjacency; the port model with the same
    weights, its graph and adjacency."""
    jcfg, cfg = _cfgs(name, num_layer, extra)
    gj, aj = js2.prepare_stage2_graph(data, jcfg)
    jmodel = js2.build_model(jcfg, CLASSES)
    variables = jmodel.init(jax.random.PRNGKey(seed), gj, aj, False)
    variables = jax.tree.map(np.asarray, dict(variables))
    r = np.random.default_rng(seed)
    variables["batch_stats"] = jax.tree.map(
        lambda a: r.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables.get("batch_stats", {}))
    gt, at = prepare_stage2_graph(data, cfg, device="cpu")
    assert (gt.num_edges, gt.num_nodes_padded) == (gj.num_edges,
                                                   gj.num_nodes_padded)
    model = build_model(cfg, CLASSES, DIM, device="cpu")
    multi = isinstance(model, KTGNN)
    model.load_state_dict(_to_port(model, variables), strict=True)
    return jmodel, variables, gj, aj, model, gt, at, multi


@pytest.mark.parametrize("name,num_layer,extra", MODELS, ids=MODEL_IDS)
def test_zoo_eval_log_probs_match_jax(zoo_data, name, num_layer, extra):
    jmodel, variables, gj, aj, model, gt, at, multi = _pair(
        zoo_data, name, num_layer, extra)
    outs = jmodel.apply(variables, gj, aj, False)
    want = outs[:3] if multi else (outs[0] if isinstance(outs, tuple)
                                   else outs,)
    with torch.no_grad():
        got = model.eval()(gt, at)
    got = got if multi else (got,)
    n = gt.num_nodes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:n], np.asarray(w)[:n],
                                   **LOGPROB_TOL)


def _jax_loss(jmodel, gj, aj, multi):
    def loss_fn(params, batch_stats):
        outs, mut = jmodel.apply({"params": params,
                                  "batch_stats": batch_stats}, gj, aj, True,
                                 mutable=["batch_stats"])
        if multi:
            lp_s, lp_t, lp_that = outs[:3]
            tar = gj.train_mask & ~gj.central_mask
            loss = ((2.0 * js2.masked_nll(lp_s, gj.y, gj.train_mask)
                     + js2.masked_nll(lp_t, gj.y, tar)
                     + js2.masked_nll(lp_that, gj.y, tar)) / 4.0
                    + js2.kl_batchmean(lp_that, lp_t, gj.node_mask))
        else:
            lp = outs[0] if isinstance(outs, tuple) else outs
            loss = js2.masked_nll(lp, gj.y, gj.train_mask)
        return loss, mut.get("batch_stats", {})

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.mark.parametrize("name,num_layer,extra", MODELS, ids=MODEL_IDS)
def test_zoo_step_gradients_match_jax(zoo_data, name, num_layer, extra):
    """One train-mode step at dropout 0: the loss, every parameter's
    gradient and the batch statistics against ``jax.grad``."""
    jmodel, variables, gj, aj, model, gt, at, multi = _pair(
        zoo_data, name, num_layer, extra, seed=1)
    jmodel = _zero_dropout(jmodel, model)
    (loss_j, bs_j), grads_j = _jax_loss(jmodel, gj, aj, multi)(
        variables["params"], variables["batch_stats"])
    want = _to_port(model, {"params": grads_j, "batch_stats": bs_j})
    loss, _ = stage2_loss(model, gt, at, 1.0, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   err_msg=pname, **GRAD_TOL)
    for bname, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[bname].numpy(),
                                   err_msg=bname, **GRAD_TOL)


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN", "APPNP"])
def test_zoo_tiered_eval_matches_jax(name):
    """On a skewed graph the port's kernel runs per tier where the JAX
    zoo falls back to a gather and segment_sum: the same log-probs."""
    data = skewed_data(np.random.default_rng(5), n=160, c=CLASSES, d=DIM)
    data["test_mask"] = ~data["train_mask"]
    jcfg, cfg = _cfgs(name, 2, dict(adjacency_method="tiered"))
    gj, aj = js2.prepare_stage2_graph(data, jcfg)
    gt, at = prepare_stage2_graph(data, cfg, device="cpu")
    assert at.tiered_fn is not None and len(at.tiered_fn.tiers) >= 2
    jmodel = js2.build_model(jcfg, CLASSES)
    variables = jax.tree.map(np.asarray, dict(
        jmodel.init(jax.random.PRNGKey(3), gj, aj, False)))
    model = build_model(cfg, CLASSES, DIM, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    want = jmodel.apply(variables, gj, aj, False)
    with torch.no_grad():
        got = model.eval()(gt, at)
    n = gt.num_nodes
    np.testing.assert_allclose(got.numpy()[:n], np.asarray(want)[:n],
                               **LOGPROB_TOL)


@pytest.mark.parametrize("name,num_layer,extra", MODELS, ids=MODEL_IDS)
def test_state_dict_round_trips_through_flax(zoo_data, name, num_layer,
                                             extra):
    """flax variables → port state dict → flax variables is exact, the
    port's own state dict survives the trip back, and a flax leaf that
    matches no entry of the model is refused by name."""
    jmodel, variables, _, _, model, _, _, _ = _pair(
        zoo_data, name, num_layer, extra)
    sd = model.state_dict()
    back = flax_variables_from_state_dict(model, sd)
    want = {k: variables.get(k, {}) for k in ("params", "batch_stats")}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)
    again = _to_port(model, back)
    for k, t in sd.items():
        assert torch.equal(again[k], t), k
    stray = dict(back, params=dict(back["params"],
                                   stray={"kernel": np.zeros(1)}))
    with pytest.raises(ValueError, match="params/stray/kernel"):
        state_dict_from_flax(model, stray)


def test_message_dtype_refused_for_zoo_models():
    with pytest.raises(ValueError, match="KTGNN-family"):
        build_model(Stage2Config(model_name="GCN", message_dtype="bfloat16"),
                    CLASSES, DIM, device="cpu")


def test_no_dtc_with_ktgnn_builds_ktgnn_no_dtc():
    from bridged_gnn_tpu_torch.nn.ktgnn import KTGNNNoDTC

    model = build_model(Stage2Config(no_dtc=True), CLASSES, DIM,
                        device="cpu")
    assert isinstance(model, KTGNNNoDTC)


def test_self_loops_only_for_the_models_that_see_them(zoo_data):
    n = zoo_data["x"].shape[0]
    sage, _ = prepare_stage2_graph(zoo_data, Stage2Config(
        model_name="GraphSAGE"), device="cpu")
    gcn, _ = prepare_stage2_graph(zoo_data, Stage2Config(model_name="GCN"),
                                  device="cpu")
    loops = [int((ei[0] == ei[1]).sum())
             for ei in (sage.edge_index_np(), gcn.edge_index_np())]
    assert loops[1] == n and loops[0] < n
    assert gcn.num_edges == sage.num_edges + n - loops[0]


def test_adam_steps_no_dtc_recipe_match_jax_loop(zoo_data):
    """Five Adam steps (L2 weight decay, constant rate) of GraphSAGE at
    dropout 0: the losses at rtol 1e-4 and the weights after the last step
    at rtol 1e-3, atol 1e-5."""
    lr, wd = 1e-2, 5e-3
    jmodel, variables, gj, aj, model, gt, at, _ = _pair(
        zoo_data, "GraphSAGE", 2, {})
    jmodel = _zero_dropout(jmodel, model)
    tx = torch_adam(lr, weight_decay=wd)
    step_j = _jax_loss(jmodel, gj, aj, False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    losses_j = []
    for _ in range(5):
        (loss, _), grads = step_j(params, {})
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        losses_j.append(float(loss))
    want = state_dict_from_flax(model, jax.tree.map(
        np.asarray, {"params": params}))
    opt, sched = make_optimizer(model.parameters(), lr, wd, False, 100, 0.1)
    assert sched is None
    losses = [float(train_step(model, gt, at, opt, 1.0, None)[0])
              for _ in range(5)]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    for k, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------- the .dat


def write_dat(path, data, layout="store"):
    """A PyG ``Data`` pickle as the reference's torch.save writes it,
    without PyG: stand-in classes under PyG's module paths while saving
    (``layout="store"``: PyG >= 2.0, the tensors in ``_store``; "flat":
    PyG < 2.0, on the object)."""
    mod_d = types.ModuleType("torch_geometric.data.data")
    mod_s = types.ModuleType("torch_geometric.data.storage")
    data_cls = type("Data", (), {"__module__": mod_d.__name__})
    store_cls = type("GlobalStorage", (), {"__module__": mod_s.__name__})
    mod_d.Data, mod_s.GlobalStorage = data_cls, store_cls
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    obj = data_cls()
    if layout == "store":
        store = store_cls()
        store._mapping = tensors
        obj._store = store
    else:
        obj.__dict__.update(tensors)
    names = ("torch_geometric", "torch_geometric.data",
             "torch_geometric.data.data", "torch_geometric.data.storage")
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update({"torch_geometric": types.ModuleType("tg"),
                        "torch_geometric.data": types.ModuleType("tgd"),
                        mod_d.__name__: mod_d, mod_s.__name__: mod_s})
    try:
        torch.save(obj, path)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


@pytest.mark.parametrize("layout", ["store", "flat"])
def test_dat_reads_like_jax(tmp_path, zoo_data, layout):
    path = str(tmp_path / "g.dat")
    write_dat(path, zoo_data, layout)
    got = load_pyg_data_dict(path)
    want = j_load_pyg_data_dict(path)
    assert set(got) == set(want) == set(zoo_data)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], zoo_data[k], err_msg=k)


def test_cli_no_dtc_trains_graphsage_from_dat(tmp_path, zoo_data,
                                              monkeypatch, capsys):
    """``--no_dtc`` on a .dat trains GraphSAGE with a constant rate, as
    the JAX CLI builds it, and saves model_GraphSAGE_<dataset>_best.pkl in
    the JAX layout."""
    path = str(tmp_path / "g.dat")
    write_dat(path, zoo_data)
    seen = []
    real = tcli.train_ktgnn

    def recording(data, cfg, device):
        seen.append(cfg)
        return real(data, cfg, device=device)

    monkeypatch.setattr(tcli, "train_ktgnn", recording)
    argv = ["--path_data", path, "--no_dtc", "--num_epoch", "3",
            "--hidden_dim", str(HIDDEN), "--to_undirected", "--save",
            "--ckpt_dir", str(tmp_path / "ck"), "--dataset_name", "sync",
            "--device", "cpu", "--log_every", "1"]
    res = tcli.main(tcli.build_argparser().parse_args(argv))
    (cfg,) = seen
    assert (cfg.model_name, cfg.use_scheduler, cfg.no_dtc) == (
        "GraphSAGE", False, False)
    out = capsys.readouterr().out
    assert "Epoch 003 loss" in out and "[stage-2 best]" in out
    assert len(res["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    with open(tmp_path / "ck" / "model_GraphSAGE_sync_best.pkl", "rb") as f:
        variables = pickle.load(f)
    jcfg = js2.Stage2Config(model_name="GraphSAGE", hidden=HIDDEN)
    gj, aj = js2.prepare_stage2_graph(zoo_data, jcfg)
    init = js2.build_model(jcfg, CLASSES).init(jax.random.PRNGKey(0), gj,
                                               aj, False)
    want = jax.tree.map(np.asarray, {"params": init["params"],
                                     "batch_stats": {}})
    assert jax.tree.structure(variables) == jax.tree.structure(want)
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 variables, want)
