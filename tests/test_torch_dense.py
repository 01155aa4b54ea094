"""PyTorch port, the dense and gather adjacency paths: the adjacency, the
``spmm`` forward and its vjp (to the features and to the edge weights,
through the dense matrix's scatter), KT-GNN's per-edge attention conv
(``AdaptedConv``) and the whole model, zoo models on both paths, the
``"auto"`` rule, and a 2-epoch ``train_ktgnn`` under ``"auto"`` on the
synthetic stage-1 graph, each against the JAX package on the same inputs
(its CPU path: the dense matrix built by a scatter, Precision.HIGHEST).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.data.synthetic import make_sync_dataset
from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.nn.ktgnn import KTGNN as JKTGNN
from bridged_gnn_tpu.nn.ktgnn import AdaptedConv as JAdaptedConv
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.ops.spmm import build_adjacency as j_build_adjacency
from bridged_gnn_tpu.ops.spmm import spmm as j_spmm
from bridged_gnn_tpu.train import stage2 as js2

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn.ktgnn import AdaptedConv
from bridged_gnn_tpu_torch.ops import spmm as tspmm
from bridged_gnn_tpu_torch.ops.spmm import (
    DENSE_MAX_NODES,
    adjacency_from_graph,
    build_adjacency,
    resolve_adjacency_method,
    spmm,
)
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

from tests.test_torch_cuda import random_edges
from tests.test_torch_graph import sync_data
from tests.test_torch_ktgnn import CLASSES, DIM, HIDDEN, _jax_variables

SPMM_TOL = dict(rtol=1e-5, atol=1e-5)    # f32 sums in another order
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_torch_train.py
LOGPROB_ATOL = 1e-4                      # tests/test_torch_ktgnn.py
# bf16 message tables, rounded per edge on both sides in another order:
# each output within this share of the output's largest magnitude
BF16_SCALED = 4e-2
METHODS = ["dense", "gather"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _adjacencies(rng, method):
    """Both packages' adjacencies of ``random_edges`` (masked edges
    inside the runs, repeated pairs, a padded tail)."""
    s, r, em = random_edges(rng)
    tadj = build_adjacency(s, r, em, 50, 64, method=method, device="cpu")
    jadj = j_build_adjacency(jnp.asarray(s), jnp.asarray(r),
                                 jnp.asarray(em), 50, 64, method=method)
    return tadj, jadj, s.shape[0]


@pytest.mark.parametrize("method", METHODS)
def test_adjacency_matches_jax(rng, method):
    """The dense matrix (multiplicities of real edges) and the in-degrees
    equal the JAX package's; the gather adjacency carries neither a
    matrix nor a layout."""
    tadj, jadj, _ = _adjacencies(rng, method)
    np.testing.assert_array_equal(tadj.in_degree.numpy(),
                                  np.asarray(jadj.in_degree))
    assert tadj.fast_fn is None and tadj.tiered_fn is None
    if method == "dense":
        np.testing.assert_array_equal(tadj.dense.numpy(),
                                      np.asarray(jadj.dense))
        assert tadj.dense.max() > 1    # a repeated pair counts twice
    else:
        assert tadj.dense is None and jadj.dense is None


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("method", METHODS)
def test_spmm_matches_jax(rng, method, weighted, reduce, d):
    """Forward and the vjp to x (and to the edge weights: on the dense
    path the gradient of the scattered matrix gathered at the edges) of
    the port's spmm against the JAX package's, f32 at rtol/atol 1e-5."""
    tadj, jadj, e = _adjacencies(rng, method)
    x = rng.normal(size=(64, d)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32) if weighted else None
    dy = rng.normal(size=(64, d)).astype(np.float32)
    if weighted:
        want, vjp = jax.vjp(
            lambda x_, w_: j_spmm(jadj, x_, reduce, w_),
            jnp.asarray(x), jnp.asarray(w))
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


def test_dense_matrix_gradient_matches_jax(rng):
    """The scatter into the [N, N] matrix carries the weights' gradient:
    a random cotangent on the whole matrix, gathered at (r, s) for every
    edge (masked edges included: the caller zeroes their weights), as
    JAX's ``.at[r, s].add`` transposes; rtol/atol 1e-6."""
    tadj, jadj, e = _adjacencies(rng, "dense")
    w = rng.normal(size=e).astype(np.float32)
    ct = rng.normal(size=(64, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda w_: jnp.zeros((64, 64)).at[
        jadj.receivers, jadj.senders].add(w_), jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    (got,) = torch.autograd.grad(tspmm.dense_matrix(tadj, wt), wt,
                                 torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(
        jnp.asarray(ct))[0]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("threshold", [None, 0, 8192],
                         ids=["measured", "zero", "jax"])
def test_auto_rule(monkeypatch, threshold):
    """"auto" is dense up to DENSE_MAX_NODES padded nodes and blocked
    above (the measured constant, and the rule at two other thresholds);
    every other method is kept, and an unknown one raises."""
    if threshold is not None:
        monkeypatch.setattr(tspmm, "DENSE_MAX_NODES", threshold)
    limit = tspmm.DENSE_MAX_NODES
    for n_pad in (8, 3504, 8192, 8200, 131072):
        assert resolve_adjacency_method("auto", n_pad) == (
            "dense" if n_pad <= limit else "blocked")
        for m in ("blocked", "tiered", "dense", "gather"):
            assert resolve_adjacency_method(m, n_pad) == m
    with pytest.raises(ValueError, match="adjacency method"):
        resolve_adjacency_method("sparse", 8)


@pytest.mark.parametrize("threshold", [0, 8192])
def test_auto_in_the_trainer_and_predictor(monkeypatch, threshold):
    """The trainer and the predictor resolve "auto" by the same rule: a
    dense matrix when the sync graph's padded size is within the
    threshold, the slot layout otherwise."""
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    monkeypatch.setattr(tspmm, "DENSE_MAX_NODES", threshold)
    data = sync_data(dim=DIM, num_classes=CLASSES)
    _, adj = ts2.prepare_stage2_graph(data, Stage2Config(), "cpu")
    model = ts2.build_model(Stage2Config(hidden=HIDDEN), CLASSES, DIM, "cpu")
    pred = KTGNNPredictor(model, None, dict(data), device="cpu")
    for a in (adj, pred.adj):
        assert (a.dense is not None) == bool(threshold)
        assert (a.fast_fn is not None) == (not threshold)


# ------------------------------------------------------------ AdaptedConv


def _conv_case(rng, method, msg_dtype):
    """An AdaptedConv (12 → 16) initialised by flax, carried to the port,
    and both packages' graphs and adjacencies of the sync graph."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    gt = with_self_loops(graph_from_dict(dict(data)))
    aj = j_adj(gj, method=method)
    at = adjacency_from_graph(gt, method=method, device="cpu")
    jconv = JAdaptedConv(HIDDEN, msg_dtype=msg_dtype)
    variables = jax.tree.map(np.asarray, jconv.init(
        jax.random.PRNGKey(3), gj.x, aj, gj.central_mask, gj.node_mask))
    conv = AdaptedConv(DIM, HIDDEN, msg_dtype=msg_dtype)
    conv.load_state_dict(state_dict_from_flax(conv, variables))
    x = rng.normal(size=gt.x.shape).astype(np.float32)
    return jconv, variables, conv, gj, aj, gt, at, x


@pytest.mark.parametrize("msg_dtype", [None, "bfloat16"],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("method", METHODS)
def test_adapted_conv_matches_jax(rng, method, msg_dtype):
    """Forward and the gradients to x and every parameter of the per-edge
    GATv2 conv against JAX's on the same adjacency: f32 at the forward's
    1e-5 and the gradients' rtol 2e-4 / atol 2e-5; with bf16 message
    tables each output within 4e-2 of its largest magnitude (a few bf16
    ulps: the gradients sum products rounded to bf16 per edge)."""
    jconv, variables, conv, gj, aj, gt, at, x = _conv_case(
        rng, method, msg_dtype)
    dy = rng.normal(size=(gt.num_nodes_padded, HIDDEN)).astype(np.float32)

    def f(params, x_):
        return jconv.apply({"params": params}, x_, aj, gj.central_mask,
                           gj.node_mask)

    want, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gparams_j, gx_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = conv(xt, at, gt.central_mask, gt.node_mask)
    params = dict(conv.named_parameters())
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                torch.from_numpy(dy))
    want_g = state_dict_from_flax(conv, {"params": gparams_j})
    def close(a, b, tol, name=""):
        b = np.asarray(b)
        if msg_dtype is not None:
            tol = dict(rtol=0, atol=BF16_SCALED * np.abs(b).max())
        np.testing.assert_allclose(a, b, err_msg=name, **tol)

    close(got.detach().numpy(), want, SPMM_TOL)
    close(grads[0].numpy(), gx_j, GRAD_TOL)
    for (name, _), g in zip(params.items(), grads[1:]):
        close(g.numpy(), want_g[name].numpy(), GRAD_TOL, name)


@pytest.mark.parametrize("method", METHODS)
def test_ktgnn_matches_jax(method):
    """KT-GNN's three heads on a dense and on a gather adjacency, weights
    carried from flax, against the JAX model; atol 1e-4."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    jmodel, variables = _jax_variables(data)
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    want = jmodel.apply(variables, gj, j_adj(
        gj, method=method), False)
    gt = with_self_loops(graph_from_dict(dict(data)))
    model = ts2.build_model(Stage2Config(hidden=HIDDEN), CLASSES, DIM, "cpu")
    model.load_state_dict(state_dict_from_flax(
        model, jax.tree.map(np.asarray, variables)))
    with torch.inference_mode():
        got = model.eval()(gt, adjacency_from_graph(gt, method=method,
                                                    device="cpu"))
    assert got[3] is None and want[3] is None
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                   atol=LOGPROB_ATOL)


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN", "GIN", "APPNP"])
@pytest.mark.parametrize("method", METHODS)
def test_zoo_matches_jax(method, name):
    """A zoo model's eval log-probabilities on a dense and on a gather
    adjacency against the JAX model's, weights carried across; atol
    1e-4. GCN's and APPNP's normalized weights and GraphSAGE's mean read
    the in-degrees, which both paths carry."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    kw = dict(model_name=name, hidden=HIDDEN, adjacency_method=method)
    gt, at = ts2.prepare_stage2_graph(data, Stage2Config(**kw), "cpu")
    gj, aj = js2.prepare_stage2_graph(
        dict(data, train_mask=gt.train_mask[: gt.num_nodes].numpy()),
        js2.Stage2Config(**kw))
    jmodel = js2.build_model(js2.Stage2Config(**kw), CLASSES)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), gj, aj, False))
    want = jmodel.apply(variables, gj, aj, False)
    model = ts2.build_model(Stage2Config(**kw), CLASSES, DIM, "cpu")
    model.load_state_dict(state_dict_from_flax(model, variables))
    with torch.inference_mode():
        got = model.eval()(gt, at)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGPROB_ATOL)


# ----------------------------------------------------------- the trainer


def test_train_ktgnn_auto_matches_jax(monkeypatch):
    """2 epochs of ``train_ktgnn`` on ``make_sync_dataset`` at its
    defaults (3,500 nodes, the synthetic stage-1 graph) under "auto" on
    both sides (JAX's is dense here, the port's follows DENSE_MAX_NODES),
    from the port's seeded init carried to flax, at dropout 0: every loss
    at rtol 1e-4, the scores to 1e-12 (the same confusion counts;
    tests/test_torch_scan.py) and the final weights at rtol 1e-3, atol
    1e-5."""
    data = make_sync_dataset()
    r = np.random.default_rng(0).random(data["x"].shape[0])
    data.update(train_mask=r < 0.6, val_mask=(r >= 0.6) & (r < 0.8),
                test_mask=r >= 0.8)
    kw = dict(num_epoch=2, hidden=HIDDEN, lr=1e-2, dropout=0.0,
              log_every=0, save_best_path=None)
    cfg = Stage2Config(**kw)
    g, adj = ts2.prepare_stage2_graph(data, cfg, "cpu")
    assert (adj.dense is not None) == (
        g.num_nodes_padded <= DENSE_MAX_NODES)
    assert js2.prepare_stage2_graph(data, js2.Stage2Config(**kw))[1].use_dense
    port = train_ktgnn(data, cfg, device="cpu")
    init = ts2.build_model(cfg, g.num_classes, g.num_features, "cpu")
    variables = flax_variables_from_state_dict(init, init.state_dict())
    monkeypatch.setattr(JKTGNN, "init", lambda self, *a, **k: variables)
    final = {}
    real_jit = jax.jit

    def spy_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)
        if getattr(fn, "__name__", "") != "train_step":
            return jitted

        def step(params, *rest):
            out = jitted(params, *rest)
            final.update(params=out[0], batch_stats=out[1])
            return out
        return step

    monkeypatch.setattr(jax, "jit", spy_jit)
    jres = js2.train_ktgnn(data, js2.Stage2Config(**kw))
    for hp, hj in zip(port["history"], jres["history"]):
        for key in ("loss", "loss_t2"):
            assert hp[key] == pytest.approx(hj[key], rel=1e-4), hp["epoch"]
        for key in ("train", "val", "test"):
            assert hp[key] == pytest.approx(hj[key], abs=1e-12), hp["epoch"]
    want = state_dict_from_flax(init, jax.tree.map(np.asarray, final))
    for k, t in port["state_dict"].items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
