"""PyTorch port, ``ConvNet``/``SplineConv``: the degree-1 B-spline basis
at ``dim`` 1 and 2, the conv's forward and gradients on the slot layout
(the padded SpMM's weighted calls), the dense and the gather adjacency,
the two-layer ``ConvNet`` in eval and train mode, its refusal without
pseudo-coordinates, the flax weights both ways, and Adam steps of the
trainer (``edge_attr`` as the pseudo-coordinates) against a JAX loop, each
against the JAX package on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.nn import backbones as jbb
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.train import stage2 as js2
from bridged_gnn_tpu.train.optim import torch_adam

from bridged_gnn_tpu_torch.graph import graph_from_dict
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn.backbones import (
    MODEL_NAMES,
    ConvNet,
    SplineConv,
    spline_basis,
)
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

from tests.test_torch_graph import sync_data

DIM, CLASSES = 12, 3
FWD_TOL = dict(rtol=1e-5, atol=1e-5)    # f32 sums in another order
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_torch_train.py
METHODS = ["blocked", "dense", "gather"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _graphs(data):
    return j_graph_from_dict(dict(data)), graph_from_dict(dict(data))


def _pseudo(rng, e_pad, dim=1):
    """Pseudo-coordinates, some outside [0, 1] (clipped) and some exactly
    on the knots."""
    p = rng.uniform(-0.2, 1.2, size=(e_pad, dim)).astype(np.float32)
    p[::17] = 0.5
    p[::23] = 1.0
    return p


@pytest.mark.parametrize("dim,kernel_size", [(1, 2), (1, 5), (2, (3, 2)),
                                             (2, 4)])
def test_spline_basis_matches_jax(rng, dim, kernel_size):
    """The dense [E_pad, K] hat-function basis, slots in the mixed-radix
    order, masked edges 0, each row summing to 1 on real edges; equal to
    JAX's at 1e-6."""
    e = 300
    pseudo = _pseudo(rng, e, dim)
    mask = rng.random(e) < 0.8
    want = np.asarray(jbb.spline_basis(jnp.asarray(pseudo), kernel_size,
                                       jnp.asarray(mask)))
    got = spline_basis(torch.from_numpy(pseudo), kernel_size,
                       torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(1), mask.astype(np.float32),
                               atol=1e-6)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("method", METHODS)
def test_spline_conv_matches_jax(rng, method):
    """SplineConv (12 → 16, K = 2): forward and the gradients to x, the
    pseudo-free weights and every parameter against JAX's on the same
    adjacency; forward at rtol/atol 1e-5, gradients at rtol 2e-4 / atol
    2e-5. On the slot layout each of the K aggregations is a weighted
    padded SpMM."""
    gj, gt = _graphs(sync_data(dim=DIM, num_classes=CLASSES))
    aj = j_adj(gj, method=method)
    at = adjacency_from_graph(gt, method=method, device="cpu")
    pseudo = _pseudo(rng, gt.num_edges_padded)
    jconv = jbb.SplineConv(16)
    variables = jax.tree.map(np.asarray, jconv.init(
        jax.random.PRNGKey(2), gj.x, aj, jnp.asarray(pseudo)))
    conv = SplineConv(DIM, 16)
    conv.load_state_dict(state_dict_from_flax(conv, variables))
    x = rng.normal(size=gt.x.shape).astype(np.float32)
    dy = rng.normal(size=(gt.num_nodes_padded, 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x_: jconv.apply(
        {"params": p}, x_, aj, jnp.asarray(pseudo)), variables["params"],
        jnp.asarray(x))
    gp_j, gx_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = conv(xt, at, torch.from_numpy(pseudo))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    params = dict(conv.named_parameters())
    grads = torch.autograd.grad(got, [xt] + list(params.values()),
                                torch.from_numpy(dy))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               **GRAD_TOL)
    want_g = state_dict_from_flax(conv, {"params": gp_j})
    for (name, _), g in zip(params.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def _convnet_pair(rng, method, dropout=0.5):
    data = sync_data(dim=DIM, num_classes=CLASSES)
    gj, gt = _graphs(data)
    aj = j_adj(gj, method=method)
    at = adjacency_from_graph(gt, method=method, device="cpu")
    pseudo = _pseudo(rng, gt.num_edges_padded)
    jm = jbb.ConvNet(CLASSES, dropout=dropout)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), gj, aj, pseudo=jnp.asarray(pseudo)))
    model = ConvNet(CLASSES, DIM, dropout=dropout)
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    return jm, variables, model, gj, aj, gt, at, pseudo


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("method", METHODS)
def test_convnet_matches_jax(rng, method, train):
    """ConvNet's log-probabilities (train mode at dropout 0) and the
    gradients of a cotangent through them to every parameter, weights
    carried from flax."""
    jm, variables, model, gj, aj, gt, at, pseudo = _convnet_pair(
        rng, method, dropout=0.0)
    ct = rng.normal(size=(gt.num_nodes_padded, CLASSES)).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jm.apply(
        {"params": p}, gj, aj, train, pseudo=jnp.asarray(pseudo)),
        variables["params"])
    (gp_j,) = vjp(jnp.asarray(ct))
    model.train(train)
    got = model(gt, at, None, pseudo=torch.from_numpy(pseudo))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(got, list(params.values()),
                                torch.from_numpy(ct))
    want_g = state_dict_from_flax(model, {"params": gp_j})
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_convnet_weights_round_trip(rng):
    """conv{1,2}/weight [K, f_in, out], conv{1,2}/root/kernel and
    conv{1,2}/bias carried to the port and back give the same tree."""
    _, variables, model, *_ = _convnet_pair(rng, "dense")
    assert set(variables["params"]["conv1"]) == {"weight", "root", "bias"}
    assert model.conv1.weight.shape == (2, DIM, 16)
    back = flax_variables_from_state_dict(model, model.state_dict())
    want = {"params": variables["params"], "batch_stats": {}}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)


def test_convnet_needs_pseudo():
    """Without pseudo-coordinates ConvNet raises JAX's ValueError, as a
    module and in both trainers (the data has no ``edge_attr``); it is in
    the zoo but not in the CLIs' choices."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    gj, gt = _graphs(data)
    with pytest.raises(ValueError, match="pseudo"):
        jbb.ConvNet(CLASSES).init(jax.random.PRNGKey(0), gj,
                                  j_adj(gj, method="gather"))
    with pytest.raises(ValueError, match="pseudo"):
        ConvNet(CLASSES, DIM)(gt, adjacency_from_graph(
            gt, method="gather", device="cpu"))
    cfg = dict(model_name="ConvNet", num_epoch=1, log_every=0)
    with pytest.raises(ValueError, match="pseudo"):
        js2.train_ktgnn(data, js2.Stage2Config(**cfg))
    with pytest.raises(ValueError, match="pseudo"):
        train_ktgnn(data, Stage2Config(**cfg), device="cpu")
    assert "ConvNet" not in MODEL_NAMES
    with pytest.raises(ValueError, match="to_undirected"):
        train_ktgnn(dict(data, edge_attr=np.zeros(
            data["edge_index"].shape[1], np.float32)),
            Stage2Config(to_undirected=True, **cfg), device="cpu")


def test_train_convnet_matches_jax_loop(rng):
    """The trainer on ConvNet with the data's ``edge_attr`` as pseudo-
    coordinates (put in the graph's edge order by ``model_inputs``): 3
    epochs at dropout 0, Adam with L2 decay and no scheduler, against a
    JAX loop of the same steps from the same weights: losses at rtol
    1e-4, final weights at rtol 1e-3, atol 1e-5."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    e = data["edge_index"].shape[1]
    data["edge_attr"] = rng.random((e, 1)).astype(np.float32)
    kw = dict(model_name="ConvNet", num_epoch=3, lr=1e-2, dropout=0.0,
              use_scheduler=False, log_every=0, adjacency_method="blocked")
    cfg = Stage2Config(**kw)
    g, adj = ts2.prepare_stage2_graph(data, cfg, "cpu")
    pseudo = ts2.model_inputs(data, cfg, g)["pseudo"]
    # every (sender, receiver) pair of the graph carries the attributes of
    # the data's edges between them (repeated pairs included)
    want_by_pair, got_by_pair = {}, {}
    for (s_, r_), a in zip(data["edge_index"].T, data["edge_attr"][:, 0]):
        want_by_pair.setdefault((int(s_), int(r_)), []).append(float(a))
    for (s_, r_), a in zip(g.edge_index_np().T,
                           pseudo.numpy()[: g.num_edges, 0]):
        got_by_pair.setdefault((int(s_), int(r_)), []).append(float(a))
    assert {k: sorted(v) for k, v in got_by_pair.items()} == \
        {k: sorted(v) for k, v in want_by_pair.items()}
    assert (pseudo.numpy()[g.num_edges:] == 0).all()
    res = train_ktgnn(data, cfg, device="cpu")
    init = ts2.build_model(cfg, g.num_classes, g.num_features, "cpu")
    variables = flax_variables_from_state_dict(init, init.state_dict())

    gj, aj = js2.prepare_stage2_graph(
        dict(data, train_mask=g.train_mask[: g.num_nodes].numpy()),
        js2.Stage2Config(**{k: v for k, v in kw.items()}))
    jm = jbb.ConvNet(CLASSES, dropout=0.0)
    pj = jnp.asarray(pseudo.numpy())

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            lp = jm.apply({"params": p}, gj, aj, True, pseudo=pj)
            return js2.masked_nll(lp, gj.y, gj.train_mask)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree.map(lambda a, u: a + u, params, updates), \
            opt_state, loss

    tx = torch_adam(kw["lr"], weight_decay=cfg.weight_decay)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)
    losses_j = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state)
        losses_j.append(float(loss))
    np.testing.assert_allclose([h["loss"] for h in res["history"]],
                               losses_j, rtol=1e-4)
    want = state_dict_from_flax(init, jax.tree.map(
        np.asarray, {"params": params}))
    for k, t in res["state_dict"].items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
