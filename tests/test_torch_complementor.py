"""PyTorch port, KT-GNN's feature complementor: the frontiers
(``build_frontier_edges``, ``pad_frontiers``), the complementor's
forward, ``loss_dist`` and gradients, KT-GNN with it on a slot layout and
on a dense adjacency, the flax weights both ways, a 2-epoch
``need_complement=True`` run in loop and scan mode, and the models that
refuse it, each against the JAX package on the same inputs. The JAX
complementor drops its attention coefficients at a fixed 0.5 in train
mode; both sides run those steps at dropout 0 here (the port's
``ALPHA_DROPOUT``, a JAX subclass with ``dropout=0``), so that the same
function is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.nn import complementor as jcomp
from bridged_gnn_tpu.nn.ktgnn import KTGNN as JKTGNN
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.train import stage2 as js2

from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)
from bridged_gnn_tpu_torch.nn import complementor as tcomp
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

N_SRC, N_TAR, DIM, CLASSES, HIDDEN = 90, 60, 12, 3, 16
D_O = 5                      # the observed prefix (dim_share)
H_O, H_U = 8, 6              # the complementor's widths
FWD_TOL = dict(rtol=1e-5, atol=1e-5)    # f32 sums in another order
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_torch_train.py
LOGPROB_ATOL = 1e-4                     # tests/test_torch_ktgnn.py


class _JLayerNoDrop(jcomp.AdaptedCompleteLayer):
    dropout: float = 0.0


@pytest.fixture
def no_alpha_dropout(monkeypatch):
    """Both packages' complementor steps at dropout 0."""
    monkeypatch.setattr(jcomp, "AdaptedCompleteLayer", _JLayerNoDrop)
    monkeypatch.setattr(tcomp, "ALPHA_DROPOUT", 0.0)


def _data(seed=1):
    """The synthetic graph with edges inside and across the domains (so
    the frontiers reach targets), split 60/20/20."""
    data = make_sync_dataset("relational-intra-inter", n_src=N_SRC,
                             n_tar=N_TAR, dim=DIM, num_classes=CLASSES,
                             seed=seed)
    r = np.random.default_rng(seed).random(N_SRC + N_TAR)
    data.update(train_mask=r < 0.6, val_mask=(r >= 0.6) & (r < 0.8),
                test_mask=r >= 0.8)
    return data


def _graphs(data):
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    gt = with_self_loops(graph_from_dict(dict(data)))
    return gj, gt


def _fronts(g, step, device="cpu"):
    ei = g.edge_index_np()
    cm = np.asarray(g.central_mask)[: g.num_nodes]
    return (jcomp.pad_frontiers(jcomp.build_frontier_edges(ei, cm, step),
                                g.num_nodes_padded),
            tcomp.pad_frontiers(tcomp.build_frontier_edges(ei, cm, step),
                                g.num_nodes_padded, device=device))


@pytest.mark.parametrize("step", [1, 2, 3])
def test_frontiers_match_jax(step):
    """The frontier edge sets and their padded tensors equal the JAX
    package's (the second step starts from the targets the first
    reached)."""
    gj, gt = _graphs(_data())
    ei, cm = gt.edge_index_np(), gt.central_mask.numpy()[: gt.num_nodes]
    want = jcomp.build_frontier_edges(ei, cm, step)
    got = tcomp.build_frontier_edges(ei, cm, step)
    assert len(got) == len(want) == step
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1] > 0
    if step > 1:
        assert got[1].shape[1] > 0
    jf, tf = _fronts(gt, step)
    for ftj, ftt in zip(jf, tf):
        for a, b in zip(ftt, ftj):
            assert a.dtype in (torch.int32, torch.bool)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _complementor(gj, fronts_j, use_dist_loss, step):
    jm = jcomp.AdaptedComplementor(dim_o=D_O, dim_u=DIM - D_O, hidden_o=H_O,
                                   hidden_u=H_U, step=step,
                                   use_dist_loss=use_dist_loss)
    variables = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(4), gj.x, fronts_j, gj.central_mask,
        gj.node_mask, False))
    tm = tcomp.AdaptedComplementor(D_O, DIM - D_O, H_O, H_U, step,
                                   use_dist_loss)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    return jm, variables, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_dist_loss", [False, True],
                         ids=["no_dist", "dist"])
def test_complementor_matches_jax(no_alpha_dropout, use_dist_loss, train):
    """The completed features, ``loss_dist`` (train mode with
    ``use_dist_loss`` only) and the gradients of their sum to the features
    and every parameter, over two frontiers, weights carried from flax:
    forward at rtol/atol 1e-5, gradients at rtol 2e-4 / atol 2e-5."""
    gj, gt = _graphs(_data())
    fj, ft = _fronts(gt, 2)
    jm, variables, tm = _complementor(gj, fj, use_dist_loss, 2)
    rng = np.random.default_rng(2)
    ct = rng.normal(size=(gt.num_nodes_padded, H_O + H_U)).astype(np.float32)

    def f(params, x):
        out, ld = jm.apply({"params": params}, x, fj, gj.central_mask,
                           gj.node_mask, train)
        return jnp.sum(out * ct) + (0.0 if ld is None else ld), (out, ld)

    (_, (want, ld_j)), grads_j = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], gj.x)
    x = gt.x.clone().requires_grad_()
    tm.train(train)
    out, ld = tm(x, ft, gt.central_mask, gt.node_mask)
    assert (ld is None) == (ld_j is None) == (not (train and use_dist_loss))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    total = (out * torch.from_numpy(ct)).sum()
    if ld is not None:
        np.testing.assert_allclose(ld.item(), float(ld_j), rtol=1e-5)
        total = total + ld
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(total, [x] + list(params.values()))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(grads_j[1]),
                               **GRAD_TOL)
    want_g = state_dict_from_flax(tm, {"params": grads_j[0]})
    for (name, _), g in zip(params.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want_g[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_complementor_takes_edges_in_any_order(no_alpha_dropout):
    """The frontiers need no destination order (the JAX segment ops run
    with ``indices_are_sorted=False``): every frontier's edges shuffled,
    padding included, give the same output at rtol/atol 1e-5."""
    gj, gt = _graphs(_data())
    fj, ft = _fronts(gt, 2)
    _, _, tm = _complementor(gj, fj, True, 2)
    perm = [torch.from_numpy(np.random.default_rng(i).permutation(
        f[0].shape[0])) for i, f in enumerate(ft)]
    shuffled = [tuple(a[p] for a in f) for f, p in zip(ft, perm)]
    with torch.no_grad():
        want = tm.train()(gt.x, ft, gt.central_mask, gt.node_mask)
        got = tm(gt.x, shuffled, gt.central_mask, gt.node_mask)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)


def test_complementor_dropout_draws_from_the_generator():
    """In train mode the coefficients drop at ALPHA_DROPOUT (0.5, as the
    JAX package fixes it), drawn from the caller's generator."""
    _, gt = _graphs(_data())
    _, ft = _fronts(gt, 2)
    tm = tcomp.AdaptedComplementor(D_O, DIM - D_O, H_O, H_U, 2).train()
    assert tm.adapted_layer.dropout == tcomp.ALPHA_DROPOUT == 0.5

    def run(seed):
        return tm(gt.x, ft, gt.central_mask, gt.node_mask,
                  torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        tm(gt.x, ft, gt.central_mask, gt.node_mask)


# -------------------------------------------------------------- KT-GNN


def _ktgnn_pair(gj, aj, fronts_j, dim_share=D_O, step=2):
    jmodel = JKTGNN(num_classes=CLASSES, layer_num=2, hidden=HIDDEN,
                    need_complement=True, dim_share=dim_share, step=step,
                    use_dist_loss=True)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(5), gj, aj, False, frontiers=fronts_j))
    model = KTGNN(CLASSES, DIM, hidden=HIDDEN, need_complement=True,
                  dim_share=dim_share, step=step, use_dist_loss=True)
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    return jmodel, variables, model


@pytest.mark.parametrize("dim_share", [0, D_O])
@pytest.mark.parametrize("method", ["blocked", "dense"])
def test_ktgnn_with_complementor_matches_jax(no_alpha_dropout, method,
                                             dim_share):
    """KT-GNN with the complementor (its default widths, 128 + 128 into
    the convs) on a slot layout (the JAX side on its fused-kernel forward
    in interpret mode) and on a dense adjacency: the three heads in eval
    mode at atol 1e-4, and ``loss_dist`` in train mode (dropout 0) at
    rtol 1e-5; ``dim_share=0`` observes no feature at all."""
    gj, gt = _graphs(_data())
    fj, ft = _fronts(gt, 2)
    aj = j_adj(gj, method=method, node_block=128)
    at = adjacency_from_graph(gt, method=method, node_block=128,
                              device="cpu")
    jmodel, variables, model = _ktgnn_pair(gj, aj, fj, dim_share)
    assert model.convs[0].lin_t.weight.shape[1] == 256
    jk = (jmodel.clone(fused_kernel_fwd=True, select_gather=True)
          if method == "blocked" else jmodel)
    want = jk.apply(variables, gj, aj, False, frontiers=fj)
    with torch.no_grad():
        got = model.eval()(gt, at, frontiers=ft)
    assert got[3] is None and want[3] is None
    for g_, w_ in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_),
                                   atol=LOGPROB_ATOL)
    want_t, _ = jk.clone(dropout=0.0).apply(
        variables, gj, aj, True, frontiers=fj, mutable=["batch_stats"])
    model.dropout = 0.0
    with torch.no_grad():
        got_t = model.train()(gt, at, frontiers=ft)
    np.testing.assert_allclose(got_t[3].item(), float(want_t[3]), rtol=1e-5)
    with pytest.raises(TypeError, match="frontiers"):
        model.eval()(gt, at)


def test_complementor_weights_round_trip():
    """The complementor's flax leaves (input_layer_o/u, adapted_layer's
    lin_f_src_0, lin_f_tar_0, lin_diff, lin_g, layers_{i}) carried to the
    port's state dict and back give the same tree, leaf for leaf."""
    gj, gt = _graphs(_data())
    fj, _ = _fronts(gt, 3)
    _, variables, model = _ktgnn_pair(gj, j_adj(gj, method="dense"), fj,
                                      step=3)
    assert set(variables["params"]["complementor"]) == {
        "input_layer_o", "input_layer_u", "adapted_layer", "layers_0",
        "layers_1"}
    back = flax_variables_from_state_dict(model, model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


# ----------------------------------------------------------- the trainer


def _cfg(**kw):
    return dict(**{**dict(num_epoch=2, hidden=HIDDEN, lr=1e-2, dropout=0.0,
                          log_every=0, need_complement=True, dim_share=D_O,
                          complement_step=2, use_dist_loss=True,
                          adjacency_method="blocked"), **kw})


@pytest.mark.parametrize("method", ["blocked", "dense"])
def test_train_need_complement_matches_jax(no_alpha_dropout, monkeypatch,
                                           method):
    """2 epochs of ``need_complement=True`` (``dim_share`` 5, two
    frontiers, ``use_dist_loss``) from the port's seeded init carried to
    flax, at dropout 0, against the JAX runtime: every loss (``loss_dist``
    included) at rtol 1e-4, the scores to 1e-12; scan mode (chunks of 1)
    gives the loop's history, losses at rtol 1e-6: ``loss_dist``'s
    backward goes through the CPU's multithreaded reductions, which are
    not bit-reproducible from one run to the next."""
    data = _data()
    kw = _cfg(adjacency_method=method)
    port = train_ktgnn(data, Stage2Config(**kw), device="cpu")
    scan = train_ktgnn(data, Stage2Config(scan_epochs=1, **kw), device="cpu")
    for hs, hp in zip(scan["history"], port["history"]):
        assert hs == pytest.approx(hp, rel=1e-6)
    g, _ = ts2.prepare_stage2_graph(data, Stage2Config(**kw), "cpu")
    init = ts2.build_model(Stage2Config(**kw), g.num_classes,
                           g.num_features, "cpu")
    variables = flax_variables_from_state_dict(init, init.state_dict())
    monkeypatch.setattr(JKTGNN, "init", lambda self, *a, **k: variables)
    jres = js2.train_ktgnn(data, js2.Stage2Config(**kw))
    assert len(port["history"]) == len(jres["history"]) == 2
    for hp, hj in zip(port["history"], jres["history"]):
        for key in ("loss", "loss_t2"):
            assert hp[key] == pytest.approx(hj[key], rel=1e-4), hp["epoch"]
        for key in ("train", "val", "test"):
            assert hp[key] == pytest.approx(hj[key], abs=1e-12), hp["epoch"]


def test_loss_dist_joins_the_loss(no_alpha_dropout):
    """The trainer's KT-GNN loss is the four-term loss plus
    ``loss_dist``: with ``use_dist_loss`` off the loss falls by exactly
    the model's ``loss_dist``."""
    data = _data()
    losses = {}
    for dist in (False, True):
        cfg = Stage2Config(**_cfg(use_dist_loss=dist))
        g, adj = ts2.prepare_stage2_graph(data, cfg, "cpu")
        inputs = ts2.model_inputs(data, cfg, g)
        model = ts2.build_model(cfg, g.num_classes, g.num_features, "cpu")
        with torch.no_grad():
            losses[dist] = ts2.stage2_loss(model, g, adj, 1.0, None,
                                           inputs)[0].item()
            ld = model.train()(g, adj, None, **inputs)[3]
    assert ld is not None and ld.item() > 0
    assert losses[True] == pytest.approx(losses[False] + ld.item(),
                                         rel=1e-6)


@pytest.mark.parametrize("overrides", [
    dict(model_name="GraphSAGE"), dict(model_name="KTGNN_noDTC"),
    dict(no_dtc=True)], ids=["GraphSAGE", "KTGNN_noDTC", "no_dtc"])
def test_complementor_on_other_models_raises_type_error(overrides):
    """As the JAX runtime, whose model refuses the frontiers with a
    TypeError, the port refuses need_complement on a single-head model."""
    data = _data()
    with pytest.raises(TypeError, match="frontiers"):
        js2.train_ktgnn(data, js2.Stage2Config(**_cfg(**overrides)))
    with pytest.raises(TypeError, match="frontiers"):
        train_ktgnn(data, Stage2Config(**_cfg(**overrides)), device="cpu")
