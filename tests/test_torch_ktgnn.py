"""PyTorch port, model and serving: KT-GNN with weights carried over from
flax matches the JAX model's three heads and embeddings (JAX side on its
fused-kernel forward in interpret mode), and the predictor and the HTTP
serving app answer as the JAX ones do, on single and tiered layouts; the
serving CLI serves ``--mode similarity`` too."""

import json
import pickle
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.cli import serve as jcli
from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.io.serialize import save_graph_npz
from bridged_gnn_tpu.nn.ktgnn import KTGNN as JKTGNN
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj
from bridged_gnn_tpu.serve import KTGNNPredictor as JPredictor

from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.io.flax_weights import state_dict_from_flax
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.serve import KTGNNPredictor
from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, build_model

from tests.test_torch_cuda import skewed_data
from tests.test_torch_graph import sync_data

ATOL = 1e-4
HIDDEN, CLASSES, DIM = 16, 3, 12
HEADS = ("source", "target", "target_hat")


def _jax_variables(data, seed=0, hidden=HIDDEN):
    """Flax init plus random BN affine and running statistics, so batch
    norm is not the identity; as the stage-2 --save pickle holds them."""
    model = JKTGNN(num_classes=CLASSES, layer_num=2, hidden=hidden)
    g = j_with_self_loops(j_graph_from_dict(dict(data)))
    variables = model.init(jax.random.PRNGKey(seed), g,
                           j_adj(g, method="blocked", node_block=128), False)
    rng = np.random.default_rng(seed)

    def randomize(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "scale") or path[0].key == "batch_stats":
            return (rng.normal(size=a.shape) * 0.3
                    + (name == "scale")).astype(np.float32)
        if name == "bias" and path[-2].key.startswith(("bns", "bn")):
            return (rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return a

    return model, jax.tree_util.tree_map_with_path(randomize, variables)


@pytest.fixture(scope="module")
def sync_case():
    data = sync_data(dim=DIM, num_classes=CLASSES)
    jmodel, variables = _jax_variables(data)
    return data, jmodel, variables


@pytest.fixture(scope="module")
def skew_case():
    data = skewed_data(np.random.default_rng(5), n=160, c=CLASSES, d=DIM)
    jmodel, variables = _jax_variables(data, seed=1)
    return data, jmodel, variables


def _port_model(variables, hidden=HIDDEN):
    model = build_model(Stage2Config(hidden=hidden), CLASSES, DIM,
                        device="cpu")
    model.load_state_dict(state_dict_from_flax(model, variables),
                          strict=True)
    return model.eval()


def test_state_dict_from_flax_layout(sync_case):
    _, _, variables = sync_case
    model = build_model(Stage2Config(hidden=HIDDEN), CLASSES, DIM,
                        device="cpu")
    sd = state_dict_from_flax(model, variables)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
        assert v.dtype == torch.float32
    p = variables["params"]
    np.testing.assert_array_equal(
        sd["convs.0.lin_t.weight"].numpy(),
        np.asarray(p["convs_0"]["lin_t"]["kernel"]).T)
    np.testing.assert_array_equal(
        sd["clf_target.a_f_s2t"].numpy(),
        np.asarray(p["clf_target"]["a_f_s2t"]["kernel"])[:, 0])
    np.testing.assert_array_equal(
        sd["clf_transformer.bn_1.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["clf_transformer"]["bn_1"]["var"]))
    bad = dict(variables, params=dict(variables["params"], complementor={}))
    with pytest.raises(ValueError, match="complementor"):
        state_dict_from_flax(model, bad)


@pytest.mark.parametrize("case,method", [("sync_case", "blocked"),
                                         ("skew_case", "blocked"),
                                         ("skew_case", "tiered")])
def test_ktgnn_matches_jax(request, case, method):
    """All three heads and the embeddings, weights carried over; the JAX
    model runs its fused-kernel forward (interpret mode)."""
    data, jmodel, variables = request.getfixturevalue(case)
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    aj = j_adj(gj, method=method, node_block=128)
    jk = jmodel.clone(fused_kernel_fwd=True, select_gather=True)
    want, inter = jk.apply(variables, gj, aj, False,
                           mutable=["intermediates"])
    gt = with_self_loops(graph_from_dict(dict(data)))
    at = adjacency_from_graph(gt, method=method, node_block=128,
                              device="cpu")
    assert (at.tiered_fn is None) == (aj.tiered_fn is None)
    model = _port_model(variables)
    with torch.inference_mode():
        got = model(gt, at)
        emb = model.embed(gt, at)
    for g_, w_ in zip(got, want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=ATOL)
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(inter["intermediates"]["node_embeddings"][0]),
        atol=ATOL)


def test_ktgnn_wide_hidden_matches_jax():
    """KT-GNN at hidden 320, wider than the kernels' lane groups hold
    (256), so the card takes their wide path: the port (plain versions on
    the CPU) against the JAX model's fused-kernel forward, all three heads
    within 1e-4."""
    data = sync_data(dim=DIM, num_classes=CLASSES)
    jmodel, variables = _jax_variables(data, hidden=320)
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    aj = j_adj(gj, method="blocked", node_block=128)
    want = jmodel.clone(fused_kernel_fwd=True, select_gather=True).apply(
        variables, gj, aj, False)
    gt = with_self_loops(graph_from_dict(dict(data)))
    at = adjacency_from_graph(gt, method="blocked", node_block=128,
                              device="cpu")
    model = _port_model(variables, hidden=320)
    assert model.convs[0].lin_t.weight.shape[0] == 320
    with torch.inference_mode():
        got = model(gt, at)
    for g_, w_ in zip(got, want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=ATOL)


def test_masked_batch_norm_matches_jax(rng):
    """Mask-aware batch statistics and the running-stat update in train
    mode, running statistics in eval mode, against the flax module."""
    import jax.numpy as jnp

    from bridged_gnn_tpu.nn.common import MaskedBatchNorm as JBN
    from bridged_gnn_tpu.nn.common import masked_mean as j_masked_mean

    from bridged_gnn_tpu_torch.nn.common import MaskedBatchNorm, masked_mean

    x = rng.normal(size=(40, 6)).astype(np.float32) * 3 + 1
    mask = rng.random(40) < 0.7
    np.testing.assert_allclose(
        masked_mean(torch.from_numpy(x), torch.from_numpy(mask)).numpy(),
        np.asarray(j_masked_mean(jnp.asarray(x), jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)
    jbn = JBN()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    v = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), v)
    y_j, upd = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                         mutable=["batch_stats"])
    bn = MaskedBatchNorm(6)
    bn.load_state_dict({
        "weight": torch.tensor(np.asarray(v["params"]["scale"])),
        "bias": torch.tensor(np.asarray(v["params"]["bias"])),
        "running_mean": torch.tensor(np.asarray(v["batch_stats"]["mean"])),
        "running_var": torch.tensor(np.asarray(v["batch_stats"]["var"])),
    })
    bn.eval()
    y_eval = jbn.apply(v, jnp.asarray(x), jnp.asarray(mask),
                       use_running_average=True)
    np.testing.assert_allclose(
        bn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(),
        np.asarray(y_eval), rtol=1e-5, atol=1e-5)
    bn.train()
    with torch.no_grad():
        y_t = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, ours).numpy(),
            np.asarray(upd["batch_stats"][theirs]), rtol=1e-5, atol=1e-6)


def test_ktgnn_train_mode_matches_jax(sync_case):
    """Train mode (batch statistics, dropout 0) on both sides."""
    data, jmodel, variables = sync_case
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    aj = j_adj(gj, method="blocked", node_block=128)
    jk = jmodel.clone(fused_kernel_fwd=True, select_gather=True, dropout=0.0)
    want, upd = jk.apply(variables, gj, aj, True, mutable=["batch_stats"])
    gt = with_self_loops(graph_from_dict(dict(data)))
    at = adjacency_from_graph(gt, method="blocked", node_block=128,
                              device="cpu")
    model = _port_model(variables)
    model.dropout = 0.0
    model.train()
    with torch.no_grad():
        got = model(gt, at)
    for g_, w_ in zip(got, want[:3]):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=ATOL)
    np.testing.assert_allclose(
        model.bns[0].running_var.numpy(),
        np.asarray(upd["batch_stats"]["bns_0"]["var"]), rtol=1e-4)


def _assert_preds(got, want):
    assert set(got) == set(want) == set(HEADS)
    for h in HEADS:
        np.testing.assert_allclose(got[h], want[h], atol=ATOL, err_msg=h)


@pytest.fixture(scope="module")
def predictors(sync_case):
    data, jmodel, variables = sync_case
    jp = JPredictor(jmodel, variables, dict(data), kernel_fwd=True)
    model = _port_model(variables)
    # the slot layout the JAX kernel path builds ("auto" is dense here)
    tp = KTGNNPredictor(model, state_dict_from_flax(model, variables),
                        dict(data), adjacency_method="blocked", device="cpu")
    return jp, tp


def test_predictor_matches_jax(predictors):
    jp, tp = predictors
    assert tp.adj.fast_fn is not None
    assert tp.adj.fast_fn.lay_dst.node_block == 128
    _assert_preds(tp.predict(), jp.predict())
    np.testing.assert_allclose(tp.embeddings(), jp.embeddings(), atol=ATOL)
    np.testing.assert_array_equal(tp.predict_labels("source"),
                                  jp.predict_labels("source"))
    rng = np.random.default_rng(11)
    n, d = tp.graph.num_nodes, tp.graph.num_features
    x = rng.normal(size=(n, d)).astype(np.float32)
    _assert_preds(tp.predict_live(x), jp.predict_live(x))
    nodes = np.array([0, 7, 93, 149])
    rows = rng.normal(size=(len(nodes), d)).astype(np.float32)
    _assert_preds(tp.predict_live(rows, nodes), jp.predict_live(rows, nodes))
    # live calls leave the stored features alone
    _assert_preds(tp.predict_live(), jp.predict())


def test_predictor_validation_errors_match_jax(predictors):
    jp, tp = predictors
    n, d = tp.graph.num_nodes, tp.graph.num_features
    bad_calls = [
        (np.zeros((n - 1, d), np.float32), None),
        (np.zeros((2, d), np.float32), np.array([1.0, 2.0])),
        (np.zeros((2, d), np.float32), np.array([[1, 2]])),
        (np.zeros((2, d), np.float32), np.array([0, n])),
        (np.zeros((2, d + 1), np.float32), np.array([0, 1])),
    ]
    for x, nodes in bad_calls:
        with pytest.raises(ValueError) as ej:
            jp.predict_live(x, nodes)
        with pytest.raises(ValueError) as et:
            tp.predict_live(x, nodes)
        assert str(et.value) == str(ej.value)


def test_tiered_predictor_matches_jax(skew_case):
    data, jmodel, variables = skew_case
    jp = JPredictor(jmodel, variables, dict(data), kernel_fwd=True,
                    adjacency_method="tiered")
    tp = KTGNNPredictor(_port_model(variables), None, dict(data),
                        adjacency_method="tiered", device="cpu")
    assert tp.adj.tiered_fn is not None and jp.adj.tiered_fn is not None
    _assert_preds(tp.predict(), jp.predict())
    rng = np.random.default_rng(12)
    nodes = np.array([3, 4, 100])
    rows = rng.normal(size=(3, DIM)).astype(np.float32)
    jp.update_features(rows, nodes)
    tp.update_features(rows, nodes)
    _assert_preds(tp.predict(), jp.predict())


def _compare_app_answers(japp, tapp, n, d):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, d)).astype(np.float32)
    rows = rng.normal(size=(2, d)).astype(np.float32)
    bodies = [
        {},
        {"head": "source", "nodes": [0, 3, 5], "log_probs": True},
        {"head": "target", "x": x.tolist(), "log_probs": True},
        {"x": rows.tolist(), "x_nodes": [1, 4], "log_probs": True},
        {"head": "bogus"},
        {"nodes": [-1]},
        {"x": rows.tolist(), "x_nodes": [1.5, 2]},
        {"x": rows.tolist()},
    ]

    def answer(app, body):
        try:
            return 200, app.predict(body)
        except Exception as e:  # the apps' _ApiError
            return e.code, e.message

    for body in bodies:
        (cj, aj), (ct, at) = answer(japp, body), answer(tapp, body)
        assert cj == ct, body
        if cj != 200:
            assert at == aj, body
            continue
        assert at["labels"] == aj["labels"] and \
            at["computed"] == aj["computed"], body
        if "log_probs" in aj:
            np.testing.assert_allclose(at["log_probs"], aj["log_probs"],
                                       atol=ATOL)
    refresh = {"x": rows.tolist(), "nodes": [2, 3]}
    assert tapp.refresh(refresh) == japp.refresh(refresh)
    for body in ({"log_probs": True}, {"head": "target", "log_probs": True}):
        np.testing.assert_allclose(tapp.predict(body)["log_probs"],
                                   japp.predict(body)["log_probs"],
                                   atol=ATOL)


def test_serving_app_answers_as_jax(predictors):
    jp, tp = predictors
    japp = jcli.ServingApp(predictor=jp)
    tapp = tcli.ServingApp(predictor=tp)
    assert tapp.healthz() == {"status": "ok", "backend": "cpu"}
    _compare_app_answers(japp, tapp, tp.graph.num_nodes,
                         tp.graph.num_features)


def test_cli_load_and_http(tmp_path, sync_case):
    """The CLI loads the .npz graph and the JAX stage-2 --save pickle and
    serves the same answers as the JAX CLI, over HTTP too."""
    data, _, variables = sync_case
    npz, ckpt = str(tmp_path / "g.npz"), str(tmp_path / "best.pkl")
    save_graph_npz(npz, data)
    with open(ckpt, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, variables), f)
    argv = ["--mode", "predictor", "--ckpt", ckpt, "--path_data", npz,
            "--hidden_dim", str(HIDDEN), "--to_undirected"]
    japp = jcli._load_predictor(jcli.build_argparser().parse_args(argv))
    tapp = tcli._load_predictor(
        tcli.build_argparser().parse_args(argv + ["--device", "cpu"]))
    assert tapp.meta["num_classes"] == japp.meta["num_classes"]
    n, d = data["x"].shape
    _compare_app_answers(japp, tapp, n, d)

    srv = tcli.make_server(tapp)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        def call(path, body=None):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=None if body is None else json.dumps(body).encode())
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        assert call("/healthz") == (200, {"status": "ok", "backend": "cpu"})
        code, out = call("/v1/predict", {"nodes": [0, 1, 2]})
        assert code == 200 and out["computed"] == "cache"
        assert out["labels"] == japp.predict({"nodes": [0, 1, 2]})["labels"]
        rows = np.ones((1, d), np.float32).tolist()
        code, out = call("/v1/predict", {"x": rows, "x_nodes": [5]})
        assert code == 200 and out["computed"] == "live"
        assert call("/v1/predict", {"head": "nope"})[0] == 400
        assert call("/v1/topk", {"x": rows})[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


def test_cli_similarity_mode_serves(tmp_path, monkeypatch, capsys):
    """``--mode similarity`` loads a stage-1 pickle and a corpus npz and
    serves /v1/topk (``tests/test_torch_similarity.py`` holds its answers
    against JAX's)."""
    from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
    from bridged_gnn_tpu_torch.io.flax_weights import (
        flax_variables_from_state_dict,
    )
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    data = sync_data(dim=DIM, num_classes=CLASSES)
    npz, ckpt = str(tmp_path / "g.npz"), str(tmp_path / "s1.pkl")
    save_graph_npz(npz, data)
    src, tar, _, _ = dataset_conversion(dict(data), seed=0)
    model = ts1.build_model(ts1.Stage1Config(hidden_dim=HIDDEN), src, tar,
                            "cpu")
    with open(ckpt, "wb") as f:
        pickle.dump(flax_variables_from_state_dict(model,
                                                   model.state_dict()), f)
    served = []

    class _Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            served.append(True)

        def server_close(self):
            pass

    def make_server(app, host, port):
        served.append(app)
        return _Server()

    monkeypatch.setattr(tcli, "make_server", make_server)
    tcli.main(tcli.build_argparser().parse_args(
        ["--mode", "similarity", "--ckpt", ckpt, "--corpus", npz,
         "--hidden_dim", str(HIDDEN), "--device", "cpu"]))
    app = served[0]
    assert served[1] is True
    assert "serving similarity" in capsys.readouterr().out
    assert app.meta["mode"] == "similarity"
    out = app.topk({"x": np.ones((2, DIM)).tolist(), "k": 3})
    assert np.asarray(out["indices"]).shape == (2, 3)


def test_predictor_rejects_repeated_ids(predictors):
    """A partial feature update that names a node twice raises ValueError
    and leaves the stored features alone: which of the repeated rows an
    indexed assignment keeps is unspecified on CUDA. (The JAX predictor
    accepts it.)"""
    _, tp = predictors
    rows = np.arange(3 * DIM, dtype=np.float32).reshape(3, DIM)
    nodes = np.array([4, 9, 4])
    before = tp.graph.x.clone()
    for call in (tp.predict_live, tp.update_features):
        with pytest.raises(ValueError, match="repeat an id"):
            call(rows, nodes)
    assert torch.equal(tp.graph.x, before)
    tp.predict_live(rows, np.array([4, 9, 5]))   # distinct ids still serve


def test_http_rejects_repeated_ids(predictors):
    """Over HTTP, a live /v1/predict with a repeated id in ``x_nodes`` and
    a /v1/refresh with a repeated id in ``nodes`` answer 400 and change
    nothing."""
    _, tp = predictors
    app = tcli.ServingApp(predictor=tp)
    srv = tcli.make_server(app)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        def call(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                         data=json.dumps(body).encode())
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        rows = np.ones((2, DIM), np.float32).tolist()
        before = call("/v1/predict", {"log_probs": True})
        for path, body in (("/v1/predict", {"x": rows, "x_nodes": [6, 6]}),
                           ("/v1/refresh", {"x": rows, "nodes": [2, 2]})):
            code, out = call(path, body)
            assert code == 400 and "repeat an id" in json.dumps(out), path
        assert call("/v1/predict", {"log_probs": True}) == before
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not th.is_alive()
