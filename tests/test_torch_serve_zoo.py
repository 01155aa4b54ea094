"""PyTorch port, serving any stage-2 model: a GraphSAGE ``--save`` pickle
of the port's training CLI (``--no_dtc``) served with ``--model_name
GraphSAGE``, and a ``KTGNNNoDTC`` pickle served with ``--no_dtc``, by
both packages' serving CLIs, which answer alike; the predictor's self
loops for every model (the JAX predictor's quirk, kept); its layouts; the
cache read under the serving lock; and the warning for a ``"lean"``
memory policy that runs plain.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.cli import serve as jcli
from bridged_gnn_tpu.io.serialize import save_graph_npz

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli2
from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.nn.backbones import GraphSAGENet
from bridged_gnn_tpu_torch.nn.ktgnn import KTGNNNoDTC
from bridged_gnn_tpu_torch.ops.spmm import resolve_adjacency_method
from bridged_gnn_tpu_torch.serve import KTGNNPredictor
from bridged_gnn_tpu_torch.train import stage2 as ts2
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    resolve_memory_policy,
    train_ktgnn,
)

from tests.test_torch_graph import sync_data
from tests.test_torch_ktgnn import HEADS, _assert_preds, _compare_app_answers

DIM, CLASSES, HIDDEN = 12, 3, 16


@pytest.fixture(scope="module")
def graph_npz(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo_serve")
    data = sync_data(dim=DIM, num_classes=CLASSES)
    npz = str(tmp / "g.npz")
    save_graph_npz(npz, data)
    return tmp, data, npz


@pytest.fixture(scope="module")
def sage_ckpt(graph_npz):
    """The port's training CLI with --no_dtc (GraphSAGE, no scheduler) and
    --save, 3 epochs on the CPU."""
    tmp, _, npz = graph_npz
    args = tcli2.build_argparser().parse_args([
        "--path_data", npz, "--no_dtc", "--num_epoch", "3", "--hidden_dim",
        str(HIDDEN), "--to_undirected", "--save", "--ckpt_dir",
        str(tmp / "ck"), "--dataset_name", "sync", "--log_every", "0",
        "--device", "cpu"])
    tcli2.main(args)
    return str(tmp / "ck" / "model_GraphSAGE_sync_best.pkl")


@pytest.fixture(scope="module")
def no_dtc_ckpt(graph_npz):
    """A KTGNNNoDTC best-epoch pickle of the port's trainer."""
    tmp, data, _ = graph_npz
    path = str(tmp / "model_KTGNN_noDTC_sync_best.pkl")
    train_ktgnn(data, Stage2Config(
        model_name="KTGNN_noDTC", num_epoch=3, hidden=HIDDEN,
        to_undirected=True, save_best_path=path, log_every=0),
        device="cpu")
    return path


def _apps(npz, ckpt, flags):
    argv = ["--mode", "predictor", "--ckpt", ckpt, "--path_data", npz,
            "--hidden_dim", str(HIDDEN), "--to_undirected"] + flags
    japp = jcli._load_predictor(jcli.build_argparser().parse_args(argv))
    tapp = tcli._load_predictor(
        tcli.build_argparser().parse_args(argv + ["--device", "cpu"]))
    return japp, tapp


@pytest.mark.parametrize("flags,model_cls,name", [
    (["--model_name", "GraphSAGE"], GraphSAGENet, "GraphSAGE"),
    (["--no_dtc"], KTGNNNoDTC, "KTGNN_noDTC")],
    ids=["GraphSAGE", "no_dtc"])
def test_cli_serves_a_zoo_checkpoint_as_jax(graph_npz, sage_ckpt,
                                            no_dtc_ckpt, flags, model_cls,
                                            name):
    """Both serving CLIs load the same --save pickle with the same flags
    and give the same answers (log-probs at atol 1e-4), the one head
    standing for all three; ``--no_dtc`` with the default KTGNN builds
    KTGNNNoDTC; meta names the model that was built."""
    _, data, npz = graph_npz
    ckpt = sage_ckpt if name == "GraphSAGE" else no_dtc_ckpt
    japp, tapp = _apps(npz, ckpt, flags)
    assert isinstance(tapp.predictor.model, model_cls)
    assert tapp.meta["model_name"] == name
    assert tapp.meta["heads"] == list(HEADS)
    _assert_preds(tapp.predictor.predict(), japp.predictor.predict())
    preds = tapp.predictor.predict()
    for h in HEADS[1:]:
        np.testing.assert_array_equal(preds[h], preds["source"])
    n, d = data["x"].shape
    _compare_app_answers(japp, tapp, n, d)


def test_zoo_predictor_adds_self_loops_as_jax(graph_npz, sage_ckpt):
    """The JAX predictor adds self loops for every model
    (``bridged_gnn_tpu/serve.py:43``), while GraphSAGE trained without
    them: the port's predictor does the same, so a served GraphSAGE
    averages over a loop it never saw. Its answers are the model's on the
    looped graph, not on the training graph."""
    _, data, npz = graph_npz
    japp, tapp = _apps(npz, sage_ckpt, ["--model_name", "GraphSAGE"])
    pred = tapp.predictor
    cfg = Stage2Config(model_name="GraphSAGE", to_undirected=True)
    g_train, adj_train = ts2.prepare_stage2_graph(data, cfg, "cpu")
    n = g_train.num_nodes
    loops = [int((ei[0] == ei[1]).sum()) for ei in (
        g_train.edge_index_np(), pred.graph.edge_index_np())]
    assert loops[0] < n and loops[1] == n
    assert pred.graph.num_edges == g_train.num_edges - loops[0] + n
    assert pred.graph.num_edges == japp.predictor.graph.num_edges
    with torch.no_grad():
        on_train_graph = pred.model(g_train, adj_train)[:n].numpy()
    served = pred.predict()["target_hat"]
    assert np.abs(served - on_train_graph).max() > 1e-3


@pytest.mark.parametrize("method", ["blocked", "dense", "gather"])
def test_zoo_predictor_layouts(graph_npz, method):
    """A zoo model serves on the 256-row layout, the KT-GNN family on the
    128-row one; "auto" follows ``resolve_adjacency_method``; every method
    gives the same predictions (atol 1e-4)."""
    _, data, _ = graph_npz
    model = ts2.build_model(Stage2Config(model_name="GraphSAGE",
                                         hidden=HIDDEN), CLASSES, DIM, "cpu")
    auto = KTGNNPredictor(model, None, dict(data), device="cpu")
    pred = KTGNNPredictor(model, None, dict(data), adjacency_method=method,
                          device="cpu")
    assert (auto.adj.dense is not None) == (resolve_adjacency_method(
        "auto", auto.graph.num_nodes_padded) == "dense")
    if method == "blocked":
        assert pred.adj.fast_fn.lay_dst.node_block == 256
        no_dtc = ts2.build_model(Stage2Config(no_dtc=True, hidden=HIDDEN),
                                 CLASSES, DIM, "cpu")
        assert KTGNNPredictor(no_dtc, None, dict(data), adjacency_method=(
            "blocked"), device="cpu").adj.fast_fn.lay_dst.node_block == 128
    _assert_preds(pred.predict(), auto.predict())


def test_embeddings_are_ktgnn_only(graph_npz):
    _, data, _ = graph_npz
    model = ts2.build_model(Stage2Config(model_name="GraphSAGE",
                                         hidden=HIDDEN), CLASSES, DIM, "cpu")
    pred = KTGNNPredictor(model, None, dict(data), device="cpu")
    with pytest.raises(ValueError, match="GraphSAGENet has no node "
                                         "embeddings"):
        pred.embeddings()


def test_cli_flags_mirror_jax():
    """``--model_name`` (default KTGNN, any name) and ``--no_dtc`` parse as
    the JAX serving CLI's do."""
    for argv in ([], ["--model_name", "GCN", "--no_dtc"]):
        base = ["--mode", "predictor", "--ckpt", "c.pkl"] + argv
        a = tcli.build_argparser().parse_args(base)
        b = jcli.build_argparser().parse_args(base)
        assert (a.model_name, a.no_dtc) == (b.model_name, b.no_dtc)


# ------------------------------------------------------ the serving lock


class _BlockingPredictor:
    """A stub predictor: ``predict`` returns the feature version it has
    installed and, once ``block`` is set, waits for ``gate`` first."""

    device = torch.device("cpu")

    def __init__(self):
        self.version = 0
        self.block = False
        self.entered = threading.Event()
        self.gate = threading.Event()

    def predict(self):
        if self.block:
            self.entered.set()
            assert self.gate.wait(30)
        return {h: np.full((2, 2), float(self.version), np.float32)
                for h in HEADS}

    def update_features(self, x, nodes=None):
        self.version += 1


def test_cached_predict_waits_for_a_running_refresh():
    """A cached /v1/predict that arrives while /v1/refresh rebuilds the
    cache waits for it, then answers from the new features: it never
    answers the old predictions once the new features are installed."""
    stub = _BlockingPredictor()
    app = tcli.ServingApp(predictor=stub)
    stub.block = True
    refresh = threading.Thread(target=app.refresh, args=({"x": [[0.0]]},))
    refresh.start()
    assert stub.entered.wait(30)          # features installed, cache pending
    answers = []
    reader = threading.Thread(target=lambda: answers.append(
        app.predict({"log_probs": True})))
    reader.start()
    time.sleep(0.3)
    try:
        assert reader.is_alive() and not answers
    finally:
        stub.gate.set()
        refresh.join(30)
        reader.join(30)
    assert answers[0]["computed"] == "cache"
    assert answers[0]["log_probs"] == [[1.0, 1.0], [1.0, 1.0]]


# ------------------------------------------------------- the lean policy


@pytest.mark.parametrize("overrides", [
    dict(model_name="KTGNN_noDTC"), dict(model_name="GraphSAGE"),
    dict(no_dtc=True)], ids=["KTGNN_noDTC", "GraphSAGE", "no_dtc"])
def test_lean_on_a_single_head_model_warns(overrides):
    """An explicit "lean" for a model without KT-GNN's recompute runs
    plain, as in JAX, and says so; "auto" and "plain" stay silent."""
    with pytest.warns(UserWarning, match="memory_policy='lean'"):
        assert resolve_memory_policy(Stage2Config(
            memory_policy="lean", **overrides)) == "plain"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for policy in ("auto", "plain"):
            assert resolve_memory_policy(Stage2Config(
                memory_policy=policy, **overrides)) == "plain"
        assert resolve_memory_policy(Stage2Config(
            memory_policy="lean")) == "lean"
