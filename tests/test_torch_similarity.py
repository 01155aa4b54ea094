"""PyTorch port, similarity serving: ``serve.SimilarityScorer`` against
the JAX package's on the same stage-1 weights (exact top-k; mlp and
cosine heads, ``gnn`` and ``mlp`` backbones), its queries' padding and
companions, its top-k against the bridge's cross proposals, the
``--mode similarity`` loader on a merged corpus with a stage-1 pickle
and with a reference-layout ``.ckpt`` (either package's loader, the same
answers), and the HTTP ``/v1/topk`` surface with its guards.

Top-k indices must be equal but for named near-ties (positions whose
scores lie within NEAR_TIE of another candidate's, where f32 summation
order may swap them), values within 1e-5.
"""

import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.cli import serve as jcli
from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.serve import SimilarityScorer as JScorer

from bridged_gnn_tpu_torch.bridge import build as tbuild
from bridged_gnn_tpu_torch.cli import serve as tcli
from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.graph import graph_from_dict
from bridged_gnn_tpu_torch.io.ckpt_import import (
    reference_state_dict,
    save_torch_state_dict,
)
from bridged_gnn_tpu_torch.io.serialize import save_graph_npz
from bridged_gnn_tpu_torch.serve import SimilarityScorer
from bridged_gnn_tpu_torch.train import stage1 as ts1

from tests.test_torch_stage1 import (
    HIDDEN,
    VARIANTS,
    VARIANT_IDS,
    _cfg,
    _perturb_stats,
    domains,
    jax_init,
    port_model,
)

NEAR_TIE = 1e-5
VAL_ATOL = 1e-5


def assert_same_topk(got, want, near_tie=NEAR_TIE):
    """``(values, indices)`` equal: values within VAL_ATOL, and every
    index equal unless its position's score lies within ``near_tie`` of
    another score in the row (on either side), where the two sides may
    order or cut a near-tie apart. Returns the named near-ties: (row,
    position, got index, wanted index)."""
    (gv, gi), (wv, wi) = (tuple(np.asarray(a) for a in x)
                          for x in (got, want))
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, rtol=0, atol=VAL_ATOL)
    named = []
    for r, j in zip(*np.nonzero(gi != wi)):
        gap = np.abs(np.delete(wv[r], j) - wv[r, j]).min() \
            if wv.shape[1] > 1 else np.inf
        assert gap <= near_tie, (r, j, gi[r], wi[r], wv[r])
        named.append((int(r), int(j), int(gi[r, j]), int(wi[r, j])))
    return named


def _setup(backbone, sim_mode, seed=0):
    """The JAX model and flax variables (init, batch norms perturbed),
    the port model on those weights, and the source corpus."""
    src, tar = domains(seed=seed)
    cfg = _cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    variables = _perturb_stats(variables)
    return jmodel, variables, port_model(cfg, src, tar, variables), src, tar


@pytest.mark.parametrize("name,backbone,sim_mode", VARIANTS,
                         ids=VARIANT_IDS)
def test_scorer_matches_jax(name, backbone, sim_mode):
    """Exact top-k of 21 query rows (padded to 24, two row blocks of 16,
    as JAX lays them out) from the same weights: the JAX scorer's, for
    k = 1, 5 and every source."""
    jmodel, variables, model, src, tar = _setup(backbone, sim_mode)
    rng = np.random.default_rng(1)
    queries = rng.normal(size=(21, tar["x"].shape[1])).astype(np.float32)
    jsc = JScorer(jmodel, variables, j_graph_from_dict(src),
                  sim_mode=sim_mode, row_block=16)
    tsc = SimilarityScorer(model, None, graph_from_dict(src),
                           sim_mode=sim_mode, row_block=16, device="cpu")
    assert tsc.num_src == jsc.num_src == src["x"].shape[0]
    assert tsc.dim_in_tar == tar["x"].shape[1]
    for k in (1, 5, src["x"].shape[0]):
        got = tsc.topk_sources(queries, k)
        assert_same_topk(got, jsc.topk_sources(queries, k))
        assert got[0].dtype == np.float32 and got[1].dtype == np.int64
        assert (np.diff(got[0], axis=1) <= 0).all()


def test_scorer_with_the_queries_adjacency_matches_jax():
    """A ``gnn`` backbone with the queries' own adjacency (a graph among
    them) gives JAX's eager path's answers."""
    from bridged_gnn_tpu.graph import build_graph as j_build_graph
    from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj

    from bridged_gnn_tpu_torch.graph import build_graph
    from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph

    jmodel, variables, model, src, tar = _setup("gnn", "cosine")
    rng = np.random.default_rng(2)
    n = 13
    q = rng.normal(size=(n, tar["x"].shape[1])).astype(np.float32)
    ei = np.stack([rng.integers(0, n, 30), rng.integers(0, n, 30)])
    jsc = JScorer(jmodel, variables, j_graph_from_dict(src),
                  sim_mode="cosine", row_block=8)
    tsc = SimilarityScorer(model, None, graph_from_dict(src),
                           sim_mode="cosine", row_block=8, device="cpu")
    want = jsc.topk_sources(q, 4, adj_tar=j_adj(j_build_graph(q, ei)))
    got = tsc.topk_sources(q, 4, adj_tar=adjacency_from_graph(
        build_graph(q, ei), "auto", device="cpu"))
    assert_same_topk(got, want)


@pytest.mark.parametrize("backbone,sim_mode", [("mlp", "mlp"),
                                               ("gnn", "cosine")])
def test_scorer_padding_invariance(backbone, sim_mode):
    """A row's answer does not depend on its batch's padding or
    companions: row 3 of 11 (padded to 16) against it alone (padded to
    8), and 9 rows in row blocks of 4 against one block."""
    _, _, model, src, tar = _setup(backbone, sim_mode)
    q = np.random.default_rng(3).normal(
        size=(11, tar["x"].shape[1])).astype(np.float32)
    tsc = SimilarityScorer(model, None, graph_from_dict(src),
                           sim_mode=sim_mode, row_block=16, device="cpu")
    v_all, i_all = tsc.topk_sources(q, 4)
    v_one, i_one = tsc.topk_sources(q[3:4], 4)
    np.testing.assert_array_equal(i_all[3], i_one[0])
    np.testing.assert_allclose(v_all[3], v_one[0], rtol=1e-6)
    small = SimilarityScorer(model, None, graph_from_dict(src),
                             sim_mode=sim_mode, row_block=4, device="cpu")
    assert_same_topk(small.topk_sources(q[:9], 4), tsc.topk_sources(q[:9],
                                                                      4))


def test_scorer_top_k_is_the_bridges_cross_top_k():
    """With the ``mlp`` backbone a query encoded as an isolated node is
    the target graph's own encode, so the scorer's top-k of the target's
    rows is the bridge's cross proposals for them."""
    _, _, model, src, tar = _setup("mlp", "mlp")
    G = ts1.prepare_stage1_graphs(src, tar, "mlp", "cpu")
    ei, sims, *_ = tbuild.propose_cross_edges(model, G.g_src, None, G.g_tar,
                                              None, 6, row_block=16,
                                              sim_mode="mlp")
    n_tar = tar["x"].shape[0]
    tsc = SimilarityScorer(model, None, graph_from_dict(src),
                           sim_mode="mlp", row_block=16, device="cpu")
    got = tsc.topk_sources(tar["x"], 6)
    assert_same_topk(got, (sims, ei[0].reshape(n_tar, 6)))


def test_scorer_refuses_a_bad_recall_and_defaults_to_the_card(monkeypatch):
    _, _, model, src, _ = _setup("mlp", "mlp")
    with pytest.raises(ValueError, match="approx_recall"):
        SimilarityScorer(model, None, graph_from_dict(src),
                         approx_recall=95, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SimilarityScorer(model, None, graph_from_dict(src))


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def corpus_files(tmp_path_factory):
    """A merged sync graph as the corpus npz, and one model's weights as
    a stage-1 flax pickle and as a reference-layout torch ``.ckpt``."""
    tmp = tmp_path_factory.mktemp("similarity")
    data = make_sync_dataset("relational-intra", n_src=60, n_tar=45,
                             dim=10, num_classes=3, avg_degree=4, seed=0)
    npz = os.path.join(tmp, "corpus.npz")
    save_graph_npz(npz, data)
    src, tar, _, _ = dataset_conversion(data, seed=0)
    cfg = _cfg("mlp", "mlp")
    _, variables = jax_init(cfg, src, tar)
    variables = _perturb_stats(variables)
    pkl = os.path.join(tmp, "model_AdvLearner_best.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(variables, f)
    ref = os.path.join(tmp, "model_AdvLearner_best.ckpt")
    model = port_model(cfg, src, tar, variables)
    save_torch_state_dict(reference_state_dict(model), ref)
    return npz, pkl, ref, src


def _args(cli, ckpt, npz, *extra):
    return cli.build_argparser().parse_args(
        ["--mode", "similarity", "--ckpt", ckpt, "--corpus", npz,
         "--hidden_dim", str(HIDDEN), "--row_block", "16", *extra])


@pytest.mark.parametrize("which", ["pickle", "ckpt"])
def test_cli_loads_the_scorer_as_jax(corpus_files, which):
    """Both CLIs' ``_load_scorer`` on the same merged corpus and
    checkpoint (the stage-1 ``--save`` pickle, or the reference layout
    the stage-1 CLI's ``--export_torch_ckpt`` writes) answer /v1/topk
    alike; the meta says similarity."""
    npz, pkl, ref, src = corpus_files
    ckpt = pkl if which == "pickle" else ref
    japp = jcli._load_scorer(_args(jcli, ckpt, npz))
    tapp = tcli._load_scorer(_args(tcli, ckpt, npz, "--device", "cpu"))
    assert tapp.meta["mode"] == "similarity"
    assert tapp.meta["num_src"] == japp.meta["num_src"] == src["x"].shape[0]
    assert tapp.meta["dim_query"] == japp.meta["dim_query"]
    q = np.random.default_rng(4).normal(size=(7, 10)).astype(np.float32)
    body = {"x": q.tolist(), "k": 5}
    got, want = tapp.topk(body), japp.topk(body)
    assert_same_topk((got["values"], got["indices"]),
                     (want["values"], want["indices"]))


def test_cli_similarity_needs_a_corpus():
    args = tcli.build_argparser().parse_args(
        ["--mode", "similarity", "--ckpt", "x.pkl", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--corpus"):
        tcli.main(args)


# ------------------------------------------------------------ HTTP


def _call(port, path, body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_topk_and_its_guards(corpus_files):
    """Over HTTP: /healthz, /meta and /v1/topk answer 200 (the scorer's
    top-k); a payload that is no 2-D array, rows of the wrong width and
    a k outside [1, sources] answer 400; more rows than max_query_rows
    and a body past max_request_bytes 413; /v1/predict 404 (no
    predictor)."""
    npz, pkl, _, src = corpus_files
    app = tcli._load_scorer(_args(tcli, pkl, npz, "--device", "cpu",
                                  "--max_query_rows", "4",
                                  "--max_request_bytes", "20000"))
    srv = tcli.make_server(app)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        assert _call(port, "/healthz") == (200, {"status": "ok",
                                                 "backend": "cpu"})
        code, meta = _call(port, "/meta")
        assert code == 200 and meta["mode"] == "similarity"
        q = np.random.default_rng(5).normal(size=(3, 10)).astype(np.float32)
        code, out = _call(port, "/v1/topk", {"x": q.tolist(), "k": 2})
        assert code == 200
        want = app.scorer.topk_sources(q, 2)
        assert out["indices"] == want[1].tolist()
        n = src["x"].shape[0]
        for body, code, text in (
                ({"x": [1.0, 2.0], "k": 2}, 400, "2-D"),
                ({"x": [[0.0] * 5], "k": 2}, 400, "dim"),
                ({"x": [[0.0] * 10], "k": 0}, 400, "'k'"),
                ({"x": [[0.0] * 10], "k": n + 1}, 400, "'k'"),
                ({"x": [[0.0] * 10] * 5, "k": 1}, 413, "query rows")):
            got = _call(port, "/v1/topk", body)
            assert got[0] == code and text in got[1]["error"], (body, got)
        code, err = _call(port, "/v1/topk", raw=b" " * 30000)
        assert code == 413 and "byte limit" in err["error"]
        assert _call(port, "/v1/predict", {})[0] == 404
        assert _call(port, "/v1/refresh", {"x": [[0.0]]})[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not th.is_alive()
