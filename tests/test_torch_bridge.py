"""PyTorch port, the bridge build and the stage-1 CLI against the JAX
package on the same inputs: the blocked top-k (ties to the lower column,
as ``lax.top_k``), the pair-MLP head in column chunks and the two-phase
rerank; the four cross filters and the within filters; merge, reorder
and the domain split; ``gen_bridged_graph`` for v1 (cosine head) and v2
(mlp head), with and without ``reference_compat`` and the rerank, from
the same weights; the npz the port writes, read by the JAX loader; the
stage-1 CLI on the CPU feeding the stage-2 CLI; the refused options.
"""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.bridge import build as jbuild
from bridged_gnn_tpu.graph import merge_graphs_np as j_merge
from bridged_gnn_tpu.graph import reorder_np as j_reorder
from bridged_gnn_tpu.io.serialize import load_graph_npz as j_load_npz
from bridged_gnn_tpu.ops import sddmm as jsd

from bridged_gnn_tpu_torch.bridge import build as tbuild
from bridged_gnn_tpu_torch.cli import main_bridged_graph as s1cli
from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as s2cli
from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.graph import merge_graphs_np, reorder_np
from bridged_gnn_tpu_torch.io.serialize import save_graph_npz
from bridged_gnn_tpu_torch.ops import sddmm as tsd
from bridged_gnn_tpu_torch.train import stage1 as ts1

from tests.test_torch_stage1 import (
    _cfg,
    _perturb_stats,
    jax_graphs,
    jax_init,
    port_model,
)

VAL_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same_topk(got, want, n_rows):
    vals, idxs = (np.asarray(a)[:n_rows] for a in want)
    np.testing.assert_array_equal(got[1].numpy(), idxs)
    np.testing.assert_allclose(got[0].numpy(), vals, rtol=0, atol=VAL_ATOL)


# ------------------------------------------------------------------ top-k


@pytest.mark.parametrize("masked", [False, True])
def test_blockwise_topk_matches_jax_ties_included(masked):
    """Cosine scores of rows with exact duplicates (every tie there is
    exact) and integer scores (most of a row tied): the same columns in
    the same order, values within 1e-6; a column mask scores -1e30."""
    rng = np.random.default_rng(0)
    z_cols = rng.normal(size=(37, 8)).astype(np.float32)
    z_cols[20:30] = z_cols[3]                   # ten duplicates of one row
    z_rows = np.concatenate([z_cols[:12], rng.normal(size=(9, 8))]
                            ).astype(np.float32)
    col_mask = (np.arange(37) % 5 != 2) if masked else None
    jfn = jsd.cosine_score_block(jnp.asarray(z_rows), jnp.asarray(z_cols))
    tfn = tsd.cosine_score_block(_t(z_rows), _t(z_cols))
    for k in (1, 6, 15):
        want = jsd.blockwise_pair_scores_topk(
            jfn, 21, 37, k, row_block=8, col_mask=None if col_mask is None
            else jnp.asarray(col_mask))
        got = tsd.blockwise_pair_scores_topk(
            tfn, 21, 37, k, row_block=8, col_mask=None if col_mask is None
            else _t(col_mask))
        assert_same_topk(got, want, 21)
    ints = rng.integers(0, 3, size=(21, 37)).astype(np.float32)
    want = jsd.blockwise_pair_scores_topk(
        lambda i: jnp.asarray(ints)[i], 21, 30, 9, row_block=8)
    got = tsd.blockwise_pair_scores_topk(lambda i: _t(ints)[i], 21, 30, 9,
                                         row_block=8)
    assert_same_topk(got, want, 21)


def _mlp_head(rng, r=23, c=41, h=12):
    return (rng.normal(size=(r, h)).astype(np.float32),
            rng.normal(size=(c, h)).astype(np.float32),
            rng.normal(size=h).astype(np.float32),
            rng.normal(size=h).astype(np.float32), 0.25)


def test_pair_mlp_head_and_rerank_match_jax(monkeypatch):
    """The pair-MLP head over column chunks (a chunk of 5 columns here)
    and the two-phase rerank (a bf16 cosine screen of 7 candidates, the
    exact head there) give JAX's top-k."""
    rng = np.random.default_rng(1)
    a, b, bias, w2, b2 = _mlp_head(rng)
    monkeypatch.setattr(tsd, "PAIR_CHUNK_BYTES", 4 * 8 * 12 * 5)
    jhead = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
             jnp.asarray(w2), jnp.asarray(np.float32(b2)))
    thead = (_t(a), _t(b), _t(bias), _t(w2), b2)
    for k in (1, 4):
        want = jsd.blockwise_pair_scores_topk(
            jsd.pair_mlp_score_block(*jhead), 23, 41, k, row_block=8)
        got = tsd.blockwise_pair_scores_topk(
            tsd.pair_mlp_score_block(*thead), 23, 41, k, row_block=8)
        assert_same_topk(got, want, 23)
    za = rng.normal(size=(23, 12)).astype(np.float32)
    zb = rng.normal(size=(41, 12)).astype(np.float32)
    zb[30:] = zb[2]                             # ties in the screen
    for cand in (7, 41):
        want = jsd.blockwise_rerank_topk(
            jsd.cosine_score_block(jnp.asarray(za, jnp.bfloat16),
                                   jnp.asarray(zb, jnp.bfloat16)),
            jsd.mlp_score_candidates(*jhead), 23, 41, 4, candidates=cand,
            row_block=8, approx_recall=None)
        got = tsd.blockwise_rerank_topk(
            tsd.cosine_score_block(_t(za).bfloat16(), _t(zb).bfloat16()),
            tsd.mlp_score_candidates(*thead), 23, 41, 4, candidates=cand,
            row_block=8)
        assert_same_topk(got, want, 23)
    with pytest.raises(ValueError, match="candidates"):
        tsd.blockwise_rerank_topk(None, None, 3, 3, 4, candidates=2)
    with pytest.raises(ValueError, match="percentage"):
        tsd.blockwise_pair_scores_topk(None, 3, 3, 1, approx_recall=95)


# ---------------------------------------------------------------- filters


def test_validity_filters_match_jax():
    rng = np.random.default_rng(2)
    n_s, n_t, k = 40, 30, 4
    ei = np.stack([rng.integers(0, n_s, n_t * k),
                   np.repeat(np.arange(n_t), k)])
    sims = rng.random((n_t, k)).astype(np.float32)
    args = (rng.integers(0, 3, n_s), rng.integers(0, 3, n_t),
            rng.normal(size=(n_s, 6)).astype(np.float32),
            rng.normal(size=(n_t, 6)).astype(np.float32),
            rng.random(n_t) < 0.5, rng.random((n_s, 3)), rng.random((n_t, 3)))
    for q, f in ((0.1, 0.0), (0.3, -0.2)):
        np.testing.assert_array_equal(
            tbuild.check_cross_validity(ei, sims, *args, q, f),
            jbuild.check_cross_validity(ei, sims, *args, q, f))
    ew = np.stack([rng.integers(0, n_s, n_s * k),
                   np.repeat(np.arange(n_s), k)])
    x = rng.normal(size=(n_s, 4)).astype(np.float32)
    x[::3] = x[0]
    wargs = (ew, rng.random((n_s, k)).astype(np.float32),
             rng.integers(0, 3, n_s), x, rng.random(n_s) < 0.5,
             rng.random((n_s, 3)))
    for q, f in ((0.1, 0.8), (0.2, 0.0)):
        np.testing.assert_array_equal(
            tbuild.check_within_validity(*wargs, q, f),
            jbuild.check_within_validity(*wargs, q, f))


def test_merge_and_reorder_match_jax():
    data = make_sync_dataset("relational-intra", n_src=30, n_tar=25, dim=4,
                             num_classes=3, seed=3)
    src, tar, m_src, m_tar = dataset_conversion(data, seed=0)
    src["central_mask"] = np.ones(30, bool)
    tar["central_mask"] = np.zeros(25, bool)
    rng = np.random.default_rng(3)
    cross = np.stack([rng.integers(0, 30, 50), rng.integers(0, 25, 50)])
    ws = np.stack([rng.integers(0, 30, 20), rng.integers(0, 30, 20)])
    wt = np.stack([rng.integers(0, 25, 20), rng.integers(0, 25, 20)])
    for within in ((None, None), (ws, wt)):
        got = merge_graphs_np(src, tar, cross.copy(), *within)
        want = j_merge(src, tar, cross.copy(), *within)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
        a, b = reorder_np(got, 30, m_src, m_tar), j_reorder(want, 30, m_src,
                                                            m_tar)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], k)


# ---------------------------------------------------------- the whole build


BUILDS = [("v1", "gnn", "cosine", False, None),
          ("v1_compat", "gnn", "cosine", True, None),
          ("v2", "mlp", "mlp", False, None),
          ("v2_compat", "mlp", "mlp", True, None),
          ("v2_rerank", "mlp", "mlp", False, 9),
          ("v2_compat_rerank", "mlp", "mlp", True, 9)]


@pytest.mark.parametrize("name,backbone,sim_mode,compat,rerank", BUILDS,
                         ids=[b[0] for b in BUILDS])
def test_gen_bridged_graph_matches_jax(tmp_path, name, backbone, sim_mode,
                                       compat, rerank):
    """The bridged dict from the same weights equals the JAX package's,
    and the npz the port writes of it is what the JAX loader reads."""
    data = make_sync_dataset("relational-intra", n_src=60, n_tar=45,
                             dim=10, num_classes=3, avg_degree=4, seed=0)
    src, tar, m_src, m_tar = dataset_conversion(data, seed=0)
    cfg = _cfg(backbone, sim_mode)
    jmodel, variables = jax_init(cfg, src, tar)
    variables = _perturb_stats(variables)
    model = port_model(cfg, src, tar, variables)
    gs, adj_s, gt, adj_t = jax_graphs(src, tar, backbone)
    G = ts1.prepare_stage1_graphs(src, tar, backbone, "cpu")
    kw = dict(k_cross=6, k_within=3, check_cross=True, check_within=True,
              thres_feat_sim=-0.5, sim_mode=sim_mode, row_block=16,
              rerank_candidates=rerank, reference_compat=compat)
    want = jbuild.gen_bridged_graph(jmodel, variables, gs, adj_s, gt, adj_t,
                                    m_src, m_tar, **kw)
    timings = {}
    got = tbuild.gen_bridged_graph(model, G.g_src, G.adj_src, G.g_tar,
                                   G.adj_tar, m_src, m_tar, timings=timings,
                                   **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)
    assert set(timings) == {"encode", "cross_topk", "within_source",
                            "within_target", "filters_merge"}
    path = os.path.join(tmp_path, "g.npz")
    save_graph_npz(path, got)
    back = j_load_npz(path)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], k)


# ------------------------------------------------------------------- CLIs


def test_stage1_cli_feeds_the_stage2_cli(tmp_path):
    """``run.sh`` recipe 0's two steps through the port's CLIs on the CPU,
    cut to 4 stage-1 epochs and 2 stage-2 epochs: the stage-1 CLI writes
    the checkpoint, the reference-layout export, the profiler trace and
    the npz; the stage-2 CLI trains on the npz."""
    out, ck = os.path.join(tmp_path, "out"), os.path.join(tmp_path, "ck")
    ref = os.path.join(tmp_path, "ref.ckpt")
    argv = ["--dataset_name", "sync_unrelational", "--k_within", "3",
            "--k_cross", "10", "--num_epoch", "4", "--start_eval_epoch", "2",
            "--eval_per_epoch", "2", "--seed", "0", "--version", "v2",
            "--save", "--out_dir", out, "--ckpt_dir", ck,
            "--export_torch_ckpt", ref, "--device", "cpu",
            "--profile_dir", os.path.join(tmp_path, "prof")]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        merged = s1cli.main(s1cli.build_argparser().parse_args(argv))
    assert "[stage-1 best]" in text.getvalue()
    npz = os.path.join(out, "sync_unrelational_bridged_graph.npz")
    assert os.path.isfile(os.path.join(
        ck, "model_AdvLearner_sync_unrelational_best.pkl"))
    assert os.path.isfile(ref)
    assert os.path.isfile(os.path.join(tmp_path, "prof", "trace.json"))
    assert merged["x"].shape[0] == 3500
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        res = s2cli.main(s2cli.build_argparser().parse_args(
            ["--num_layer", "2", "--hidden_dim", "64", "--to_undirected",
             "--path_data", npz, "--num_epoch", "2", "--device", "cpu"]))
    assert "[stage-2 best]" in text.getvalue()
    assert np.all(np.isfinite([h["loss"] for h in res["history"]]))


@pytest.mark.parametrize("flags", [["--scan_epochs", "2"],
                                   ["--scan_epochs", "2",
                                    "--device_sampling"]],
                         ids=["scan", "device_sampling"])
def test_stage1_cli_runs_scan_options(tmp_path, flags):
    """The stage-1 CLI trains with ``--scan_epochs`` (and
    ``--device_sampling``) on the CPU and builds the bridged graph; its
    segment lines follow the evaluation epochs."""
    argv = ["--dataset_name", "sync_unrelational", "--k_within", "3",
            "--k_cross", "5", "--num_epoch", "4", "--start_eval_epoch", "2",
            "--eval_per_epoch", "2", "--version", "v2", "--hidden_dim", "16",
            "--out_dir", str(tmp_path), "--ckpt_dir", str(tmp_path),
            "--device", "cpu", "--save"] + flags
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        merged = s1cli.main(s1cli.build_argparser().parse_args(argv))
    out = text.getvalue()
    assert "[rep 0] epochs 1-2 " in out and "[rep 0] epochs 3-4 " in out
    assert "[stage-1 best]" in out
    assert merged["x"].shape[0] == 3500
    with pytest.raises(ValueError, match="scan_epochs"):
        s1cli.main(s1cli.build_argparser().parse_args(
            ["--device_sampling", "--device", "cpu"]))


@pytest.mark.parametrize("flags,item", [(["--n_shards", "2"], "item 9")])
def test_stage1_cli_trains_with_n_shards(tmp_path, flags, item):
    """``--n_shards 2`` (ROADMAP Queue 1 ``item``) trains: the CLI
    starts two gloo ranks for stage 1 (v1, rows sharded), then builds
    and saves the bridged graph from rank 0's best weights."""
    args = s1cli.build_argparser().parse_args(
        ["--dataset_name", "sync_unrelational", "--device", "cpu",
         "--k_within", "2", "--k_cross", "4", "--num_epoch", "2",
         "--start_eval_epoch", "2", "--eval_per_epoch", "2",
         "--hidden_dim", "16", "--out_dir", str(tmp_path), "--ckpt_dir",
         str(tmp_path), "--save", "--verbose"] + flags)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        merged = s1cli.main(args)
    out = text.getvalue()
    assert "[stage-1 best]" in out and "saved bridged graph" in out
    assert merged["x"].shape[0] == 3500
    assert (tmp_path / "model_AdvLearner_sync_unrelational_best.pkl"
            ).is_file()


def test_stage1_cli_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = s1cli.build_argparser().parse_args(
        ["--dataset_name", "sync_unrelational"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        s1cli.main(args)
