"""PyTorch port, the sharded bridge top-k (``parallel/topk.py``) on one
gloo group of two CPU ranks, started once for the module
(``tests/torch_multidevice_worker.py::topk_rank_work``):

* ``sharded_pair_topk`` for the cosine head, the mlp head and the mlp
  head with its rerank, with ``num_cols % 2 != 0`` and ``k`` above a
  shard's columns, against the JAX package's ``sharded_pair_topk`` on a
  2-device CPU mesh: values at 1e-6, the same columns;
* the cosine and mlp cases also against the port's single-device top-k
  (the inputs are seeded, so there are no near-ties);
* ``gen_bridged_graph(mesh=group)`` for v1 and v2 giving the
  single-device edge set, on both ranks alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.parallel.mesh import make_mesh as j_make_mesh
from bridged_gnn_tpu.parallel.topk import sharded_pair_topk as j_topk

from bridged_gnn_tpu_torch.bridge import build as tbuild
from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset
from bridged_gnn_tpu_torch.ops import sddmm as tsd
from bridged_gnn_tpu_torch.parallel.multihost import spawn
from bridged_gnn_tpu_torch.train import stage1 as ts1

from tests import torch_multidevice_worker as worker
from tests.test_torch_stage1 import _cfg

ROWS, COLS, H, ROW_BLOCK = 19, 27, 12, 8
VAL_ATOL = 1e-6
# (mode, k, rerank candidates): k = 16 is above a shard's 14 columns
CASES = {"cosine": ("cosine", 16, None), "mlp": ("mlp", 5, None),
         "mlp_k16": ("mlp", 16, None), "mlp_rerank": ("mlp", 4, 6)}
BUILD_KW = dict(k_cross=6, k_within=3, check_cross=True, check_within=True,
                thres_feat_sim=-0.5, row_block=16)
BUILDS = {"v1": ("gnn", "cosine"), "v2": ("mlp", "mlp")}


def _inputs(mode, k, rerank):
    rng = np.random.default_rng(COLS + k)
    arrays = dict(a_rows=rng.normal(size=(ROWS, H)).astype(np.float32),
                  b_cols=rng.normal(size=(COLS, H)).astype(np.float32))
    kw = dict(num_rows=ROWS, num_cols=COLS, k=k, mode=mode,
              row_block=ROW_BLOCK)
    if mode == "mlp":
        arrays.update(mlp_bias1=rng.normal(size=H).astype(np.float32),
                      mlp_w2=rng.normal(size=H).astype(np.float32))
        kw["mlp_b2"] = 0.25
    if rerank is not None:
        arrays.update(z_rows=rng.normal(size=(ROWS, 7)).astype(np.float32),
                      z_cols=rng.normal(size=(COLS, 7)).astype(np.float32))
        kw["rerank_candidates"] = rerank
    return arrays, kw


def _bridge_inputs():
    data = make_sync_dataset("relational-intra", n_src=60, n_tar=45,
                             dim=10, num_classes=3, avg_degree=4, seed=0)
    src, tar, m_src, m_tar = dataset_conversion(data, seed=0)
    builds = {}
    for name, (backbone, sim_mode) in BUILDS.items():
        cfg = _cfg(backbone, sim_mode)
        model = ts1.build_model(cfg, src, tar, "cpu", seed=3)
        kw = dict(BUILD_KW, sim_mode=sim_mode)
        builds[name] = (dict(backbone=backbone, sim_mode=sim_mode,
                             hidden_dim=cfg.hidden_dim),
                        {k: v.numpy() for k, v in
                         model.state_dict().items()}, kw)
    return src, tar, m_src, m_tar, builds


@pytest.fixture(scope="module")
def ranks():
    cases = {name: _inputs(*c) for name, c in CASES.items()}
    return spawn(worker.topk_rank_work, 2, (cases, _bridge_inputs()),
                 device_type="cpu", timeout_s=600)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1])[:ROWS])
    np.testing.assert_allclose(got[0], np.asarray(want[0])[:ROWS], rtol=0,
                               atol=VAL_ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_topk_matches_jax(ranks, case):
    arrays, kw = _inputs(*CASES[case])
    pad = -(-ROWS // ROW_BLOCK) * ROW_BLOCK - ROWS

    def j(a, rows=False):
        a = np.asarray(a)
        if rows:
            a = np.pad(a, ((0, pad), (0, 0)))
        return jnp.asarray(a)

    jarr = {k: j(v, rows=k in ("a_rows", "z_rows"))
            for k, v in arrays.items()}
    if "mlp_b2" in kw:
        kw = dict(kw, mlp_b2=jnp.asarray(np.float32(kw["mlp_b2"])))
    want = j_topk(j_make_mesh(2), **jarr, **kw)
    for out in ranks:
        _assert_same(out["topk"][case], want)
    assert (ranks[0]["topk"][case][1] == ranks[1]["topk"][case][1]).all()


@pytest.mark.parametrize("case", ["cosine", "mlp", "mlp_k16"])
def test_sharded_topk_matches_single_device(ranks, case):
    arrays, kw = _inputs(*CASES[case])
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if kw["mode"] == "cosine":
        fn = tsd.cosine_score_block(t["a_rows"], t["b_cols"])
    else:
        fn = tsd.pair_mlp_score_block(t["a_rows"], t["b_cols"],
                                      t["mlp_bias1"], t["mlp_w2"],
                                      kw["mlp_b2"])
    vals, idxs = tsd.blockwise_pair_scores_topk(
        fn, ROWS, COLS, kw["k"], row_block=ROW_BLOCK)
    for out in ranks:
        _assert_same(out["topk"][case], (vals.numpy(), idxs.numpy()))


@pytest.mark.parametrize("name", list(BUILDS))
def test_gen_bridged_graph_with_mesh_gives_the_single_device_edges(
        ranks, name):
    src, tar, m_src, m_tar, builds = _bridge_inputs()
    cfg_kw, state, kw = builds[name]
    cfg = ts1.Stage1Config(**cfg_kw)
    model = ts1.build_model(cfg, src, tar, "cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state.items()})
    G = ts1.prepare_stage1_graphs(src, tar, cfg.backbone, "cpu")
    want = tbuild.gen_bridged_graph(model, G.g_src, G.adj_src, G.g_tar,
                                    G.adj_tar, m_src, m_tar, **kw)
    for out in ranks:
        got = out["bridge"][name]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)


def test_sharded_topk_refuses_rerank_without_embeddings():
    """JAX's ``ValueError``, before any collective (no group needed)."""
    from bridged_gnn_tpu_torch.parallel.topk import sharded_pair_topk

    with pytest.raises(ValueError, match="rerank_candidates"):
        sharded_pair_topk(None, torch.zeros(2, 3), torch.zeros(4, 3), 2, 4,
                          1, mode="cosine", rerank_candidates=2)
