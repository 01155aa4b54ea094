"""PyTorch port, row-sharded stage 1 (``Stage1Config(n_shards=2)``,
``parallel/gspmd.py``) on one gloo group of two CPU ranks, started once
for the module (``tests/torch_multidevice_worker.py::
stage1_rank_work``):

* one similarity step of v1 (SAGE encoder, cosine head) and v2 (MLP
  backbone, mlp head), dropout on, against the single-device step from
  the same weights, pairs and generator: the loss, every learner
  gradient and every batch-norm statistic at rtol 1e-5, atol 1e-6. This
  is the guard against counting a gradient once per rank;
* ``train_adversarial`` with the mlp and gnn backbones, at dropout 0
  from the JAX package's init, against the JAX package's ``n_shards=2``
  run (``tests/test_stage1_sharded.py``'s configuration, on the CPU mesh
  of ``tests/conftest.py``): every epoch's losses at rtol 1e-4, the same
  best epoch and its scores at rtol 1e-4, atol 1e-5;
* v1 in scan mode with host pairs (segments of 2) against its sharded
  loop, and the sharded loop against the single device's;
* both ranks alike; ``device_sampling`` refused with JAX's ``ValueError``;
  the stage-1 CLI with ``--n_shards 2`` is
  ``tests/test_torch_bridge.py::test_stage1_cli_trains_with_n_shards``;
* ``repad_graph_nodes`` changes no aggregation (JAX's check); the
  gather and dense adjacencies refuse a sender count they would ignore.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.data import dataset_conversion as j_conversion
from bridged_gnn_tpu.data.synthetic import make_sync_dataset as j_sync
from bridged_gnn_tpu.train import stage1 as js1

from bridged_gnn_tpu_torch.graph import graph_from_dict
from bridged_gnn_tpu_torch.io.flax_weights import state_dict_from_flax
from bridged_gnn_tpu_torch.ops.spmm import (
    adjacency_from_graph,
    build_adjacency,
    spmm,
)
from bridged_gnn_tpu_torch.parallel.gspmd import repad_graph_nodes
from bridged_gnn_tpu_torch.parallel.multihost import spawn
from bridged_gnn_tpu_torch.train import stage1 as ts1

from tests import torch_multidevice_worker as worker
from tests.test_torch_stage1 import (  # noqa: F401
    _cfg,
    _epoch_pairs,
    _record_jax_losses,
    domains,
    jax_init,
    no_dropout,
)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_CASES = {"v1": ("gnn", "cosine"), "v2": ("mlp", "mlp")}
# JAX tests/test_stage1_sharded.py's configuration and data
JCFG = dict(hidden_dim=8, num_epoch=4, start_eval_epoch=2, eval_per_epoch=2,
            sample_size=300, eval_sample_size=300, max_class_num=3,
            eval_mode="sampling", seed=0)
JAX_CASES = dict(
    mlp=dict(JCFG, backbone="mlp"),
    gnn=dict(JCFG, backbone="gnn", num_epoch=2, start_eval_epoch=1,
             eval_per_epoch=1))
SCAN = dict(backbone="gnn", sim_mode="cosine", scan_epochs=2, n_shards=2)


def jax_domains():
    data = j_sync("relational-intra", n_src=80, n_tar=60, dim=10,
                  num_classes=3, seed=7)
    return tuple(dict(d) for d in j_conversion(dict(data), seed=0)[:2])


def _kw(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def setup():
    """The JAX init of every JAX case (the port loads it) and the one
    step's pairs; computed before the ranks start."""
    src, tar = domains()
    jsrc, jtar = jax_domains()
    weights = {}
    for name, kw in JAX_CASES.items():
        cfg = ts1.Stage1Config(**kw)
        _, variables = jax_init(cfg, jsrc, jtar)
        model = ts1.build_model(cfg, jsrc, jtar, "cpu")
        weights[name] = {k: v.numpy() for k, v in state_dict_from_flax(
            model, variables).items()}
    idxs, y_pairs = _epoch_pairs(src, tar, _cfg("gnn", "cosine"))
    pairs = ({k: v.astype(np.int64) for k, v in idxs.items()}, y_pairs)
    return src, tar, jsrc, jtar, weights, pairs


@pytest.fixture(scope="module")
def ranks(setup):
    """Both ranks' results, pending: the ranks start in the background,
    so that each test computes its reference while they run and then
    waits for them (``ranks.result()``)."""
    src, tar, jsrc, jtar, weights, pairs = setup
    step_cases = {name: _kw(_cfg(*bs, n_shards=2))
                  for name, bs in STEP_CASES.items()}
    train_cases = dict(
        v1_scan=_kw(_cfg(**SCAN)),
        v1_loop=_kw(_cfg(**dict(SCAN, scan_epochs=0))))
    jax_cases = {name: dict(kw, n_shards=2)
                 for name, kw in JAX_CASES.items()}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, worker.stage1_rank_work, 2,
                          (src, tar, step_cases, pairs, train_cases,
                           weights, jsrc, jtar, jax_cases),
                          device_type="cpu", timeout_s=600)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_train_adversarial_matches_jax(no_dropout, monkeypatch,
                                               setup, ranks, case):
    *_, jsrc, jtar, _w, _p = setup
    seen = _record_jax_losses(monkeypatch)
    want = js1.train_adversarial(
        dict(jsrc), dict(jtar), js1.Stage1Config(**JAX_CASES[case],
                                                 n_shards=2))
    got, other = (out["jax"][case] for out in ranks.result())
    assert len(got["history"]) == len(seen) == JAX_CASES[case]["num_epoch"]
    for h, (loss, loss_d, loss_ae) in zip(got["history"], seen):
        for a, b in ((h["loss"], loss), (h["loss_d"], loss_d),
                     (h["loss_ae"], loss_ae)):
            assert a == pytest.approx(b, rel=1e-4), (h, seen)
    assert got["best"]["epoch"] == want["best"]["epoch"]
    for split in ("train", "val", "test"):
        np.testing.assert_allclose(
            np.asarray(got["best"][split], dtype=np.float64),
            np.asarray(want["best"][split], dtype=np.float64),
            rtol=1e-4, atol=1e-5, err_msg=split)
    assert other == got


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_counts_each_gradient_once(setup, ranks, case):
    src, tar, *_, pairs = setup
    cfg = _cfg(*STEP_CASES[case])
    G = ts1.prepare_stage1_graphs(src, tar, cfg.backbone, "cpu")
    model = ts1.build_model(cfg, src, tar, "cpu")
    idxs, y_pairs = pairs
    want = worker.one_sim_step(
        G, model, cfg, {k: torch.from_numpy(v) for k, v in idxs.items()},
        {k: torch.from_numpy(v) for k, v in y_pairs.items()})
    for out in ranks.result():
        got = out["step"][case]
        np.testing.assert_allclose(got["loss"], want["loss"], **STEP_TOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, err_msg=name,
                                       **STEP_TOL)
        for name, b in want["buffers"].items():
            np.testing.assert_allclose(got["buffers"][name], b,
                                       err_msg=name, **STEP_TOL)


def test_sharded_scan_matches_its_loop_and_one_device(ranks):
    """Host-sampled scan mode (segments 1-2, 3-4) against the sharded
    loop, and the loop against one device: the same losses and best."""
    single = ts1.train_adversarial(*domains(), _cfg(**dict(
        SCAN, scan_epochs=0, n_shards=1)), device="cpu")
    for out in ranks.result():
        scan, loop = out["train"]["v1_scan"], out["train"]["v1_loop"]
        assert scan["scan"]["capture"] == "none (gloo)"
        assert scan["scan"]["segments"] == [(1, 2), (3, 4)]
        assert scan["scan"]["captures"] == 0
        for a, b, c in zip(scan["history"], loop["history"],
                           single["history"]):
            for key in ("loss", "loss_d", "loss_ae"):
                assert a[key] == pytest.approx(b[key], rel=1e-4)
                assert b[key] == pytest.approx(c[key], rel=1e-4)
        assert scan["best"]["epoch"] == loop["best"]["epoch"] \
            == single["best"]["epoch"]
    a, b = ranks.result()
    assert a["train"] == b["train"]


def test_device_sampling_with_shards_raises():
    src, tar = domains()
    with pytest.raises(ValueError, match="n_shards"):
        ts1.train_adversarial(src, tar, _cfg(
            "mlp", "mlp", n_shards=2, scan_epochs=2, device_sampling=True),
            device="cpu")


def test_repad_graph_nodes_keeps_aggregation():
    rng = np.random.default_rng(1)
    n = 20
    g = graph_from_dict(dict(
        x=rng.normal(size=(n, 6)).astype(np.float32),
        edge_index=rng.integers(0, n, size=(2, 50)),
        y=rng.integers(0, 3, size=n)))
    g2 = repad_graph_nodes(g, 64)
    assert g2.num_nodes_padded % 64 == 0
    assert not g2.node_mask[g.num_nodes_padded:].any()
    assert (g2.y[g.num_nodes_padded:] == -1).all()
    for method in ("gather", "blocked"):
        out = spmm(adjacency_from_graph(g, method, device="cpu"), g.x)[:n]
        out2 = spmm(adjacency_from_graph(g2, method, device="cpu"),
                    g2.x)[:n]
        np.testing.assert_allclose(out2.numpy(), out.numpy(), rtol=1e-6)


@pytest.mark.parametrize("method", ["gather", "dense"])
def test_num_senders_refused_where_ignored(method):
    """A row shard's sender count keys only the slot layouts; the
    gather and dense adjacencies would drop it, so they refuse it."""
    s, r, em = np.array([0, 3, 2]), np.array([0, 0, 1]), np.ones(3, bool)
    with pytest.raises(ValueError, match="num_senders"):
        build_adjacency(s, r, em, 2, 2, method=method, device="cpu",
                        num_senders=4)
    blocked = build_adjacency(s, r, em, 2, 2, method="blocked",
                              device="cpu", num_senders=4)
    x = torch.arange(8.0).reshape(4, 2)
    np.testing.assert_allclose(spmm(blocked, x).numpy(),
                               [[6.0, 8.0], [4.0, 5.0]])
