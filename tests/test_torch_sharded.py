"""PyTorch port, multi-device stage 2 (``parallel/*``) on one gloo group
of two CPU ranks, started once for the module
(``tests/torch_sharded_worker.py`` runs every case on both ranks):

* one train step of each sharded backend — KTGNN on the halo layout, its
  overlap form, a smaller slot block, with the embedding conv recomputed
  in the backward (``memory_policy="lean"``, with and without
  ``halo_overlap``: lean runs the plain halo form, as in JAX) and on the
  edge-shard layout, and KTGNN_noDTC on the halo layout — against the
  single-device step: loss, every parameter's gradient and the BN
  statistics at rtol 1e-5, atol 1e-6;
* three epochs of ``train_ktgnn(n_shards=2)`` — KTGNN on the halo
  layout, its overlap form and the edge-shard layout, KTGNN_noDTC on the
  halo layout — and six of KTGNN on the halo layout and in its overlap
  form in scan mode (``scan_epochs=3``) against the JAX package's
  ``n_shards=2`` run of the same layout on the CPU mesh of
  ``tests/conftest.py``, from the port's seeded init: losses at rtol
  1e-4, the same best epoch;
* parameters and BN statistics bit-identical on both ranks;
* the edge-shard SpMM against one segment sum;
* the training CLI with ``--n_shards 2``, starting its own two ranks or
  under torchrun;
* importing ``bridged_gnn_tpu_torch.parallel`` loads no JAX.

Dropout is 0 throughout."""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.nn.ktgnn import KTGNN as JKTGNN
from bridged_gnn_tpu.nn.ktgnn import KTGNNNoDTC as JKTGNNNoDTC
from bridged_gnn_tpu.train import stage2 as js2

from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as tcli
from bridged_gnn_tpu_torch.io.flax_weights import (
    flax_variables_from_state_dict,
)
from bridged_gnn_tpu_torch.io.serialize import save_graph_npz
from bridged_gnn_tpu_torch.parallel.edgeshard import (
    pad_graph_edges_for_sharding,
)
from bridged_gnn_tpu_torch.parallel.multihost import backend_for, spawn
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    check_ported,
    prepare_stage2_graph,
    train_ktgnn,
    train_step,
)

from tests import torch_sharded_worker as worker
from tests.test_torch_graph import sync_data

BASE = dict(hidden=8, dropout=0.0, log_every=0, n_shards=2)
# the conv prologue's wrappers (ops/conv_prologue.py), which every form
# of an AdaptedConv calls
PROLOGUE = {"conv_prologue_pass", "conv_prologue_finish",
            "conv_prologue_epilogue", "conv_prologue_bwd",
            "conv_prologue_bwd_finish", "conv_prologue_dx"}
STEP_CASES = dict(
    halo=dict(BASE),
    overlap=dict(BASE, halo_overlap=True),
    halo_block32=dict(BASE, halo_node_block=32),
    halo_lean=dict(BASE, memory_policy="lean"),
    overlap_lean=dict(BASE, halo_overlap=True, memory_policy="lean"),
    edgeshard=dict(BASE, shard_layout="edgeshard"),
    nodtc_halo=dict(BASE, model_name="KTGNN_noDTC"),
)
TRAIN = dict(BASE, num_epoch=3, lr=1e-2)
TRAIN_CASES = dict(
    halo=dict(TRAIN),
    overlap=dict(TRAIN, halo_overlap=True),
    edgeshard=dict(TRAIN, shard_layout="edgeshard"),
    nodtc_halo=dict(TRAIN, model_name="KTGNN_noDTC"),
    halo_scan=dict(TRAIN, num_epoch=6, scan_epochs=3),
    overlap_scan=dict(TRAIN, num_epoch=6, scan_epochs=3, halo_overlap=True),
)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _data():
    return sync_data(dim=12, num_classes=3)


@pytest.fixture(scope="module")
def ranks_pending():
    """One spawn of both ranks for every case, started in the background
    so that the JAX runs of the first tests overlap it."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, worker.rank_work, 2,
                          (_data(), STEP_CASES, TRAIN, TRAIN_CASES),
                          device_type="cpu", timeout_s=600)


@pytest.fixture(scope="module")
def ranks(ranks_pending):
    """Both ranks' results of every case."""
    return ranks_pending.result()


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_sharded_train_matches_jax(ranks_pending, monkeypatch, case):
    """Both packages' n_shards=2 runs of one layout and model from the
    port's seeded init (carried to flax by io/flax_weights.py)."""
    kw = TRAIN_CASES[case]
    data = _data()
    cfg = Stage2Config(**kw)
    g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
    init = build_model(cfg, g.num_classes, g.num_features, "cpu")
    variables = flax_variables_from_state_dict(init, init.state_dict())
    for cls in (JKTGNN, JKTGNNNoDTC):
        monkeypatch.setattr(cls, "init", lambda self, *a, **k: variables)
    jres = js2.train_ktgnn(data, js2.Stage2Config(**kw))
    port = ranks_pending.result()[0]["train"][case]
    assert [h["epoch"] for h in port["history"]] == \
        [h["epoch"] for h in jres["history"]] == \
        list(range(1, kw["num_epoch"] + 1))
    for hp, hj in zip(port["history"], jres["history"]):
        for key in ("loss", "loss_t2"):
            assert hp[key] == pytest.approx(hj[key], rel=1e-4), hp["epoch"]
    assert port["best"]["epoch"] == jres["best"]["epoch"]
    assert port["parallel"]["layout"] == kw.get("shard_layout", "halo")


def _single_step(kw):
    cfg = Stage2Config(**dict(kw, n_shards=1, adjacency_method="blocked"))
    g, adj = prepare_stage2_graph(_data(), cfg, "cpu")
    model = build_model(cfg, g.num_classes, g.num_features, "cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    loss, aux = train_step(model, g, adj, opt, cfg.Lambda, None)
    return worker.step_state(model, loss, aux)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_step_matches_single_device(ranks, case):
    want = _single_step(STEP_CASES[case])
    for out in ranks:
        got = out[case]
        for k in ("loss", "loss_s", "loss_t1", "loss_t2", "loss_kl"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **STEP_TOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, err_msg=name,
                                       **STEP_TOL)
        for name, b in want["buffers"].items():
            np.testing.assert_allclose(got["buffers"][name], b,
                                       err_msg=name, **STEP_TOL)
        info = got["info"]
        assert info["backend"] == "gloo" and info["n_shards"] == 2
        assert info["layout"] == STEP_CASES[case].get("shard_layout",
                                                      "halo")
        if info["layout"] == "halo":
            kw = STEP_CASES[case]
            # lean recomputes the convs, and then JAX runs the plain form
            assert info["overlap"] == (kw.get("halo_overlap", False)
                                       and kw.get("memory_policy") != "lean")
            # forward and backward exchange of every conv, no staging
            assert info["exchange"]["calls"] > 0
            assert not info["exchange"]["staged"]


def test_lean_overlap_runs_the_plain_halo_form(ranks):
    """``halo_overlap`` with ``memory_policy="lean"``: JAX takes the
    overlap form only without recompute-backward (its ``nn/ktgnn.py``
    rule), so the step exchanges and calls the kernels as the plain halo
    form under lean does (the concatenated attention pair and the
    sender reduce, no SpMM); the overlap form without lean calls the
    SpMM alone. Every form runs the conv prologue's kernels."""
    for out in ranks:
        lean, plain = out["overlap_lean"], out["halo_lean"]
        assert lean["info"]["exchange"]["calls"] == \
            plain["info"]["exchange"]["calls"] > 0
        assert lean["kernel_calls"] == plain["kernel_calls"]
        assert set(lean["kernel_calls"]) == {
            "attention_fwd", "attention_bwd", "slot_reduce", *PROLOGUE}
        assert set(out["overlap"]["kernel_calls"]) == {"gather_reduce",
                                                       *PROLOGUE}


def test_replicated_state_identical_across_ranks(ranks):
    a, b = ranks
    assert (a["rank"], b["rank"]) == (0, 1)
    for case in TRAIN_CASES:
        ta, tb = a["train"][case], b["train"][case]
        for k, v in ta["state"].items():
            assert np.array_equal(v, tb["state"][k]), (case, k)
        assert ta["history"] == tb["history"], case
    for case in STEP_CASES:
        for k, v in a[case]["buffers"].items():
            assert np.array_equal(v, b[case]["buffers"][k]), (case, k)
        for k, v in a[case]["grads"].items():
            assert np.array_equal(v, b[case]["grads"][k]), (case, k)


def test_sharded_spmm_matches_segment_sum(ranks):
    """The edge-shard SpMM on both ranks against one segment sum of the
    whole padded edge array (the same per-edge weights)."""
    cfg = Stage2Config(**TRAIN)
    g, _ = prepare_stage2_graph(_data(), cfg, "cpu", build_adj=False)
    g = pad_graph_edges_for_sharding(g, 2)
    assert g.num_edges_padded % 256 == 0
    w = torch.linspace(0.5, 1.5, g.num_edges_padded)
    msg = g.x[g.senders.long()] * w[:, None] * g.edge_mask[:, None]
    want = torch.zeros_like(g.x).index_add_(0, g.receivers.long(), msg)
    for out in ranks:
        np.testing.assert_allclose(out["spmm"], want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("launch", ["spawn", "torchrun"])
def test_cli_trains_with_n_shards(tmp_path, capfd, launch):
    """``--n_shards 2``: the CLI starts its two ranks itself, or joins
    the group torchrun forms; rank 0 alone prints."""
    npz = str(tmp_path / "g.npz")
    save_graph_npz(npz, _data())
    argv = ["--path_data", npz, "--num_epoch", "2", "--hidden_dim", "8",
            "--log_every", "1", "--n_shards", "2", "--device", "cpu",
            "--ckpt_dir", str(tmp_path / "ck")]
    if launch == "spawn":
        res = tcli.main(tcli.build_argparser().parse_args(
            argv + ["--halo_overlap"]))
        out = capfd.readouterr().out   # the ranks print to the fd
        assert res["parallel"]["overlap"] and len(res["history"]) == 2
    else:
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "-m",
             "bridged_gnn_tpu_torch.cli.main_graph_knowledge_transfer",
             *argv, "--shard_layout", "edgeshard"],
            capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        out = run.stdout
    for line in ("local homophily of test nodes:", "[stage-2 best]",
                 "[per-head test]", "Epoch 002 loss"):
        assert out.count(line) == 1, (line, out)


def test_sharded_refusals(ranks):
    """Sharded scan mode runs (the ``halo_scan`` case on both ranks,
    every epoch eager under gloo; ``tests/test_torch_sharded_scan.py``
    holds it against the loop); other models and the complementor are
    refused as by the JAX runtime."""
    data = _data()
    check_ported(Stage2Config(**BASE, scan_epochs=2))
    for out in ranks:
        scan = out["train"]["halo_scan"]["scan"]
        assert scan["capture"] == "none (gloo)"
        assert (scan["eager_epochs"], scan["captures"]) == (6, 0)
    for kw in (dict(model_name="GCN"), dict(need_complement=True)):
        with pytest.raises(ValueError, match="KTGNN_noDTC"):
            train_ktgnn(data, Stage2Config(**BASE, **kw), "cpu")
    with pytest.raises(ValueError, match="shard_layout"):
        train_ktgnn(data, Stage2Config(shard_layout="rows"), "cpu")


def test_spawn_has_no_deadline_unless_given():
    """A long sharded run is never cut by default; a caller's deadline
    terminates the ranks and raises."""
    import inspect
    import time

    assert inspect.signature(spawn).parameters["timeout_s"].default is None
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn(time.sleep, 1, (60,), device_type="cpu", timeout_s=1)


def test_backend_rule():
    assert backend_for("cpu", 2) == "gloo"
    assert backend_for("cuda", 2, cards=1) == "gloo"
    assert backend_for("cuda", 1, cards=1) == "nccl"
    assert backend_for("cuda", 4, cards=4) == "nccl"


def test_parallel_imports_no_jax():
    code = ("import sys, bridged_gnn_tpu_torch.parallel, "
            "bridged_gnn_tpu_torch.parallel.stage2_runtime; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bridged_gnn_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
