"""PyTorch port, sharded scan mode (``Stage2Config(n_shards=2,
scan_epochs=3)``) on one gloo group of two CPU ranks, started once for
the module (``tests/torch_multidevice_worker.py::scan_rank_work``):

* KTGNN on the halo layout, in its overlap form and on the edge-shard
  layout, and KTGNN_noDTC on the halo layout, 6 epochs in chunks of 3,
  against the port's sharded loop run of the same case: losses at rtol
  1e-4, the same best epoch and scores, the same final state; every
  epoch eager under gloo
  (``scan["capture"]`` is ``"none (gloo)"``, no capture);
* a run cut at its first chunk's end and resumed from that checkpoint
  against the straight run (JAX ``tests/test_stage2_sharded.py``'s
  resume check);
* a group of one rank passed as ``train_ktgnn(group=...)`` (how a
  1-rank NCCL group captures the sharded epoch on a card) against the
  single device's scan run;
* both ranks' results bit-identical.

The JAX package's ``n_shards=2, scan_epochs=3`` runs are held against
the port's in ``tests/test_torch_sharded.py`` (its ``halo_scan`` and
``overlap_scan`` cases).
Dropout is 0 throughout."""

import numpy as np
import pytest

from bridged_gnn_tpu_torch.parallel.multihost import spawn

from tests import torch_multidevice_worker as worker
from tests.test_torch_graph import sync_data

BASE = dict(hidden=8, dropout=0.0, log_every=0, n_shards=2, num_epoch=6,
            lr=1e-2, scan_epochs=3)
CASES = dict(
    halo=dict(BASE),
    edgeshard=dict(BASE, shard_layout="edgeshard"),
    nodtc_halo=dict(BASE, model_name="KTGNN_noDTC"),
    overlap=dict(BASE, halo_overlap=True),
)
RESUME = dict(BASE, dropout=0.5, step_size=4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ck")
    data = sync_data(dim=12, num_classes=3)
    return spawn(worker.scan_rank_work, 2,
                 (data, CASES, RESUME, str(tmp / "full"), str(tmp / "cut")),
                 device_type="cpu", timeout_s=600)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_scan_matches_sharded_loop(ranks, case):
    for out in ranks:
        loop, scan = out[case]["loop"], out[case]["scan"]
        assert [h["epoch"] for h in scan["history"]] == list(range(1, 7))
        for hl, hs in zip(loop["history"], scan["history"]):
            for key in ("loss", "loss_t2"):
                assert hs[key] == pytest.approx(hl[key], rel=1e-4)
            for key in ("train", "val", "test"):
                assert hs[key] == pytest.approx(hl[key], abs=1e-12)
        assert scan["best"]["epoch"] == loop["best"]["epoch"]
        assert scan["best"]["per_head"] == loop["best"]["per_head"]
        for k, v in loop["state"].items():
            np.testing.assert_allclose(scan["state"][k], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_scan_runs_eagerly_under_gloo(ranks, case):
    """The capture rule, fixed from the backend: gloo ranks run every
    epoch eagerly, two chunks of 3."""
    scan = ranks[0][case]["scan"]["scan"]
    assert scan["capture"] == "none (gloo)"
    assert (scan["captures"], scan["replays"], scan["eager_epochs"]) == \
        (0, 0, 6)
    assert ranks[0][case]["loop"]["scan"] is None


def test_sharded_scan_resume_equals_straight_run(ranks):
    """Cut after the first chunk (epoch 3), resumed to 6 with dropout on
    and StepLR stepping at 4: the resumed epochs and state are the
    straight run's."""
    for out in ranks:
        full, resumed = out["resume"]["full"], out["resume"]["resumed"]
        assert [h["epoch"] for h in resumed["history"]] == [4, 5, 6]
        np.testing.assert_allclose(
            [h["loss"] for h in resumed["history"]],
            [h["loss"] for h in full["history"][3:]], rtol=1e-5)
        assert resumed["best"]["epoch"] == full["best"]["epoch"]
        for k, v in full["state"].items():
            np.testing.assert_allclose(resumed["state"][k], v, rtol=1e-6,
                                       atol=1e-8, err_msg=k)


def test_sharded_scan_ranks_bit_identical(ranks):
    a, b = ranks
    assert (a["rank"], b["rank"]) == (0, 1)
    for case in CASES:
        for mode in ("loop", "scan"):
            ra, rb = a[case][mode], b[case][mode]
            assert ra["history"] == rb["history"], (case, mode)
            for k, v in ra["state"].items():
                assert np.array_equal(v, rb["state"][k]), (case, mode, k)


def test_one_rank_group_matches_single_device(ranks):
    from bridged_gnn_tpu_torch.train.stage2 import (
        Stage2Config,
        train_ktgnn,
    )

    single = train_ktgnn(sync_data(dim=12, num_classes=3),
                         Stage2Config(**dict(BASE, n_shards=1)), "cpu")
    for out in ranks:
        got = out["one_rank"]
        assert got["parallel"]["n_shards"] == 1
        assert got["scan"]["capture"] == "none (gloo)"
        for a, b in zip(got["history"], single["history"], strict=True):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert got["best"]["epoch"] == single["best"]["epoch"]
