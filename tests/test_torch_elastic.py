"""PyTorch port, elastic retries (``train/elastic.py``), the pipeline
over a process group and the last ported public names:

* ``is_transient`` gives the JAX package's answers on messages built
  from JAX's tokens, retries a ``torch.OutOfMemoryError`` and no
  permanent error nor a sticky CUDA error (whose message may carry a
  transient token too); the heartbeat file;
* ``run_pipeline(mesh=group, elastic=True)`` on two gloo ranks, started
  once for the module (``tests/torch_multidevice_worker.py::
  pipeline_rank_work``), on the tiny sync config of
  ``tests/test_torch_pipeline.py``, stage 2's first attempt failing with
  an out-of-memory error on each rank: one retry, and the straight run's
  bridged graph, stage-1 best and stage-2 best on each rank (the
  pipeline CLI's ``--elastic`` runs in ``tests/test_torch_pipeline.py``);
  on the same ranks the edge-span placement (``gspmd_setup``) under a
  KT-GNN forward matches the single device's (JAX
  ``tests/test_gspmd.py``'s check) and the pod mesh is one host of two;
* ``check_determinism``, ``nan_debug`` and ``annotate``; the
  collectives' named ranges (``collective_span``), on the ranks;
* the new modules import no JAX.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bridged_gnn_tpu.train import elastic as jelastic

from bridged_gnn_tpu_torch import pipeline as tpipe
from bridged_gnn_tpu_torch.parallel.multihost import (
    flat_edge_mesh,
    make_pod_mesh,
    spawn,
)
from bridged_gnn_tpu_torch.train import elastic as telastic
from bridged_gnn_tpu_torch.train.stage2 import (
    Stage2Config,
    build_model,
    prepare_stage2_graph,
)
from bridged_gnn_tpu_torch.utils.profiling import annotate
from bridged_gnn_tpu_torch.utils.sanitizers import (
    check_determinism,
    nan_debug,
)

from tests import torch_multidevice_worker as worker
from tests.test_torch_graph import sync_data
from tests.test_torch_pipeline import _tiny

OOM = "CUDA out of memory. Tried to allocate 80.00 GiB"


@pytest.fixture(scope="module")
def ranks_pending(tmp_path_factory):
    """Both ranks' elastic pipeline over the group, started in the
    background so that the straight run overlaps it."""
    out = str(tmp_path_factory.mktemp("mesh"))
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(spawn, worker.pipeline_rank_work, 2,
                          (_tiny().to_json(), sync_data(), out, OOM),
                          device_type="cpu", timeout_s=600)


@pytest.fixture(scope="module")
def straight():
    return tpipe.run_pipeline(_tiny(), device="cpu")


# ---------------------------------------------------------------- elastic


def _messages():
    """A message per JAX token, in its own case and lower case, and
    permanent ones."""
    out = []
    for tok in jelastic.TRANSIENT_ERRORS:
        out += [RuntimeError(f"backend {tok}: dropped"),
                RuntimeError(f"backend {tok.lower()}: dropped")]
    return out + [ValueError("shape mismatch (3,) vs (4,)"),
                  KeyError("params"), RuntimeError("CUDA error")]


@pytest.mark.parametrize("exc", _messages(), ids=str)
def test_is_transient_gives_jaxs_answers(exc):
    assert telastic.is_transient(exc) == jelastic.is_transient(exc)


@pytest.mark.parametrize("exc,transient", [
    (torch.OutOfMemoryError(OOM), True),
    (RuntimeError("NCCL timeout: Watchdog caught collective operation "
                  "timeout"), True),
    (RuntimeError("[gloo] Connection closed by peer"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered "
                  "(INTERNAL)"), False),
    (RuntimeError("CUDA error: device-side assert triggered"), False),
    (RuntimeError("CUDA error: unspecified launch failure"), False),
], ids=["oom", "nccl_timeout", "gloo_closed", "illegal_access",
        "device_assert", "launch_failure"])
def test_torch_failure_classes(exc, transient):
    assert telastic.is_transient(exc) is transient


def test_retry_on_oom_and_heartbeat(tmp_path):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise torch.OutOfMemoryError(OOM)
        return {"ok": True}

    hb = str(tmp_path / "hb.json")
    out = telastic.run_elastic(flaky, max_retries=3, retry_delay_s=0.01,
                               heartbeat_path=hb)
    assert out == {"ok": True} and calls["n"] == 3
    age = telastic.Heartbeat(hb).age()
    assert age is not None and 0 <= age < 60
    assert telastic.Heartbeat(str(tmp_path / "none.json")).age() is None


@pytest.mark.parametrize("exc", [
    ValueError("shape mismatch (3,) vs (4,)"),
    RuntimeError("CUDA error: an illegal memory access was encountered")],
    ids=["permanent", "sticky"])
def test_no_retry_on_permanent_or_sticky(exc):
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        telastic.run_elastic(broken, max_retries=3, retry_delay_s=0.01)
    assert calls["n"] == 1


# ------------------------------------------------------- the group's runs


def test_elastic_pipeline_over_a_group_gives_the_straight_run(
        ranks_pending, straight):
    for out in ranks_pending.result():
        got = out["pipeline"]
        assert got["attempts"] == 2
        assert got["stage1"] == straight["stage1"]
        assert sorted(got["bridged_graph"]) == sorted(
            straight["bridged_graph"])
        for k, v in straight["bridged_graph"].items():
            np.testing.assert_array_equal(got["bridged_graph"][k], v, k)
        assert got["stage2"]["epoch"] == straight["stage2"]["epoch"]
        for k in ("train", "val", "test", "loss"):
            assert got["stage2"][k] == pytest.approx(
                straight["stage2"][k], rel=1e-5, abs=1e-7), k


def test_edge_span_placement_forward_matches(ranks_pending):
    data = sync_data()
    cfg = Stage2Config(hidden=16, num_layer=2)
    g, adj = prepare_stage2_graph(data, cfg, "cpu")
    model = build_model(cfg, g.num_classes, g.num_features, "cpu").eval()
    with torch.no_grad():
        want = model(g, adj)[2][: g.num_nodes].numpy()
    for out in ranks_pending.result():
        np.testing.assert_allclose(out["gspmd"], want, rtol=1e-4,
                                   atol=1e-5)
        assert out["edge_pad"] % 256 == 0
        assert out["span"] == out["edge_pad"] // 2


def test_pod_mesh(ranks_pending):
    for out in ranks_pending.result():
        ranks, names = out["pod"]
        assert names == ("host", "edges")
        assert ranks.tolist() == [[0, 1]] and out["flat"] == (0, 1)
    mesh = make_pod_mesh()
    assert mesh.ranks.shape == (1, 1)
    assert flat_edge_mesh(mesh).axis_names == ("edges",)


# ------------------------------------------------------------ the rest


def test_check_determinism():
    x = torch.arange(6.0)
    check_determinism(lambda t: dict(a=t * 2, b=[t.sum(), np.ones(2)]), x)
    state = {"n": 0}

    def drifting(t):
        state["n"] += 1
        return t + state["n"]

    with pytest.raises(AssertionError, match="nondeterministic"):
        check_determinism(drifting, x)


def test_nan_debug_raises_at_the_first_non_finite_result():
    x = torch.tensor([1.0, 0.0], requires_grad=True)
    with nan_debug():
        y = (x * 2).sum()
    assert float(y.detach()) == 2.0
    with pytest.raises(FloatingPointError, match="log"):
        with nan_debug():
            torch.log(x - 1.0)
    assert torch.isnan(torch.log(torch.tensor(-1.0)))   # off again


def test_annotate_names_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("probe-matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "probe-matmul" in {e.key for e in prof.key_averages()}


def test_collectives_carry_named_ranges(ranks_pending):
    """Each collective call sits in a ``collective:<kind>`` range, which
    a trace reads to name the collective's own device work (under gloo
    the row all-gather's backward is an all-reduce)."""
    for out in ranks_pending.result():
        assert out["spans"] == ["collective:all_gather",
                                "collective:all_reduce"]


def test_new_modules_import_no_jax():
    code = ("import sys, bridged_gnn_tpu_torch.parallel.gspmd, "
            "bridged_gnn_tpu_torch.parallel.topk, "
            "bridged_gnn_tpu_torch.train.elastic, "
            "bridged_gnn_tpu_torch.pipeline, "
            "bridged_gnn_tpu_torch.utils.sanitizers, "
            "bridged_gnn_tpu_torch.utils.profiling, "
            "tests.torch_multidevice_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bridged_gnn_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
