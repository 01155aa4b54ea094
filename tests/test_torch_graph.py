"""PyTorch port, host side: graph builders, synthetic data, npz loading,
slot layouts and the skew choice give the same arrays as the JAX package;
entry points default to CUDA; the port never imports JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bridged_gnn_tpu import graph as jgraph
from bridged_gnn_tpu.data import synthetic as jsyn
from bridged_gnn_tpu.io.serialize import save_graph_npz
from bridged_gnn_tpu.ops import blocked_segment as jbs
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adjacency
from bridged_gnn_tpu.train.stage2 import to_undirected_np as j_undirected

from bridged_gnn_tpu_torch import graph as tgraph
from bridged_gnn_tpu_torch.data import synthetic as tsyn
from bridged_gnn_tpu_torch.io.serialize import load_graph_npz
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph as t_adjacency

from tests.test_torch_cuda import random_edges, skewed_data

REPO = Path(__file__).resolve().parent.parent
GRAPH_FIELDS = ("x", "y", "senders", "receivers", "edge_mask", "node_mask",
                "train_mask", "val_mask", "test_mask", "central_mask")


def sync_data(n_src=90, n_tar=60, dim=12, num_classes=3, seed=1):
    data = tsyn.make_sync_dataset("relational-intra", n_src=n_src,
                                  n_tar=n_tar, dim=dim,
                                  num_classes=num_classes, seed=seed)
    r = np.random.default_rng(seed).random(n_src + n_tar)
    data["train_mask"] = r < 0.6
    data["val_mask"] = (r >= 0.6) & (r < 0.8)
    data["test_mask"] = r >= 0.8
    return data


def assert_same_graph(gj, gt):
    assert (gj.num_nodes, gj.num_edges) == (gt.num_nodes, gt.num_edges)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(gj, f)), getattr(gt, f).numpy(), err_msg=f)


def assert_same_layout(lj, lt):
    """The port's slot_src and the rows derived from dst_ranges carry the
    JAX layout's other_slot (on real slots), slot_mask and rel_key."""
    assert (lj.node_block, lj.tile_e, lj.num_blocks, lj.num_nodes_padded) \
        == (lt.node_block, lt.tile_e, lt.num_blocks, lt.num_nodes_padded)
    mask = np.asarray(lj.slot_mask).reshape(-1)
    np.testing.assert_array_equal(
        lt.slot_src.cpu().numpy(),
        np.where(mask, np.asarray(lj.other_slot).reshape(-1), -1),
        err_msg="slot_src")
    row, valid = tbs.slot_rows(lt)
    np.testing.assert_array_equal(valid.cpu().numpy(), mask,
                                  err_msg="slot_mask")
    np.testing.assert_array_equal(
        np.where(mask, row.cpu().numpy() % lt.node_block, lt.node_block),
        np.asarray(lj.rel_key).reshape(-1), err_msg="rel_key")


@pytest.mark.parametrize("variant", [
    "unrelational", "relational-intra", "relational-intra-inter"])
def test_sync_dataset_identical(variant):
    kw = dict(n_src=70, n_tar=50, dim=10, num_classes=3, seed=3)
    dj = jsyn.make_sync_dataset(variant, **kw)
    dt = tsyn.make_sync_dataset(variant, **kw)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)


def test_benchmark_graph_identical():
    kw = dict(n=192, avg_degree=6, dim=16, num_classes=5, seed=7)
    dj = jsyn.make_benchmark_graph(**kw)
    dt = tsyn.make_benchmark_graph(**kw)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)


def test_graph_builders_identical(rng):
    data = sync_data()
    # duplicates, self loops and an unsorted edge order exercise coalesce,
    # the self-loop helpers and the dst sort
    ei = data["edge_index"]
    data["edge_index"] = np.concatenate(
        [ei[:, ::-1], ei[:, :20], np.stack([np.arange(5)] * 2)], axis=1)
    np.testing.assert_array_equal(
        jgraph.coalesce_np(data["edge_index"], 150),
        tgraph.coalesce_np(data["edge_index"], 150))
    np.testing.assert_array_equal(
        jgraph.sort_edges_by_dst(data["edge_index"], 150),
        tgraph.sort_edges_by_dst(data["edge_index"], 150))
    assert_same_graph(jgraph.graph_from_dict(data),
                      tgraph.graph_from_dict(data))
    uj, ut = j_undirected(data), tgraph.to_undirected_np(data)
    np.testing.assert_array_equal(uj["edge_index"], ut["edge_index"])
    gj = jgraph.with_self_loops(jgraph.graph_from_dict(uj))
    gt = tgraph.with_self_loops(tgraph.graph_from_dict(ut))
    assert_same_graph(gj, gt)
    np.testing.assert_array_equal(gj.edge_index_np(), gt.edge_index_np())
    assert gt.num_classes == gj.num_classes
    # no labels or masks, and a node count that needs padding
    assert_same_graph(
        jgraph.build_graph(data["x"][:147], data["edge_index"] % 147),
        tgraph.build_graph(data["x"][:147], data["edge_index"] % 147))


def test_load_graph_npz(tmp_path):
    data = sync_data()
    path = str(tmp_path / "g.npz")
    save_graph_npz(path, data)
    got = load_graph_npz(path)
    assert got.keys() == data.keys()
    for k in data:
        np.testing.assert_array_equal(got[k], data[k], err_msg=k)


def _check_kernel_index(lj, lt):
    """dst_ranges describe exactly the JAX layout's runs: each real slot
    lies in its destination's run, and a block's pad tail starts where
    its last run ends."""
    et, nb = lt.tile_e, lt.node_block
    mask = np.asarray(lj.slot_mask).reshape(-1)
    rel = np.asarray(lj.rel_key).reshape(-1)
    ranges = lt.dst_ranges.numpy()
    covered = np.zeros(len(mask), dtype=int)
    for v, (lo, hi) in enumerate(ranges):
        assert lo <= hi
        b = v // nb
        assert b * et <= lo and hi <= (b + 1) * et
        covered[lo:hi] += 1
        seg = slice(lo, hi)
        # every real slot in the run belongs to v; every real slot of v
        # lies in the run
        assert np.all(rel[seg][mask[seg]] == v % nb)
        in_block = slice(b * et, (b + 1) * et)
        assert mask[in_block][rel[in_block] == v % nb].sum() \
            == mask[seg].sum()
        if v % nb == nb - 1:  # pad tail starts at the block's last run end
            assert not mask[hi:(b + 1) * et].any()
    assert covered.max() <= 1
    assert np.all(covered[mask] == 1)


@pytest.mark.parametrize("node_block", [16, 64, 128])
def test_padded_layout_identical(rng, node_block):
    s, r, em = random_edges(rng)
    lj = jbs.make_blocked_ops(s, r, em, 64, node_block=node_block).lay_dst
    lt = tbs.make_blocked_ops(s, r, em, 64, node_block=node_block).lay_dst
    assert_same_layout(lj, lt)
    _check_kernel_index(lj, lt)
    assert lt.sender_bound == int(s[em].max()) + 1


def test_layout_rejects_unsorted_edges(rng):
    s, r, em = random_edges(rng)
    with pytest.raises(ValueError, match="destination-sorted"):
        tbs.make_blocked_ops(s, r[::-1].copy(), em, 64, node_block=16)


@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_adjacency_and_skew_choice_identical(rng, method):
    """The skew rule picks tiers on the skewed graph under 'blocked', and
    the tiered layouts match tier by tier."""
    data = skewed_data(rng)
    gj = jgraph.with_self_loops(jgraph.graph_from_dict(data))
    gt = tgraph.with_self_loops(tgraph.graph_from_dict(data))
    aj = j_adjacency(gj, method=method, node_block=64)
    at = t_adjacency(gt, method=method, node_block=64, device="cpu")
    assert aj.fast_fn is None and at.fast_fn is None
    tj, tt = aj.tiered_fn, at.tiered_fn
    assert tj.tier_spans == tt.tier_spans and len(tt.tiers) >= 2
    assert (tj.slots_single, tj.slots_tiered, tj.node_block) == \
        (tt.slots_single, tt.slots_tiered, tt.node_block)
    np.testing.assert_array_equal(np.asarray(tj.row_order),
                                  tt.row_order.numpy())
    np.testing.assert_array_equal(np.asarray(tj.inv_order),
                                  tt.inv_order.numpy())
    for oj, ot in zip(tj.tiers, tt.tiers):
        assert_same_layout(oj.lay_dst, ot.lay_dst)
        _check_kernel_index(oj.lay_dst, ot.lay_dst)


def test_adjacency_single_layout_when_not_skewed():
    data = sync_data()
    gj = jgraph.with_self_loops(jgraph.graph_from_dict(data))
    gt = tgraph.with_self_loops(tgraph.graph_from_dict(data))
    aj = j_adjacency(gj, method="blocked", node_block=128)
    at = t_adjacency(gt, method="blocked", node_block=128, device="cpu")
    assert aj.tiered_fn is None and at.tiered_fn is None
    assert_same_layout(aj.fast_fn.lay_dst, at.fast_fn.lay_dst)
    _check_kernel_index(aj.fast_fn.lay_dst, at.fast_fn.lay_dst)
    # the dense method builds a matrix and no layout; an unknown one raises
    dense = t_adjacency(gt, method="dense", device="cpu")
    assert dense.fast_fn is None and dense.dense is not None
    with pytest.raises(ValueError, match="adjacency method"):
        t_adjacency(gt, method="sparse", device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it():
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, build_model
    from bridged_gnn_tpu_torch.utils.platform import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    data = sync_data()
    gt = tgraph.with_self_loops(tgraph.graph_from_dict(data))
    with pytest.raises(RuntimeError, match="cuda"):
        t_adjacency(gt)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(Stage2Config(hidden=8), 3, 12)
    model = build_model(Stage2Config(hidden=8), 3, 12, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        KTGNNPredictor(model, None, data)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"


# ------------------------------------------------------------ import hygiene

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
              "bridged_gnn_tpu")


def _port_sources():
    files = sorted((REPO / "bridged_gnn_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """AST check: no import of JAX, flax, scikit-learn or the JAX package
    anywhere in the port or chip_smoke.py (relative imports stay inside
    the port)."""
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in _FORBIDDEN:
                    bad.append(f"{path.relative_to(REPO)}: {name}")
    assert not bad, bad


def test_port_modules_load_without_jax():
    """Subprocess check: importing every port module and chip_smoke.py
    loads no JAX, flax, scikit-learn or JAX-package module and sets no
    CUDA state."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "bridged_gnn_tpu_torch").rglob("*.py")
    )
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout
