"""PyTorch port, the native graph-core library (``io/native.py``, built
from the port's ``csrc/graphcore.cpp``): each entry point against the JAX
package's (native or numpy) and the port's numpy versions, the dispatch of
``graph.py`` and of the slot layouts' sender index above the threshold,
the build into a given directory, and a missing compiler raising instead
of falling back."""

import numpy as np
import pytest

from bridged_gnn_tpu.graph import coalesce_np as j_coalesce
from bridged_gnn_tpu.graph import sort_edges_by_dst as j_sort
from bridged_gnn_tpu.io import native as jnative

from bridged_gnn_tpu_torch import graph as tgraph
from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
from bridged_gnn_tpu_torch.io import native as tnative
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops.chunk_meta import build_chunk_meta
from bridged_gnn_tpu_torch.train.stage2 import (Stage2Config,
                                               prepare_stage2_graph)
from bridged_gnn_tpu_torch.utils.profiling import clear_recorded, recorded
from bridged_gnn_tpu_torch.utils.diagnostics import degree_stats

N_BIG = 300_000
E_BIG = 1_200_000   # above NATIVE_EDGE_THRESHOLD


@pytest.fixture(scope="module")
def big_edges():
    """A seeded random edge list with duplicates and self loops."""
    rng = np.random.default_rng(7)
    ei = rng.integers(0, N_BIG, size=(2, E_BIG))
    ei[:, : E_BIG // 10] = ei[:, E_BIG // 10: E_BIG // 5]   # duplicates
    return ei


def test_threshold_is_the_jax_packages():
    from bridged_gnn_tpu.graph import NATIVE_EDGE_THRESHOLD

    assert tgraph.NATIVE_EDGE_THRESHOLD == NATIVE_EDGE_THRESHOLD
    assert E_BIG >= NATIVE_EDGE_THRESHOLD


def test_coalesce_and_sort_above_threshold_match(big_edges):
    """coalesce_np and sort_edges_by_dst take the native path above the
    threshold and give the JAX package's arrays and the numpy path's."""
    want_c = j_coalesce(big_edges, N_BIG)
    got_c = tgraph.coalesce_np(big_edges, N_BIG)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(tgraph.coalesce_numpy(big_edges, N_BIG),
                                  want_c)
    assert got_c.shape[1] < E_BIG
    want_s = j_sort(big_edges, N_BIG)
    np.testing.assert_array_equal(tgraph.sort_edges_by_dst(big_edges, N_BIG),
                                  want_s)
    np.testing.assert_array_equal(
        tgraph.sort_edges_numpy(big_edges, N_BIG), want_s)


def test_dispatch_runs_native_above_threshold(big_edges, monkeypatch):
    """Below the threshold numpy runs; at and above it the library."""
    calls = []
    real = tnative.coalesce
    monkeypatch.setattr(tnative, "coalesce",
                        lambda ei: calls.append(ei.shape[1]) or real(ei))
    tgraph.coalesce_np(big_edges[:, :1000], N_BIG)
    assert calls == []
    tgraph.coalesce_np(big_edges, N_BIG)
    assert calls == [E_BIG]


@pytest.mark.parametrize("num_shards,align", [(1, 128), (3, 128), (8, 64),
                                              (5, 1)])
def test_edge_partition_matches_jax(num_shards, align):
    for e in (0, 1000, 123_457):
        np.testing.assert_array_equal(
            tnative.edge_partition(e, num_shards, align),
            jnative.edge_partition(e, num_shards, align))


def test_degrees_rowptr_and_chunk_meta_match_jax(big_edges):
    """degrees, csr_rowptr and chunk_meta against the JAX package's, and
    chunk_meta against the port's numpy build_chunk_meta."""
    ei = big_edges[:, :50_000]
    n = N_BIG
    for got, want in zip(tnative.degrees(ei, n), jnative.degrees(ei, n)):
        np.testing.assert_array_equal(got, want)
    dst = np.sort(ei[1])
    np.testing.assert_array_equal(tnative.csr_rowptr(dst, n),
                                  jnative.csr_rowptr(dst, n))
    for nb, chunk in ((256, 1024), (128, 512), (1024, 4096)):
        base, num, mx = tnative.chunk_meta(dst, n, nb, chunk)
        jb, jn, jm = jnative.chunk_meta(dst, n, nb, chunk)
        np.testing.assert_array_equal(base, jb)
        np.testing.assert_array_equal(num, jn)
        assert mx == jm
        m = build_chunk_meta(dst, len(dst), n, nb, chunk)
        np.testing.assert_array_equal(m.chunk_base, base)
        np.testing.assert_array_equal(m.num_chunks, num)
        assert m.max_chunks == mx


def test_degree_stats_counts(big_edges):
    """degree_stats counts with numpy (no compiler needed) the degrees
    the native library counts."""
    ei = big_edges[:, :20_000]
    in_deg = np.bincount(ei[1], minlength=N_BIG)
    out_deg = np.bincount(ei[0], minlength=N_BIG)
    stats = degree_stats(ei, N_BIG)
    assert stats["in_max"] == in_deg.max()
    assert stats["out_max"] == out_deg.max()
    assert stats["isolated"] == int(((in_deg == 0) & (out_deg == 0)).sum())
    np.testing.assert_array_equal(tnative.degrees(ei, N_BIG)[0], in_deg)


@pytest.mark.parametrize("n,e", [(1, 0), (1, 5), (7, 40), (3 * 10**9, 1000),
                                 (2**31, 3000)])
def test_packed_sort_at_the_id_extremes(n, e):
    """The native coalesce and sort pack (dst, src) into one key: empty
    and one-node graphs, and ids of 32 bits, give numpy's arrays."""
    rng = np.random.default_rng(n + e)
    ei = rng.integers(0, n, size=(2, e))
    ei[:, : e // 4] = ei[:, e // 4: e // 2]   # duplicates
    np.testing.assert_array_equal(tnative.coalesce(ei),
                                  tgraph.coalesce_numpy(ei, n))
    np.testing.assert_array_equal(tnative.sort_by_dst(ei),
                                  tgraph.sort_edges_numpy(ei, n))


def test_native_sort_refuses_ids_that_do_not_pack():
    for ei in (np.array([[-1, 2], [0, 1]]),
               np.array([[2**40, 0], [2**40, 1]])):
        for fn in (tnative.coalesce, tnative.sort_by_dst):
            with pytest.raises(ValueError, match="non-negative"):
                fn(ei)


def test_library_builds_into_a_given_directory(tmp_path):
    """The build writes one hash-named library there, from the port's
    own source, and a second call reuses it; ``load`` binds it."""
    lib = tnative.build_native(tmp_path / "_build")
    assert lib.parent == tmp_path / "_build" and lib.is_file()
    assert tnative.SOURCE.parent.name == "csrc"
    assert tnative.SOURCE.parent.parent.name == "bridged_gnn_tpu_torch"
    assert tnative.build_native(tmp_path / "_build") == lib
    assert len(list((tmp_path / "_build").iterdir())) == 1
    assert tnative.load(tmp_path / "_build").gc_coalesce.restype is not None


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No compiler, no library: RuntimeError, never a numpy stand-in."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        tnative.build_native(tmp_path / "_build")
    with pytest.raises(RuntimeError, match="not found"):
        tnative.load(tmp_path / "_build")
    assert not (tmp_path / "_build").exists()


def _slot_src(big_edges, hub: bool = False):
    """``big_edges`` dst-sorted, a tenth of them masked, through the slot
    assignment: ``slot_src`` with -1 on masked and pad slots. ``hub``:
    four senders own ~80% of the edges."""
    rng = np.random.default_rng(11)
    s, r = big_edges[0].copy(), big_edges[1]
    if hub:
        s = np.where(rng.random(E_BIG) < 0.8, rng.integers(0, 4, E_BIG), s)
    order = np.argsort(r, kind="stable")
    valid = rng.random(E_BIG) < 0.9
    return tbs._padded_layout_np(r[order], s[order].astype(np.int32),
                                 valid, N_BIG, 128)[0]


@pytest.mark.parametrize("hub", [False, True], ids=["uniform", "hub"])
def test_sender_csr_matches_numpy_above_threshold(big_edges, hub):
    """The native counting sort gives the numpy argsort's ``src_ranges``
    and ``src_slots`` bit for bit: -1 slots left out, senders with no
    entry (among them the rows past the largest id), the largest sender
    id, and a hub-skewed sender column."""
    slot_src = _slot_src(big_edges, hub)
    slot_src[np.flatnonzero(slot_src >= 0)[-1]] = N_BIG - 1
    real = slot_src >= 0
    assert real.sum() >= tgraph.NATIVE_EDGE_THRESHOLD and not real.all()
    num_senders = N_BIG + 3
    got = tnative.sender_csr(slot_src, num_senders)
    want = tbs._sender_csr_numpy(slot_src, num_senders)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    counts = np.diff(got[0], axis=1)[:, 0]
    assert (counts == 0).sum() > 3 and counts[N_BIG - 1] > 0
    assert counts.max() > (200_000 if hub else 0)


@pytest.mark.parametrize("bad", [5, 6, 2**31 - 1])
def test_sender_csr_refuses_out_of_range_senders(bad):
    """A sender id at or above ``num_senders``: the entry returns -1 with
    its outputs untouched, and the binding raises."""
    slot_src = np.array([0, -1, 4, bad, 2, -1], dtype=np.int32)
    ranges = np.full((5, 2), 77, dtype=np.int32)
    slots = np.full(4, 77, dtype=np.int32)
    lib = tnative.load()
    assert lib.gc_sender_csr(slot_src, len(slot_src), 5, ranges, slots) == -1
    assert (ranges == 77).all() and (slots == 77).all()
    with pytest.raises(RuntimeError, match=r"\[0, 5\)"):
        tnative.sender_csr(slot_src, 5)


def test_sender_csr_dispatch_runs_native_above_threshold(big_edges):
    """From the threshold of real slots up the layout's sender index is
    the library's (one call), below it numpy's (none)."""
    slot_src = _slot_src(big_edges)
    n_real = int((slot_src >= 0).sum())
    small = slot_src.copy()
    small[np.flatnonzero(small >= 0)[: n_real - 1000]] = -1
    before = tnative.call_counts()["gc_sender_csr"]
    tbs._sender_csr_np(small, N_BIG)
    assert tnative.call_counts()["gc_sender_csr"] == before
    got = tbs._sender_csr_np(slot_src, N_BIG)
    assert tnative.call_counts()["gc_sender_csr"] == before + 1
    np.testing.assert_array_equal(got[1],
                                  tbs._sender_csr_numpy(slot_src, N_BIG)[1])


@pytest.mark.parametrize("n,native_layouts", [(2048, 0), (65536, 1)])
def test_layout_span_counts_native_sender_index(n, native_layouts):
    """The ``stage2.layout`` range counts the layouts whose sender index
    the library built: the one of a graph of over a million slots, none
    of a small one."""
    from torch.profiler import ProfilerActivity, profile

    data = make_benchmark_graph(n, 8, 8, 4, seed=0)
    cfg = Stage2Config(to_undirected=True, adjacency_method="blocked")
    clear_recorded()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            prepare_stage2_graph(data, cfg, "cpu")
        spans = [s for s in recorded() if s.name == "stage2.layout"]
    finally:
        clear_recorded()
    assert [s.counts for s in spans] == [dict(native_sender_csr=native_layouts)]
