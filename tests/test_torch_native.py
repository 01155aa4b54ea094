"""PyTorch port, the native graph-core library (``io/native.py``, built
from the port's ``csrc/graphcore.cpp``): each entry point against the JAX
package's (native or numpy) and the port's numpy versions, the dispatch of
``graph.py`` above its edge threshold, the build into a given directory,
and a missing compiler raising instead of falling back."""

import numpy as np
import pytest

from bridged_gnn_tpu.graph import coalesce_np as j_coalesce
from bridged_gnn_tpu.graph import sort_edges_by_dst as j_sort
from bridged_gnn_tpu.io import native as jnative

from bridged_gnn_tpu_torch import graph as tgraph
from bridged_gnn_tpu_torch.io import native as tnative
from bridged_gnn_tpu_torch.ops.chunk_meta import build_chunk_meta
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
