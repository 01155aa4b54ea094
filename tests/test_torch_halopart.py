"""PyTorch port, the halo row partition's host build
(``parallel/halopart.py``): every array and static dim of
``build_halo_partition`` against the JAX package's, for 2 and 4 shards,
with and without the overlap split, at node blocks 32 and 128, and
``wire_bytes_per_layer``; and each shard's port ``PaddedLayout`` holding
the JAX layout's slots."""

import numpy as np
import pytest

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.parallel import halopart as jhalo

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops.blocked_segment import slot_rows
from bridged_gnn_tpu_torch.parallel import halopart as thalo


def _data(seed=0, n=300, e=2000, d=8):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(n, d)).astype(np.float32),
        edge_index=rng.integers(0, n, size=(2, e)),
        y=rng.integers(0, 3, size=n),
        train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.2,
        test_mask=rng.random(n) < 0.3, central_mask=rng.random(n) < 0.5)


@pytest.fixture(scope="module")
def graphs():
    data = _data()
    return (j_with_self_loops(j_graph_from_dict(data)),
            with_self_loops(graph_from_dict(data)))


@pytest.mark.parametrize("node_block", [32, 128])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_partition_matches_jax(graphs, n_shards, overlap, node_block):
    gj, gt = graphs
    want = jhalo.build_halo_partition(gj, n_shards, overlap=overlap,
                                      node_block=node_block)
    got = thalo.build_halo_partition(gt, n_shards, overlap=overlap,
                                     node_block=node_block)
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(want, field), getattr(got, field)
        if isinstance(a, dict):
            assert set(b) == set(a), field
            for k in a:
                np.testing.assert_array_equal(b[k], np.asarray(a[k]),
                                              err_msg=f"{field}[{k}]")
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=field)
        else:
            assert b == a, field
    for d in (8, 64):
        assert thalo.wire_bytes_per_layer(got, d) == \
            jhalo.wire_bytes_per_layer(want, d)


@pytest.mark.parametrize("overlap", [False, True])
def test_shard_layouts_hold_the_jax_slots(graphs, overlap):
    """Per shard: the port layout's senders are the JAX layout's on real
    slots (-1 elsewhere), its destination rows the JAX ``rel_key`` rows,
    its sender CSR the JAX ``ps_from_dst`` order; the overlap layouts
    likewise against ``pl2``, and every real edge in exactly one."""
    part = thalo.build_halo_partition(graphs[1], 2, overlap=overlap,
                                      node_block=32)
    nb = part.block_node_block
    for q in range(2):
        lays = thalo.shard_layouts(part, q)
        sets = [("pd", "ps", part.pd_tile, part.ps_tile, part.ps_blocks,
                 part.pl, lays[0])]
        if overlap:
            sets += [("ld", "ls", part.t_ld, part.t_ls, part.b_ls, part.pl2,
                      lays[1]),
                     ("hd", "hs", part.t_hd, part.t_hs, part.b_hs, part.pl2,
                      lays[2])]
        else:
            assert lays[1] is None and lays[2] is None
        for dn, sn, t_d, t_s, b_s, pl, lay in sets:
            sd = slice(q * part.pd_blocks * t_d, (q + 1) * part.pd_blocks
                       * t_d)
            ss = slice(q * b_s * t_s, (q + 1) * b_s * t_s)
            mask = pl[f"{dn}_mask"][sd]
            assert lay.tile_e == t_d and lay.node_block == nb
            np.testing.assert_array_equal(
                lay.slot_src.numpy(), np.where(mask, pl[f"{dn}_other"][sd],
                                               -1))
            row, valid = slot_rows(lay)
            blk = np.arange(mask.size) // t_d
            np.testing.assert_array_equal(
                row.numpy()[mask], (blk * nb + pl[f"{dn}_rel"][sd])[mask])
            np.testing.assert_array_equal(valid.numpy(), mask)
            np.testing.assert_array_equal(
                lay.src_slots.numpy(),
                pl[f"{sn}_from_dst"][ss][pl[f"{sn}_mask"][ss]])
        if overlap:
            real = part.edge_mask.reshape(2, -1)[q].sum()
            assert sum(int((lay.slot_src >= 0).sum()) for lay in lays[1:]) \
                == real == int((lays[0].slot_src >= 0).sum())


def test_shard_node_array_pads_past_the_graph(graphs):
    part = thalo.build_halo_partition(graphs[1], 4)
    y = graphs[1].y.numpy()
    blocks = [thalo.shard_node_array(y, part, q, fill=-1) for q in range(4)]
    cat = np.concatenate(blocks)
    assert cat.shape[0] == part.num_nodes_padded_total >= y.shape[0]
    np.testing.assert_array_equal(cat[: y.shape[0]], y)
    assert (cat[y.shape[0]:] == -1).all()
