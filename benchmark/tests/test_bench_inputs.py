"""The benchmark's frozen generators give the program's arrays."""

import numpy as np
import pytest

from data import graphs


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_benchmark_graph_matches_the_port(seed):
    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph

    mine = graphs.make_benchmark_graph(512, 6, 16, 8, seed)
    port = make_benchmark_graph(n=512, avg_degree=6, dim=16, num_classes=8,
                                seed=seed)
    assert mine.keys() == port.keys()
    for k in mine:
        np.testing.assert_array_equal(mine[k], port[k])


def test_hub_rule_matches_chip_smoke():
    import chip_smoke

    base = graphs.make_benchmark_graph(512, 6, 16, 8, 3)
    mine = graphs.hub_graph(base, 3, every=10, hubs=chip_smoke.HUB_NODES)
    theirs = chip_smoke.hub_graph(base, 3)
    np.testing.assert_array_equal(mine["edge_index"], theirs["edge_index"])


def test_make_graph_reads_the_skew():
    sizes = dict(num_nodes=64, avg_degree=4, num_features=8, num_classes=3)
    plain = graphs.make_graph(sizes, 1)
    hub = graphs.make_graph(dict(sizes, skew=dict(rule="hub", every=2,
                                                  hubs=2)), 1)
    assert (hub["edge_index"][1, ::2] < 2).all()
    assert not (plain["edge_index"][1, ::2] < 2).all()
    with pytest.raises(ValueError):
        graphs.make_graph(dict(sizes, skew=dict(rule="zipf")), 1)
