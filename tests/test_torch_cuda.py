"""PyTorch port, JAX-free tests: the kernel wrappers' routing and guards
and, on a CUDA device, both kernels against their plain versions and the
predictor launching them. This file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The data helpers here are shared with the other tests/test_torch_*.py.
"""

import numpy as np
import pytest
import torch

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph

SLOPE = 0.1


def skewed_data(rng, n=180, c=4, d=12):
    """~85% of edges land on 8 hot destinations (top-k pile-up shape)."""
    e = 8 * n
    hot = rng.integers(0, 8, size=e)
    cold = rng.integers(0, n, size=e)
    dst = np.where(rng.random(e) < 0.85, hot, cold)
    src = rng.integers(0, n, size=e)
    central = np.zeros(n, dtype=bool)
    central[rng.permutation(n)[: n // 2]] = True
    return dict(
        x=rng.normal(size=(n, d)).astype(np.float32),
        edge_index=np.stack([src, dst]),
        y=rng.integers(0, c, size=n),
        train_mask=~central,
        val_mask=np.zeros(n, dtype=bool),
        test_mask=np.zeros(n, dtype=bool),
        central_mask=central,
    )


def random_edges(rng, n=50, n_pad=64, e=300, e_pad=384):
    """Dst-sorted edges with masked edges inside the runs and a padded
    tail (the JAX fused-attention tests' graph)."""
    r = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    s = rng.integers(0, n, size=e).astype(np.int32)
    em = np.zeros(e_pad, dtype=bool)
    em[:e] = rng.random(e) < 0.9
    senders = np.zeros(e_pad, np.int32)
    receivers = np.full(e_pad, n_pad - 1, np.int32)
    senders[:e], receivers[:e] = s, r
    order = np.argsort(receivers, kind="stable")
    return senders[order], receivers[order], em[order]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _args(rng, n_in, n_out, d, device="cpu"):
    def t(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device)

    central = torch.from_numpy(rng.random(n_out) < 0.5).to(device)
    return t(n_in, d), t(n_in, d), t(n_out, d), central, t(d), t(d)


def _small_layout(rng, device="cpu"):
    s, r, em = random_edges(rng)
    return tbs.make_blocked_ops(s, r, em, 64, node_block=16,
                                device=device).lay_dst


def test_wrappers_route_cpu_tensors_to_plain(rng):
    lay = _small_layout(rng)
    args = _args(rng, 64, 64, 8)
    fk.reset_launch_counts()
    with fk.record_launches(keep_inputs=True) as records:
        for wrapper, plain in (
                (fk.attention_sel_fwd, fk.attention_sel_fwd_plain),
                (fk.attention_fwd, fk.attention_fwd_plain)):
            for g, w in zip(wrapper(lay, *args, SLOPE),
                            plain(lay, *args, SLOPE)):
                assert torch.equal(g, w)
    # plain runs launch nothing and record nothing
    assert records == []
    for wrapper in fk.KERNEL_WRAPPERS:
        assert wrapper.launches == 0 and wrapper.launches_by_d == {}


def test_wrappers_are_forward_only(rng):
    lay = _small_layout(rng)
    u1, u2, ud, c, a1, a2 = _args(rng, 64, 64, 8)
    a1 = a1.clone().requires_grad_()
    for wrapper in fk.KERNEL_WRAPPERS:
        with pytest.raises(RuntimeError, match="requires grad"):
            wrapper(lay, u1, u2, ud, c, a1, a2, SLOPE)
        with torch.no_grad():  # no graph recorded: allowed
            wrapper(lay, u1, u2, ud, c, a1, a2, SLOPE)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 100, 256])
def test_cuda_kernels_match_plain(rng, d):
    """Each kernel against its plain version on the card, on a single
    layout with masked edges and on degree tiers."""
    dev = _need_cuda()
    g = with_self_loops(graph_from_dict(skewed_data(rng, n=200, d=4)))
    lays = [_small_layout(rng, dev)]
    lays += [t.lay_dst for t in adjacency_from_graph(
        g, method="tiered", node_block=128, device=dev).tiered_fn.tiers]
    for lay in lays:
        args = _args(rng, max(lay.sender_bound, 1), lay.num_nodes_padded, d,
                     dev)
        for wrapper, plain in (
                (fk.attention_sel_fwd, fk.attention_sel_fwd_plain),
                (fk.attention_fwd, fk.attention_fwd_plain)):
            before = wrapper.launches
            got = wrapper(lay, *args, SLOPE)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            for g_, w_ in zip(got, plain(lay, *args, SLOPE)):
                torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_predictor_launches_kernels(rng, method):
    """The predictor on the card goes through the kernels (4 attention
    calls per predict and layout) and matches its CPU twin."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, build_model

    data = skewed_data(rng, n=200, c=4, d=12)
    model = build_model(Stage2Config(hidden=16), 4, 12, device="cpu")
    cpu = KTGNNPredictor(model, None, data, adjacency_method=method,
                         device="cpu")
    want = cpu.predict()
    card = KTGNNPredictor(model, None, data, adjacency_method=method,
                          device=dev)
    kernel = fk.attention_fwd if card.adj.tiered_fn else fk.attention_sel_fwd
    layouts = len(card.adj.tiered_fn.tiers) if card.adj.tiered_fn else 1
    fk.reset_launch_counts()
    with fk.record_launches() as records:
        got = card.predict()
    assert kernel.launches == 4 * layouts
    # the conv at hidden 16, the three head calls at 4 classes
    assert kernel.launches_by_d == {16: layouts, 4: 3 * layouts}
    assert [r["name"] for r in records] == [kernel.__name__] * 4 * layouts
    for head in want:
        np.testing.assert_allclose(got[head], want[head], atol=1e-4)
