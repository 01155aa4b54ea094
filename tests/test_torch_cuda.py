"""PyTorch port, JAX-free tests: the kernel wrappers' routing and guards
and, on a CUDA device, every kernel against its plain version, the
backward's run-to-run determinism, and the predictor and the trainer
launching them. This file imports neither JAX nor the JAX
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


def _all_calls(rng, lay, d, device="cpu", n_in=None):
    """One argument tuple per kernel wrapper on ``lay`` at width ``d``:
    random tables, the forwards' residuals from their plain versions, a
    random output cotangent, and the selective backward's slot rows and
    branch for the reduce."""
    n_in = n_in or max(lay.sender_bound, 1)
    base = _args(rng, n_in, lay.num_nodes_padded, d, device)
    u1, u2, ud, c, a1, a2 = base
    _, ex, den = fk.attention_sel_fwd_plain(lay, *base, SLOPE)
    _, alpha = fk.attention_fwd_plain(lay, *base, SLOPE)
    dout = torch.from_numpy(rng.normal(
        size=(lay.num_nodes_padded, d)).astype(np.float32)).to(device)
    dm, _, _, slot_c = fk.attention_sel_bwd_plain(lay, *base, ex, den, dout,
                                                  SLOPE)
    dm2, _, _ = fk.attention_bwd_plain(lay, *base, alpha, dout, SLOPE)
    return [
        (fk.attention_sel_fwd, (lay, *base, SLOPE)),
        (fk.attention_fwd, (lay, *base, SLOPE)),
        (fk.attention_sel_bwd, (lay, *base, ex, den, dout, SLOPE)),
        (fk.attention_bwd, (lay, *base, alpha, dout, SLOPE)),
        (fk.slot_reduce, (lay, dm, n_in, slot_c)),
        (fk.slot_reduce, (lay, dm2, n_in, None)),
    ]


_PLAIN = {
    fk.attention_sel_fwd: fk.attention_sel_fwd_plain,
    fk.attention_fwd: fk.attention_fwd_plain,
    fk.attention_sel_bwd: fk.attention_sel_bwd_plain,
    fk.attention_bwd: fk.attention_bwd_plain,
    fk.slot_reduce: fk.slot_reduce_plain,
}


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def test_wrappers_route_cpu_tensors_to_plain(rng):
    lay = _small_layout(rng)
    fk.reset_launch_counts()
    with fk.record_launches(keep_inputs=True) as records:
        for wrapper, args in _all_calls(rng, lay, 8, n_in=64):
            for g, w in zip(_outputs(wrapper(*args)),
                            _outputs(_PLAIN[wrapper](*args))):
                assert torch.equal(g, w)
    # plain runs launch nothing and record nothing
    assert records == []
    for wrapper in fk.KERNEL_WRAPPERS:
        assert wrapper.launches == 0 and wrapper.launches_by_d == {}


def test_wrappers_are_forward_only(rng):
    lay = _small_layout(rng)
    calls = _all_calls(rng, lay, 8, n_in=64)
    assert {w for w, _ in calls} == set(fk.KERNEL_WRAPPERS)
    for wrapper, args in calls:
        # a float input that requires grad: the wrappers record no autograd
        i = 5 if wrapper is not fk.slot_reduce else 1
        args = list(args)
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="requires grad"):
            wrapper(*args)
        with torch.no_grad():  # no graph recorded: allowed
            wrapper(*args)


def test_sender_csr_lists_each_real_slot_once_by_sender(rng):
    """The sender-keyed index: every real slot once, grouped by sender in
    ascending slot order (a stable sort), pad and masked slots left out."""
    for lay in (_small_layout(rng), _hub_layout(rng)):
        src = lay.slot_src.numpy()
        real = np.flatnonzero(src >= 0)
        slots = lay.src_slots.numpy()
        assert sorted(slots.tolist()) == real.tolist()
        ranges = lay.src_ranges.numpy()
        assert ranges[0, 0] == 0 and ranges[-1, 1] == len(slots)
        assert np.array_equal(ranges[1:, 0], ranges[:-1, 1])
        for r in range(ranges.shape[0]):
            run = slots[ranges[r, 0]:ranges[r, 1]]
            assert np.all(src[run] == r) and np.all(np.diff(run) > 0)


def _hub_layout(rng, device="cpu"):
    """node_block 16 over 64 rows: destination 0 takes 3000 edges (a hub
    row), sender 1 sends 2500 of them (a hub sender), 10% of edges are
    masked, and rows 40-63 have no edge."""
    n_hub, n = 3000, 400
    r = np.concatenate([np.zeros(n_hub, np.int64),
                        rng.integers(1, 40, size=n)])
    s = np.concatenate([np.where(np.arange(n_hub) < 2500, 1,
                                 rng.integers(0, 64, size=n_hub)),
                        rng.integers(0, 64, size=n)])
    em = rng.random(len(r)) < 0.9
    order = np.argsort(r, kind="stable")
    return tbs.make_blocked_ops(s[order], r[order], em[order], 64,
                                node_block=16, device=device).lay_dst


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


def _card_layouts(rng, dev):
    """A single layout with masked edges and empty rows, the hub layout
    (a 3000-slot destination row and a 2500-slot sender), and degree
    tiers."""
    g = with_self_loops(graph_from_dict(skewed_data(rng, n=200, d=4)))
    lays = [_small_layout(rng, dev), _hub_layout(rng, dev)]
    lays += [t.lay_dst for t in adjacency_from_graph(
        g, method="tiered", node_block=128, device=dev).tiered_fn.tiers]
    return lays


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 64, 256])
def test_cuda_backward_kernels_match_plain(rng, d):
    """The two backward kernels and the sender-keyed reduce (with and
    without the branch split) against their plain versions on the card,
    f32 at rtol 1e-4 and atol 1e-4 times the output's largest magnitude:
    a hub row's dud and a hub sender's reduce each sum thousands of terms
    that cancel, in another order than the plain version's. The slots'
    branch flags exactly."""
    dev = _need_cuda()
    for lay in _card_layouts(rng, dev):
        for wrapper, args in _all_calls(rng, lay, d, dev)[2:]:
            before = wrapper.launches
            got = _outputs(wrapper(*args))
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            want = _outputs(_PLAIN[wrapper](*args))
            assert len(got) == len(want)
            for g_, w_ in zip(got, want):
                assert g_.shape == w_.shape and g_.dtype == w_.dtype
                if g_.dtype == torch.uint8:
                    assert torch.equal(g_, w_)
                else:
                    scale = float(w_.abs().max())
                    torch.testing.assert_close(g_, w_, rtol=1e-4,
                                               atol=1e-4 * scale)


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(rng):
    """Two backwards of each attention Function on the same inputs give
    bit-identical gradients (no atomics anywhere in the kernels)."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.ops.fused_attention import (
        AttentionCat,
        AttentionSel,
    )

    lay = _hub_layout(rng, dev)
    u1, u2, ud, c, a1, a2 = _args(rng, 64, 64, 64, dev)
    cot = torch.randn(64, 64, device=dev)
    for fn in (AttentionSel, AttentionCat):
        grads = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (u1, u2, ud, a1,
                                                           a2)]
            p1, p2, pd, q1, q2 = leaves
            out = fn.apply(lay, p1, p2, pd, c, q1, q2, SLOPE)
            (out * cot).sum().backward()
            grads.append([t.grad for t in leaves])
        for g0, g1 in zip(*grads):
            assert torch.equal(g0, g1)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_trainer_launches_kernels(rng, method):
    """train_ktgnn on the card launches, per epoch and layout, 8
    forwards (4 in the step, 4 in the eval), 4 backwards and 4 reduces,
    and with dropout 0 follows its CPU twin's losses."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

    data = skewed_data(rng, n=200, c=4, d=12)
    if method == "blocked":   # uniform edges: one layout
        data["edge_index"] = rng.integers(0, 200, size=(2, 1600))
    data["test_mask"] = ~data["train_mask"]
    cfg = Stage2Config(num_epoch=2, hidden=16, dropout=0.0,
                       adjacency_method=method)
    want = train_ktgnn(data, cfg, device="cpu")
    fk.reset_launch_counts()
    got = train_ktgnn(data, cfg, device=dev)
    tiered = method == "tiered"
    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if tiered
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    layouts = fwd.launches // 16
    assert layouts >= (2 if tiered else 1)
    assert fwd.launches_by_d == {16: 4 * layouts, 4: 12 * layouts}
    assert bwd.launches_by_d == {16: 2 * layouts, 4: 6 * layouts}
    assert fk.slot_reduce.launches_by_d == bwd.launches_by_d
    for h_got, h_want in zip(got["history"], want["history"]):
        for key in ("loss", "loss_t2"):
            assert abs(h_got[key] - h_want[key]) <= 1e-4 * abs(h_want[key])
