"""PyTorch port, JAX-free tests: the kernel wrappers' routing and guards
and, on a CUDA device, every kernel against its plain version, the
backward's run-to-run determinism, the predictor and the trainer
launching them, and the trainer's scan mode (one CUDA graph replayed).
This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without JAX:

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
    random tables, the forwards' residuals and outputs from their plain
    versions, a random output cotangent, and each backward's slot rows
    and branch for the reduce."""
    n_in = n_in or max(lay.sender_bound, 1)
    base = _args(rng, n_in, lay.num_nodes_padded, d, device)
    dout = torch.from_numpy(rng.normal(
        size=(lay.num_nodes_padded, d)).astype(np.float32)).to(device)
    sel, cat = _bwd_residuals(lay, base)
    dm, _, _, slot_c = fk.attention_sel_bwd_plain(lay, *base, *sel, dout,
                                                  SLOPE)
    dm2, _, _, slot_c2 = fk.attention_bwd_plain(lay, *base, *cat, dout,
                                                SLOPE)
    return [
        (fk.attention_sel_fwd, (lay, *base, SLOPE)),
        (fk.attention_fwd, (lay, *base, SLOPE)),
        (fk.attention_sel_bwd, (lay, *base, *sel, dout, SLOPE)),
        (fk.attention_bwd, (lay, *base, *cat, dout, SLOPE)),
        (fk.slot_reduce, (lay, dm, n_in, slot_c)),
        (fk.slot_reduce, (lay, dm2, n_in, slot_c2)),
    ]


def _bwd_residuals(lay, base):
    """What the two backwards take from their forwards, by the plain
    versions: ``(ex, den, out)`` and ``(alpha, out)``, ``out`` being the
    destination's branch."""
    out, ex, den = fk.attention_sel_fwd_plain(lay, *base, SLOPE)
    out2, alpha = fk.attention_fwd_plain(lay, *base, SLOPE)
    c, d = base[3], base[0].shape[1]
    return ((ex, den, out),
            (alpha, torch.where(c[:, None], out2[:, :d], out2[:, d:])))


def _gather_calls(rng, lay, d, n_in=64):
    """The padded SpMM's calls on ``lay``: unweighted and weighted
    forwards and a weighted transpose."""
    x = torch.from_numpy(rng.normal(size=(n_in, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(
        size=lay.slot_src.shape[0]).astype(np.float32))
    return [(fk.gather_reduce, (lay, x, lay.num_nodes_padded)),
            (fk.gather_reduce, (lay, x, lay.num_nodes_padded, w)),
            (fk.gather_reduce, (lay, x, n_in, w, True))]


_PLAIN = {
    fk.attention_sel_fwd: fk.attention_sel_fwd_plain,
    fk.attention_fwd: fk.attention_fwd_plain,
    fk.attention_sel_bwd: fk.attention_sel_bwd_plain,
    fk.attention_bwd: fk.attention_bwd_plain,
    fk.slot_reduce: fk.slot_reduce_plain,
    fk.gather_reduce: fk.gather_reduce_plain,
}


def _outputs(x):
    return x if isinstance(x, tuple) else (x,)


def test_wrappers_route_cpu_tensors_to_plain(rng):
    lay = _small_layout(rng)
    fk.reset_launch_counts()
    with fk.record_launches(keep_inputs=True) as records:
        for wrapper, args in (_all_calls(rng, lay, 8, n_in=64)
                              + _gather_calls(rng, lay, 8)):
            for g, w in zip(_outputs(wrapper(*args)),
                            _outputs(_PLAIN[wrapper](*args))):
                assert torch.equal(g, w)
    # plain runs launch nothing and record nothing
    assert records == []
    for wrapper in fk.KERNEL_WRAPPERS:
        assert wrapper.launches == 0 and wrapper.launches_by_d == {}


def test_wrappers_are_forward_only(rng):
    lay = _small_layout(rng)
    calls = _all_calls(rng, lay, 8, n_in=64) + _gather_calls(rng, lay, 8)
    assert {w for w, _ in calls} == set(fk.KERNEL_WRAPPERS)
    for wrapper, args in calls:
        # a float input that requires grad: the wrappers record no autograd
        i = 1 if wrapper in (fk.slot_reduce, fk.gather_reduce) else 5
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
    """The two backward kernels (taking the forward's ``out``, both
    writing a D-wide dm and the slots' branch) and the sender-keyed reduce
    of each one's dm by its branch against their plain versions on
    the card, f32 at rtol 1e-4 and atol 1e-4 times the output's largest
    magnitude: a hub row's dud and a hub sender's reduce each sum
    thousands of terms that cancel, in another order than the plain
    version's. The slots' branch flags exactly."""
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
    bit-identical gradients (no atomics anywhere in the kernels); the
    concatenated one goes through the D-wide dm and the split reduce,
    and both agree with the plain versions' gradients."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.ops.fused_attention import (
        AttentionCat,
        AttentionSel,
    )

    lay = _hub_layout(rng, dev)
    u1, u2, ud, c, a1, a2 = _args(rng, 64, 64, 64, dev)
    cot = torch.randn(64, 64, device=dev)
    lay_cpu = tbs.PaddedLayout(*(x.cpu() if torch.is_tensor(x) else x
                                 for x in lay))
    for fn in (AttentionSel, AttentionCat):
        grads = []
        for lay_, dev_ in ((lay, dev), (lay, dev), (lay_cpu, "cpu")):
            leaves = [t.to(dev_).clone().requires_grad_()
                      for t in (u1, u2, ud, a1, a2)]
            p1, p2, pd, q1, q2 = leaves
            out = fn.apply(lay_, p1, p2, pd, c.to(dev_), q1, q2, SLOPE)
            (out * cot.to(dev_)).sum().backward()
            grads.append([t.grad for t in leaves])
        for g0, g1, want in zip(*grads):
            assert torch.equal(g0, g1)
            torch.testing.assert_close(
                g0.cpu(), want, rtol=1e-4,
                atol=1e-4 * float(want.abs().max()))


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


# ------------------------------------------------- heavy rows and senders

HEAVY = tbs.HEAVY_SLOTS


def _edge_case_layout(rng, device="cpu"):
    """node_block 16 over 64 rows whose runs hold 0, 1, L, L+1 and 5L
    slots (rows 0-4), L+1 with ~30% masked (row 5), 2L all masked (row 6)
    and 3L as the last row of block 0 (row 15); rows 20-22 take 5L, L and
    L+1 slots from senders 1, 2 and 3 alone, so sender 1 and 3 are heavy
    and sender 2 sits on the bound; rows 32-47 are light, block 3 is
    empty. Other senders are drawn from [4, 64)."""
    count = {0: 0, 1: 1, 2: HEAVY, 3: HEAVY + 1, 4: 5 * HEAVY,
             5: HEAVY + 1, 6: 2 * HEAVY, 15: 3 * HEAVY,
             20: 5 * HEAVY, 21: HEAVY, 22: HEAVY + 1}
    count.update({r: int(rng.integers(0, 40)) for r in range(32, 48)})
    r = np.concatenate([np.full(c, row) for row, c in sorted(count.items())])
    s = rng.integers(4, 64, size=len(r))
    em = rng.random(len(r)) < 0.9
    for row, keep in ((5, 0.7), (6, 0.0)):
        em[r == row] = rng.random(count[row]) < keep
    for row, snd in ((20, 1), (21, 2), (22, 3)):
        s[r == row], em[r == row] = snd, True
    return tbs.make_blocked_ops(s, r, em, 64, node_block=16,
                                device=device).lay_dst


def _poison(dev, *shapes):
    """Hand the caching allocator NaN-filled blocks of these shapes, so an
    output element the kernel fails to write shows up."""
    filled = [torch.full(shape, float("nan"), device=dev) for shape in shapes]
    del filled


def _check_fwd_heavy_rows(rng, d, wrapper, plain, poison):
    """A forward against its plain version (rtol and atol 1e-4) on the
    edge-case layout, twice into NaN-filled memory of the ``poison``
    shapes, bit-identical; where D % 4 == 0 also with a u1 table 4 bytes
    off 16-byte alignment (the scalar-load path)."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    assert lay.dst_heavy.tolist() == [3, 4, 5, 6, 15, 20, 22]
    args = list(_args(rng, 64, 64, d, dev))
    variants = [args]
    if d % 4 == 0:
        buf = torch.empty(64 * d + 1, device=dev)
        u1 = buf[1:].view(64, d)
        u1.copy_(args[0])
        assert u1.data_ptr() % 16 != 0 and u1.is_contiguous()
        variants.append([u1] + args[1:])
    for a in variants:
        want = plain(lay, *a, SLOPE)
        runs = []
        for _ in range(2):
            _poison(dev, *poison(lay.slot_src.shape[0]))
            before = wrapper.launches
            runs.append(wrapper(lay, *a, SLOPE))
            assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        for g_, again, w_ in zip(*runs, want):
            assert torch.equal(g_, again)
            torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 63, 64, 256])
def test_cuda_attention_fwd_heavy_rows(rng, d):
    """The concatenated forward against its plain version (rtol and atol
    1e-4) on light rows, heavy rows, a heavy row with masked slots, one
    with every slot masked, a heavy last row of a block (its pad tail must
    be zeroed) and empty rows; two launches give bit-identical outputs.
    Where D % 4 == 0 a u1 table 4 bytes off 16-byte alignment takes the
    scalar-load path and must agree too."""
    _check_fwd_heavy_rows(rng, d, fk.attention_fwd, fk.attention_fwd_plain,
                          lambda n_slots: [(64, 2 * d), (n_slots,)])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 63, 64, 256, 257])
def test_cuda_attention_sel_fwd_heavy_rows(rng, d):
    """The selective forward on the same rows: out, ex under each row's
    final max (heavy blocks merge their warps' states and rescale the
    slots they wrote) and den, against its plain version at rtol and atol
    1e-4, bit-identical across two launches; D = 257 takes the wide
    path."""
    _check_fwd_heavy_rows(rng, d, fk.attention_sel_fwd,
                          fk.attention_sel_fwd_plain,
                          lambda n_slots: [(64, d), (n_slots,), (64,)])


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("w", [1, 16, 128, 512])
def test_cuda_slot_reduce_heavy_senders(rng, w, split):
    """The sender reduce against its plain version on heavy senders (5L
    and L+1 entries), a sender on the bound, light and empty senders, with
    the branch split and with every slot in branch 1: f32 rtol 1e-5 and atol 1e-5 times the
    output's largest magnitude (sums of up to 640 random rows in another
    order); two launches give bit-identical outputs."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    assert lay.src_heavy.tolist() == [1, 3]
    n_slots = lay.slot_src.shape[0]
    vals = torch.from_numpy(
        rng.normal(size=(n_slots, w)).astype(np.float32)).to(dev)
    branch = (torch.from_numpy((rng.random(n_slots) < 0.5).astype(np.uint8))
              if split else torch.ones(n_slots, dtype=torch.uint8)).to(dev)
    want = fk.slot_reduce_plain(lay, vals, 64, branch)
    runs = []
    for _ in range(2):
        _poison(dev, tuple(want.shape))
        runs.append(fk.slot_reduce(lay, vals, 64, branch))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    scale = float(want.abs().max())
    torch.testing.assert_close(runs[0], want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 63, 64, 256])
@pytest.mark.parametrize("form", ["sel", "concat"])
def test_cuda_attention_bwd_heavy_rows(rng, form, d):
    """Both backwards against their plain versions (rtol 1e-4, atol 1e-4
    times the output's largest magnitude; slot_c exactly) on light rows,
    heavy rows (a block each, merged in warp order), a heavy row with
    masked slots, one with every slot masked, a heavy last row of a block
    (its pad tail must be zeroed) and empty rows; two launches give
    bit-identical outputs. Outputs land in NaN-filled memory, so an
    element left unwritten shows. Where D % 4 == 0 a u1 table 4 bytes off
    16-byte alignment takes the scalar path and must agree too."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    assert lay.dst_heavy.tolist() == [3, 4, 5, 6, 15, 20, 22]
    args = list(_args(rng, 64, 64, d, dev))
    dout = torch.from_numpy(
        rng.normal(size=(64, d)).astype(np.float32)).to(dev)
    wrapper, plain = ((fk.attention_sel_bwd, fk.attention_sel_bwd_plain)
                      if form == "sel"
                      else (fk.attention_bwd, fk.attention_bwd_plain))
    n_slots = lay.slot_src.shape[0]
    variants = [args]
    if d % 4 == 0:
        buf = torch.empty(64 * d + 1, device=dev)
        u1 = buf[1:].view(64, d)
        u1.copy_(args[0])
        assert u1.data_ptr() % 16 != 0 and u1.is_contiguous()
        variants.append([u1] + args[1:])
    for a in variants:
        sel, cat = _bwd_residuals(lay, a)
        inputs = (lay, *a, *(sel if form == "sel" else cat), dout, SLOPE)
        want = plain(*inputs)
        runs = []
        for _ in range(2):
            _poison(dev, (n_slots, d), (64, d), (n_slots // 4 + 1,))
            before = wrapper.launches
            runs.append(wrapper(*inputs))
            assert wrapper.launches == before + 1
        torch.cuda.synchronize()
        for g_, again, w_ in zip(*runs, want):
            assert g_.shape == w_.shape and g_.dtype == w_.dtype
            assert torch.equal(g_, again)
            if g_.dtype == torch.uint8:
                assert torch.equal(g_, w_)
            else:
                torch.testing.assert_close(
                    g_, w_, rtol=1e-4, atol=1e-4 * float(w_.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [257, 512, 1030])
def test_cuda_wide_kernels_match_plain(rng, d):
    """All five kernels past the 256 columns a lane group holds (their
    wide path; 1030 is not a multiple of 4 and spans more than two of the
    reduce's 512-column chunks) against their plain versions on a single
    layout, the hub layout (a 3000-slot row and a 2500-entry sender), the
    edge-case layout (heavy rows, masked and empty rows, heavy senders)
    and degree tiers: two launches into NaN-filled memory give
    bit-identical outputs; forwards agree at rtol and atol 1e-4, the
    backwards and the reduce at rtol 1e-4 and atol 1e-4 times the
    output's largest magnitude, the branch flags exactly."""
    dev = _need_cuda()
    lays = _card_layouts(rng, dev) + [_edge_case_layout(rng, dev)]
    for lay in lays:
        for i, (wrapper, args) in enumerate(_all_calls(rng, lay, d, dev)):
            want = _outputs(_PLAIN[wrapper](*args))
            runs = []
            for _ in range(2):
                _poison(dev, *(tuple(w_.shape) for w_ in want))
                before = wrapper.launches
                runs.append(_outputs(wrapper(*args)))
                assert wrapper.launches == before + 1
            torch.cuda.synchronize()
            for g_, again, w_ in zip(*runs, want):
                assert g_.shape == w_.shape and g_.dtype == w_.dtype
                assert torch.equal(g_, again)
                if g_.dtype == torch.uint8:
                    assert torch.equal(g_, w_)
                    continue
                scale = 1.0 if i < 2 else float(w_.abs().max())
                torch.testing.assert_close(g_, w_, rtol=1e-4,
                                           atol=1e-4 * scale)


# ------------------------------------------------------------- scan mode


def _scan_data(rng, method):
    data = skewed_data(rng, n=200, c=4, d=12)
    if method == "blocked":   # uniform edges: one layout
        data["edge_index"] = rng.integers(0, 200, size=(2, 1600))
    data["test_mask"] = ~data["train_mask"]
    return data


def _scan_cfg(**kw):
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    return Stage2Config(**{**dict(num_epoch=9, hidden=16, lr=1e-2,
                                  step_size=3, scan_epochs=4, dropout=0.5,
                                  log_every=0), **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_scan_equals_loop(rng, method):
    """Scan mode on the card (2 eager epochs, one capture, 7 replays in
    chunks of 4, 4 and 1; the rate falls at epochs 4 and 7, inside
    chunks) against the per-epoch loop at dropout 0.5: the replays draw
    the loop's dropout masks, so the losses agree at the card's training
    tolerance (rtol 1e-4: scan mode's capturable Adam reads its rate from
    a tensor and orders its arithmetic otherwise than the loop's foreach
    Adam with a float rate) and the scores and the best epoch are
    equal."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import WARMUP_EPOCHS, train_ktgnn

    data = _scan_data(rng, method)
    loop = train_ktgnn(data, _scan_cfg(scan_epochs=0,
                                       adjacency_method=method), device=dev)
    scan = train_ktgnn(data, _scan_cfg(adjacency_method=method), device=dev)
    assert scan["scan"]["eager_epochs"] == WARMUP_EPOCHS
    assert scan["scan"]["captures"] == 1
    assert scan["scan"]["replays"] == 9 - WARMUP_EPOCHS
    for hs, hl in zip(scan["history"], loop["history"], strict=True):
        for key in ("loss", "loss_t2"):
            assert abs(hs[key] - hl[key]) <= 1e-4 * abs(hl[key]), hs
        assert {k: hs[k] for k in ("train", "val", "test")} == \
            {k: hl[k] for k in ("train", "val", "test")}, hs["epoch"]
    assert scan["best"]["epoch"] == loop["best"]["epoch"]


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_scan_replay_launches(rng, method):
    """Each replay launches the epoch's kernels: per layout 8 forwards
    (4 in the step, 4 in the eval), 4 backwards and 4 reduces, one at the
    hidden width and three at the classes'. The wrappers count the eager
    epochs and the capture once each; a replay counts nothing."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import WARMUP_EPOCHS, train_ktgnn

    fk.reset_launch_counts()
    res = train_ktgnn(_scan_data(rng, method),
                      _scan_cfg(adjacency_method=method), device=dev)
    tiered = method == "tiered"
    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if tiered
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    per = res["scan"]["launches_per_replay"]
    layouts = sum(per[fwd.__name__].values()) // 8
    assert layouts >= (2 if tiered else 1)
    want = {fwd.__name__: {16: 2 * layouts, 4: 6 * layouts},
            bwd.__name__: {16: layouts, 4: 3 * layouts},
            "slot_reduce": {16: layouts, 4: 3 * layouts}}
    assert per == want
    counted = WARMUP_EPOCHS + 1
    for name, by_d in want.items():
        wrapper = getattr(fk, name)
        assert wrapper.launches_by_d == {d: counted * n
                                         for d, n in by_d.items()}


@pytest.mark.cuda
def test_cuda_scan_runs_leave_no_device_memory_behind(rng):
    """Scan runs one after another in one process hold no more device
    memory after the second than after the first: every run captures on
    the device's one capture stream, so cuBLAS keeps one workspace for it
    (a new stream per run left a 65 MiB workspace behind on an H100)."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    data = _scan_data(rng, "blocked")
    after = []
    for _ in range(3):
        train_ktgnn(data, _scan_cfg(), device=dev)
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[2] <= after[1] <= after[0], after


@pytest.mark.cuda
def test_cuda_capture_refuses_record_launches(rng):
    """record_launches times launches with CUDA events; inside a capture
    those would time the capture, so the first launch captured raises."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    with fk.record_launches() as recs:
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            train_ktgnn(_scan_data(rng, "blocked"), _scan_cfg(), device=dev)
    assert recs    # the eager warm-up epochs were recorded


@pytest.mark.cuda
def test_cuda_scan_resume_matches_uninterrupted(rng, tmp_path):
    """A scan run stopped at a chunk boundary and resumed (whose first
    epochs run eagerly again before its own capture) gives the
    uninterrupted run's history, best and weights: the generator state
    after replays is the eager one's, and every kernel is deterministic."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    data = _scan_data(rng, "blocked")
    full = train_ktgnn(data, _scan_cfg(ckpt_dir=str(tmp_path / "a")),
                       device=dev)
    train_ktgnn(data, _scan_cfg(num_epoch=4, ckpt_dir=str(tmp_path / "b")),
                device=dev)
    resumed = train_ktgnn(data, _scan_cfg(ckpt_dir=str(tmp_path / "b"),
                                          resume=True), device=dev)
    assert [h["epoch"] for h in resumed["history"]] == list(range(5, 10))
    assert resumed["history"] == full["history"][4:]
    assert resumed["best"] == full["best"]
    for k, t in full["state_dict"].items():
        assert torch.equal(resumed["state_dict"][k], t), k


@pytest.mark.cuda
def test_cuda_resume_across_modes(rng, tmp_path):
    """Each mode resumes the other's checkpoint on the card: the loop
    (foreach Adam, a float rate) from a scan chunk boundary, and scan
    mode (capturable Adam, a tensor rate, its own capture) from a loop
    checkpoint. Adam keeps the kind its mode needs, so both run and give
    the uninterrupted runs' losses at the card's training tolerance."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    data = _scan_data(rng, "blocked")
    full = train_ktgnn(data, _scan_cfg(), device=dev)
    for first, then in ((4, 0), (0, 4)):
        ckpt = str(tmp_path / f"from_{first}")
        train_ktgnn(data, _scan_cfg(num_epoch=4, scan_epochs=first,
                                    ckpt_dir=ckpt, ckpt_every=4), device=dev)
        resumed = train_ktgnn(data, _scan_cfg(scan_epochs=then,
                                              ckpt_dir=ckpt, resume=True),
                              device=dev)
        assert (resumed["scan"] is not None) == bool(then)
        for hr, hf in zip(resumed["history"], full["history"][4:],
                          strict=True):
            assert hr["epoch"] == hf["epoch"]
            for key in ("loss", "loss_t2"):
                assert abs(hr[key] - hf[key]) <= 1e-4 * abs(hf[key]), hr


# ----------------------------------------------------- bf16 message tables

# One bf16 ulp, relative: bf16 keeps 8 significant bits, so neighbouring
# values lie at most 2^-7 of their magnitude apart. A rounding moves a
# value by at most half of that; two values within 1e-4 of each other
# may round to neighbours one ulp apart.
BF16_ULP = 2.0 ** -7


def _to_bf16(wrapper, args):
    """A call's message tables (the reduce's rows) in bf16."""
    idx = (1,) if wrapper is fk.slot_reduce else (1, 2, 3)
    return tuple(a.to(torch.bfloat16) if i in idx else a
                 for i, a in enumerate(args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 257])
def test_cuda_bf16_kernels_match_plain(rng, d):
    """The five kernels' bf16 instantiations (D = 257 on the wide path)
    against their plain versions on the same bf16 inputs on the card, on
    a single layout, the hub layout, the edge-case layout and degree
    tiers, each launched twice into NaN-filled memory for bit-identical
    outputs and counted under its bf16 key. The f32 outputs at the f32
    kernels' tolerances (forwards rtol and atol 1e-4, backwards and the
    reduce atol 1e-4 times the largest magnitude); dm, which both sides
    round to bf16 once, widened by one bf16 ulp (rtol 2^-7)."""
    dev = _need_cuda()
    lays = _card_layouts(rng, dev) + [_edge_case_layout(rng, dev)]
    for lay in lays:
        for i, (wrapper, args) in enumerate(_all_calls(rng, lay, d, dev)):
            args = _to_bf16(wrapper, args)
            want = _outputs(_PLAIN[wrapper](*args))
            runs = []
            for _ in range(2):
                _poison(dev, *(tuple(w_.shape) for w_ in want))
                before = wrapper.launches_by_d.get(
                    fk.launch_key(d, torch.bfloat16), 0)
                runs.append(_outputs(wrapper(*args)))
                assert wrapper.launches_by_d[
                    fk.launch_key(d, torch.bfloat16)] == before + 1
            torch.cuda.synchronize()
            for j, (g_, again, w_) in enumerate(zip(*runs, want)):
                assert g_.shape == w_.shape and g_.dtype == w_.dtype
                assert torch.equal(g_, again)
                if g_.dtype == torch.uint8:
                    assert torch.equal(g_, w_)
                    continue
                scale = 1.0 if i < 2 else float(w_.abs().max())
                dm = i in (2, 3) and j == 0
                assert g_.dtype == (torch.bfloat16 if dm else torch.float32)
                torch.testing.assert_close(
                    g_.float(), w_.float(),
                    rtol=1e-4 + (BF16_ULP if dm else 0.0), atol=1e-4 * scale)


def _bf16_model_data(rng, method):
    data = skewed_data(rng, n=200, c=4, d=12)
    if method == "blocked":   # uniform edges: one layout
        data["edge_index"] = rng.integers(0, 200, size=(2, 1600))
    data["test_mask"] = ~data["train_mask"]
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_bf16_predict_and_train(rng, method):
    """A bf16 model on the card: the predictor (f32 matmuls) launches
    only the bf16 forwards (4 per predict and layout) and answers as its
    CPU twin within one bf16 ulp (2^-7) of the largest log-probability; the
    production
    training setting (bf16 messages, precision "default", scan mode)
    launches the bf16 forwards, backwards and reduces, every loss finite,
    the first epoch's within two bf16 ulps of the CPU's."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train.stage2 import (
        Stage2Config,
        build_model,
        train_ktgnn,
    )

    data = _bf16_model_data(rng, method)
    model = build_model(Stage2Config(hidden=16, message_dtype="bfloat16"),
                        4, 12, device="cpu")
    want = KTGNNPredictor(model, None, data, adjacency_method=method,
                          device="cpu").predict()
    card = KTGNNPredictor(model, None, data, adjacency_method=method,
                          device=dev)
    layouts = len(card.adj.tiered_fn.tiers) if card.adj.tiered_fn else 1
    kernel = fk.attention_fwd if card.adj.tiered_fn else fk.attention_sel_fwd
    fk.reset_launch_counts()
    got = card.predict()
    assert kernel.launches_by_d == {"16:bf16": layouts, "4:bf16": 3 * layouts}
    for head in want:
        tol = BF16_ULP * float(np.abs(want[head]).max())
        np.testing.assert_allclose(got[head], want[head], atol=tol)

    cfg = Stage2Config(num_epoch=6, hidden=16, dropout=0.0,
                       adjacency_method=method, message_dtype="bfloat16",
                       matmul_precision="default")
    cpu = train_ktgnn(data, cfg, device="cpu")
    fk.reset_launch_counts()
    res = train_ktgnn(data, Stage2Config(**{**cfg.__dict__,
                                            "scan_epochs": 3}), device=dev)
    per = res["scan"]["launches_per_replay"]
    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if method == "tiered"
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    assert per == {fwd.__name__: {"16:bf16": 2 * layouts,
                                  "4:bf16": 6 * layouts},
                   bwd.__name__: {"16:bf16": layouts, "4:bf16": 3 * layouts},
                   "slot_reduce": {"16:bf16": layouts,
                                   "4:bf16": 3 * layouts}}
    losses = [h["loss"] for h in res["history"]]
    assert np.all(np.isfinite(losses))
    a, b = res["history"][0]["loss"], cpu["history"][0]["loss"]
    assert abs(a - b) <= 2 * BF16_ULP * abs(b)


# ------------------------------------------- the padded SpMM (zoo's kernel)


def _gather_inputs(rng, lay, d, dev, weighted):
    x = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32)).to(dev)
    w = (torch.from_numpy(rng.normal(size=lay.slot_src.shape[0]).astype(
        np.float32)).to(dev) if weighted else None)
    return x, w


def test_gather_reduce_walks_each_real_slot_once(rng):
    """The transposed walk's destination rows are the forward's: every
    real slot once, keyed by its sender, gathering its destination."""
    lay = _edge_case_layout(rng)
    row, valid = tbs.slot_rows(lay)
    slots = lay.src_slots.long()
    assert sorted(slots.tolist()) == torch.nonzero(valid)[:, 0].tolist()
    assert torch.equal(lay.src_dst.long(), row[slots])


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [8, 64, 128, 257, 512, 1030])
def test_cuda_gather_reduce_matches_plain(rng, d, weighted):
    """The padded SpMM kernel, forward (by destination, with heavy rows,
    a heavy row with masked slots, one all masked, empty rows) and
    transposed (by sender, with heavy senders), against its plain version:
    f32 rtol 1e-5 and atol 1e-5 times the output's largest magnitude (sums
    of up to 640 rows in another order); two launches into NaN-filled
    memory bit-identical; where D % 4 == 0 also from an x 4 bytes off
    16-byte alignment (the scalar-load path)."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    x, w = _gather_inputs(rng, lay, d, dev, weighted)
    variants = [x]
    if d % 4 == 0:
        buf = torch.empty(64 * d + 1, device=dev)
        shifted = buf[1:].view(64, d)
        shifted.copy_(x)
        assert shifted.data_ptr() % 16 != 0
        variants.append(shifted)
    for xv in variants:
        for transpose in (False, True):
            want = fk.gather_reduce_plain(lay, xv, 64, w, transpose)
            runs = []
            for _ in range(2):
                _poison(dev, (64, d))
                before = fk.gather_reduce.launches
                runs.append(fk.gather_reduce(lay, xv, 64, w, transpose))
                assert fk.gather_reduce.launches == before + 1
            torch.cuda.synchronize()
            assert torch.equal(runs[0], runs[1])
            scale = float(want.abs().max())
            torch.testing.assert_close(runs[0], want, rtol=1e-5,
                                       atol=1e-5 * scale)


BENCH_L2 = 52_428_800   # the H100's L2_cache_size


@pytest.mark.parametrize("d", [1, 3, 4, 8, 63, 64, 100, 128, 257, 512, 1030])
@pytest.mark.parametrize("n_x", [64, 16_384, 131_072, 1_000_000])
def test_gather_panels_cover_d_once(n_x, d):
    """The panel rule covers D's column quads once: a panel of a multiple
    of 4 columns, and the fewest panels of at most that width that hold
    every quad, each given at least one (the kernel's balanced split of
    the quads over them is held on the card by
    test_cuda_gather_reduce_panels_are_bit_identical); one panel when the
    table fits its share of L2."""
    panel = fk.gather_panel(n_x, d, BENCH_L2)
    assert 4 <= panel <= fk.MAX_PANEL and panel % 4 == 0
    n = fk.gather_panel_count(d, panel)
    m, q = -(-d // 4), panel // 4
    assert (n - 1) * q < m <= n * q
    assert n <= m
    fits = n_x * d * 4 <= fk.PANEL_L2_SHARE * BENCH_L2
    assert (n == 1) == (fits and d <= fk.MAX_PANEL) or (d <= 4 and n == 1)


def test_gather_panel_count_never_falls_as_the_table_grows():
    """More rows or more columns never give fewer panels; a panel never
    widens with more rows."""
    ds = list(range(1, 300)) + [512, 1030, 2048]
    ns = [1, 64, 4096, 16_384, 65_536, 98_304, 131_072, 196_608, 262_144,
          1 << 20, 1 << 24]
    count = {(n, d): fk.gather_panel_count(d, fk.gather_panel(n, d, BENCH_L2))
             for n in ns for d in ds}
    for n in ns:
        assert all(count[n, a] <= count[n, b] for a, b in zip(ds, ds[1:]))
    for d in ds:
        assert all(count[a, d] <= count[b, d] for a, b in zip(ns, ns[1:]))
        panels = [fk.gather_panel(n, d, BENCH_L2) for n in ns]
        if d > fk.MAX_PANEL:
            assert panels == sorted(panels, reverse=True)


@pytest.mark.parametrize("d,panels", [(64, 1), (128, 2), (512, 8),
                                      (1030, 17)])
def test_gather_panels_on_the_bench_graph(d, panels):
    """The bench graph's 131,072 rows on the H100's L2: D = 64 (33.5 MB)
    in one panel, the wider tables in 64-column panels."""
    panel = fk.gather_panel(131_072, d, BENCH_L2)
    assert panel == 64 and fk.gather_panel_count(d, panel) == panels


def test_gather_reduce_launch_refuses_what_the_kernel_does_not_take(rng):
    """Panels past MAX_PANEL or below 1 column raise before any launch
    (the check needs no card)."""
    lay = _edge_case_layout(rng)
    x, w = _gather_inputs(rng, lay, 256, "cpu", True)
    before = fk.gather_reduce.launches
    for panel in (fk.MAX_PANEL + 4, fk.MAX_PANEL + 1, 0, -4):
        with pytest.raises(ValueError):
            fk._gather_reduce_launch(lay, x, 64, w, False, panel)
    assert fk.gather_reduce.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "transpose"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [8, 64, 128, 257, 512, 1030])
def test_cuda_gather_reduce_panels_are_bit_identical(rng, d, weighted,
                                                     transpose):
    """The kernel at forced panel widths 4, 8, 16, 32, 64 and D (or the
    widest panel past it), on the edge-case layout (heavy and light rows
    both ways): every launch bit-identical to the default one. At the
    wider D the widths reach lane groups of every size from 1 to 32
    lanes, so both counts of entries in flight (4 and 8)."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    x, w = _gather_inputs(rng, lay, d, dev, weighted)
    want = fk.gather_reduce(lay, x, 64, w, transpose)
    for panel in (4, 8, 16, 32, 64, min(d, fk.MAX_PANEL)):
        _poison(dev, (64, d))
        got = fk._gather_reduce_launch(lay, x, 64, w, transpose, panel)
        torch.cuda.synchronize()
        assert torch.equal(got, want), panel


@pytest.mark.cuda
def test_cuda_gather_reduce_wrapper_routes_and_raises(rng):
    """CUDA tensors launch the kernel (counted under x's width); what the
    kernel does not take raises before any launch."""
    dev = _need_cuda()
    lay = _edge_case_layout(rng, dev)
    x, w = _gather_inputs(rng, lay, 16, dev, True)
    fk.reset_launch_counts()
    fk.gather_reduce(lay, x, 64, w)
    fk.gather_reduce(lay, x, 64, None, True)
    assert fk.gather_reduce.launches_by_d == {16: 2}
    bad = [
        ((lay, x.double(), 64, w), TypeError),
        ((lay, x, 64, w.double()), TypeError),
        ((lay, x[:10], 64, w), ValueError),
        ((lay, x, 64, w[:-1]), ValueError),
        ((lay, x.t(), 64, w), ValueError),
        ((lay, x.cpu().to(dev.type).t().contiguous().t(), 64, w),
         ValueError),
        ((lay, x, 2, w, True), ValueError),
        ((lay, x, 64, w.cpu()), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            fk.gather_reduce(*args)
    assert fk.gather_reduce.launches == 2


def _zoo_data(rng, method):
    data = skewed_data(rng, n=200, c=4, d=12)
    if method == "blocked":   # uniform edges: one layout
        data["edge_index"] = rng.integers(0, 200, size=(2, 1600))
    data["test_mask"] = ~data["train_mask"]
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
@pytest.mark.parametrize("name", ["GraphSAGE", "GCN", "APPNP"])
def test_cuda_zoo_trainer_launches_gather_reduce(rng, name, method):
    """A zoo model on the card aggregates through the SpMM kernel alone,
    per epoch and layout as the model implies, and follows its CPU twin's
    losses at dropout 0 (rtol 1e-4)."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

    data = _zoo_data(rng, method)
    cfg = Stage2Config(model_name=name, num_epoch=2, hidden=16, dropout=0.0,
                       adjacency_method=method)
    want = train_ktgnn(data, cfg, device="cpu")
    fk.reset_launch_counts()
    got = train_ktgnn(data, cfg, device=dev)
    counts = fk.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "gather_reduce": fk.gather_reduce.launches_by_d}
    # per epoch and layout: the train step's forwards and x-gradients and
    # the eval forward (GraphSAGE: 12 and 16 wide, the first conv's input
    # needs no gradient; GCN: after each linear, 16 and 4 wide; APPNP: 10
    # propagations at the 4 classes)
    per = {"GraphSAGE": {12: 2, 16: 3}, "GCN": {16: 3, 4: 3},
           "APPNP": {4: 30}}[name]
    layouts = fk.gather_reduce.launches // (2 * sum(per.values()))
    assert layouts >= (2 if method == "tiered" else 1)
    assert fk.gather_reduce.launches_by_d == {
        d: 2 * n * layouts for d, n in per.items()}
    for h_got, h_want in zip(got["history"], want["history"], strict=True):
        assert abs(h_got["loss"] - h_want["loss"]) <= 1e-4 * abs(
            h_want["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["blocked", "tiered"])
def test_cuda_zoo_scan_equals_loop(rng, method):
    """GraphSAGE without the scheduler in scan mode (one CUDA graph of an
    epoch replayed) against the per-epoch loop at dropout 0.5: losses at
    rtol 1e-4, scores and best epoch equal; each replay launches the SpMM
    kernel as a loop epoch does."""
    dev = _need_cuda()
    from bridged_gnn_tpu_torch.train.stage2 import WARMUP_EPOCHS, train_ktgnn

    data = _zoo_data(rng, method)
    kw = dict(model_name="GraphSAGE", use_scheduler=False,
              adjacency_method=method)
    loop = train_ktgnn(data, _scan_cfg(scan_epochs=0, **kw), device=dev)
    scan = train_ktgnn(data, _scan_cfg(**kw), device=dev)
    info = scan["scan"]
    assert (info["eager_epochs"], info["captures"], info["replays"]) == (
        WARMUP_EPOCHS, 1, 9 - WARMUP_EPOCHS)
    per = info["launches_per_replay"]
    assert set(per) == {"gather_reduce"}
    layouts = per["gather_reduce"][12] // 2
    assert per["gather_reduce"] == {12: 2 * layouts, 16: 3 * layouts}
    for hs, hl in zip(scan["history"], loop["history"], strict=True):
        assert abs(hs["loss"] - hl["loss"]) <= 1e-4 * abs(hl["loss"]), hs
        assert {k: hs[k] for k in ("train", "val", "test")} == \
            {k: hl[k] for k in ("train", "val", "test")}, hs["epoch"]
    assert scan["best"]["epoch"] == loop["best"]["epoch"]
