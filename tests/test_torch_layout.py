"""PyTorch port, the layouts' heavy-row lists: which destination rows and
senders get a thread block of their own in the two attention forwards,
the two attention backwards and the sender reduce, and the
chunked sums and merges those blocks take, checked on the CPU against
plain counts and the plain versions."""

import numpy as np
import pytest
import torch

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph
from bridged_gnn_tpu_torch.train.stage2 import to_undirected_np

from tests.test_torch_cuda import (
    SLOPE,
    _args,
    _bwd_residuals,
    _edge_case_layout,
    _hub_layout,
    random_edges,
    skewed_data,
)

L = tbs.HEAVY_SLOTS
WARPS = 16   # warps of a heavy block in csrc/attention_{fwd,bwd}.cu and
             # csrc/slot_reduce.cu


def _hub_graph(rng, n, undirected):
    """The skewed graph (~85% of edges on 8 hot destinations, ~1.2·n
    slots each); after to_undirected the hot nodes are heavy senders."""
    data = skewed_data(rng, n=n)
    if undirected:
        data = to_undirected_np(data)
    return with_self_loops(graph_from_dict(data))


def _expected(g, lay_rows):
    """Rows with more than L edges in their run (masked and pad edges
    included, as the runs hold them) and senders with more than L real
    edges, counted straight from the graph's edge arrays."""
    r, s = g.receivers.numpy(), g.senders.numpy()
    em = g.edge_mask.numpy()
    dst = np.bincount(r, minlength=lay_rows)
    src = np.bincount(s[em], minlength=g.num_nodes_padded)
    return np.flatnonzero(dst > L), np.flatnonzero(src > L)


@pytest.mark.parametrize("n,undirected", [(180, False), (400, True),
                                          (800, True)])
def test_heavy_lists_name_the_rows_above_the_bound(rng, n, undirected):
    g = _hub_graph(rng, n, undirected)
    lay = tbs.make_blocked_ops(g.senders.numpy(), g.receivers.numpy(),
                               g.edge_mask.numpy(), g.num_nodes_padded,
                               node_block=64).lay_dst
    want_dst, want_src = _expected(g, lay.num_blocks * lay.node_block)
    assert want_dst.size > 0
    assert (want_src.size > 0) == undirected
    for got, want in ((lay.dst_heavy, want_dst), (lay.src_heavy, want_src)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the kernels' own test: a run longer than L
    ranges = lay.dst_ranges.numpy()
    np.testing.assert_array_equal(
        np.flatnonzero(ranges[:, 1] - ranges[:, 0] > L), want_dst)


def test_heavy_lists_follow_each_tier(rng):
    """On degree tiers each tier lists its own heavy rows (tier-local row
    ids) and its own heavy senders (global ids)."""
    g = _hub_graph(rng, 400, True)
    tiers = adjacency_from_graph(g, method="tiered", node_block=64,
                                 device="cpu").tiered_fn.tiers
    assert len(tiers) >= 2
    heavy_rows = 0
    for t in tiers:
        lay = t.lay_dst
        ranges, src = lay.dst_ranges.numpy(), lay.slot_src.numpy()
        np.testing.assert_array_equal(
            lay.dst_heavy.numpy(),
            np.flatnonzero(ranges[:, 1] - ranges[:, 0] > L))
        per_sender = np.bincount(src[src >= 0], minlength=g.num_nodes_padded)
        np.testing.assert_array_equal(lay.src_heavy.numpy(),
                                      np.flatnonzero(per_sender > L))
        heavy_rows += lay.dst_heavy.numel()
    assert heavy_rows > 0


@pytest.mark.parametrize("node_block", [16, 64])
def test_heavy_lists_empty_without_heavy_rows(rng, node_block):
    s, r, em = random_edges(rng)
    lay = tbs.make_blocked_ops(s, r, em, 64, node_block=node_block).lay_dst
    for t in (lay.dst_heavy, lay.src_heavy):
        assert t.dtype == torch.int32 and t.shape == (0,)


def test_heavy_bound_is_inclusive(rng):
    """A run of exactly L slots stays light; L + 1 is heavy."""
    r = np.concatenate([np.zeros(L, np.int64), np.ones(L + 1, np.int64)])
    s = np.concatenate([np.full(L, 2), np.full(L + 1, 3)])
    lay = tbs.make_blocked_ops(s, r, np.ones(len(r), bool), 8,
                               node_block=8).lay_dst
    assert lay.dst_heavy.tolist() == [1]
    assert lay.src_heavy.tolist() == [3]


@pytest.mark.parametrize("w,split", [(1, False), (16, True), (128, False),
                                     (64, True)])
def test_chunked_sender_sums_equal_plain_reduce(rng, w, split):
    """Each heavy sender's entries summed in L-sized chunks, then the
    chunks in order (as a heavy block's warps merge), equal the plain
    reduce to 1e-6 relative; without the split every slot is in branch 1
    and the second half is zero."""
    lay = _hub_layout(rng)
    assert lay.src_heavy.numel() > 0
    n_slots = lay.slot_src.shape[0]
    vals = torch.from_numpy(rng.normal(size=(n_slots, w)).astype(np.float32))
    branch = (torch.from_numpy((rng.random(n_slots) < 0.5).astype(np.uint8))
              if split else torch.ones(n_slots, dtype=torch.uint8))
    want = fk.slot_reduce_plain(lay, vals, 64, branch)
    ranges, slots = lay.src_ranges.numpy(), lay.src_slots.numpy()
    v = vals.double().numpy()
    for snd in lay.src_heavy.tolist():
        entries = slots[ranges[snd, 0]:ranges[snd, 1]]
        assert len(entries) > L
        total = np.zeros(2 * w)
        for c0 in range(0, len(entries), L):
            part = entries[c0:c0 + L]
            if split:
                b = branch.numpy()[part].astype(bool)
                total += np.concatenate([v[part[b]].sum(0),
                                         v[part[~b]].sum(0)])
            else:
                total[:w] += v[part].sum(0)
        np.testing.assert_allclose(want[snd].numpy(), total, rtol=1e-6,
                                   atol=1e-6 * np.abs(total).max())


def _softmax_state(logit, m1, m2):
    """(max, sum, [acc1 ‖ acc2]) of one chunk of slots; masked slots have
    logit −inf."""
    ok = np.isfinite(logit)
    if not ok.any():
        return -np.inf, 0.0, np.zeros(m1.shape[1] * 2)
    mx = logit[ok].max()
    ex = np.where(ok, np.exp(np.where(ok, logit, 0) - mx), 0.0)
    return mx, ex.sum(), ex @ np.concatenate([m1, m2], 1)


@pytest.mark.parametrize("form", ["sel", "concat"])
@pytest.mark.parametrize("d", [1, 8, 64])
def test_heavy_row_state_merge_equals_plain_forward(rng, form, d):
    """A heavy row split into the block's contiguous warp chunks, each
    chunk's softmax state taken alone and the states merged in warp order
    under the row's maximum (the heavy block's merge), gives the plain
    forward's output row and its per-slot weights: α for the
    concatenated forward; for the selective one the destination's branch
    of the output, ex under the row's final max (0 on masked slots) and
    den. To the forward kernels' tolerance (the plain version sums ~3000
    slots in f32, the merge here in f64)."""
    lay = _hub_layout(rng)
    n_in = lay.sender_bound
    u1, u2, ud, c, a1, a2 = _args(rng, n_in, lay.num_nodes_padded, d)
    if form == "concat":
        out, alpha = fk.attention_fwd_plain(lay, u1, u2, ud, c, a1, a2,
                                            SLOPE)
    else:
        out, ex, den_out = fk.attention_sel_fwd_plain(lay, u1, u2, ud, c,
                                                      a1, a2, SLOPE)
    assert lay.dst_heavy.numel() > 0
    for row in lay.dst_heavy.tolist():
        lo, hi = lay.dst_ranges[row].tolist()
        assert hi - lo > L
        src = lay.slot_src[lo:hi].numpy()
        s = np.clip(src, 0, None)
        m1, m2 = u1.double().numpy()[s], u2.double().numpy()[s]
        a = (a1 if c[row] else a2).double().numpy()
        z = (m1 if c[row] else m2) + ud[row].double().numpy()
        logit = np.where(src >= 0, np.where(z >= 0, z, SLOPE * z) @ a,
                         -np.inf)
        chunk = -(-(hi - lo) // WARPS)
        states = [_softmax_state(logit[w0:w0 + chunk], m1[w0:w0 + chunk],
                                 m2[w0:w0 + chunk])
                  for w0 in range(0, hi - lo, chunk)]
        mx = max(st[0] for st in states)
        scale = [np.exp(st[0] - mx) if np.isfinite(st[0]) else 0.0
                 for st in states]
        den = sum(st[1] * sc for st, sc in zip(states, scale)) or 1.0
        acc = sum(st[2] * sc for st, sc in zip(states, scale))
        want_ex = np.where(src >= 0, np.exp(logit - mx), 0.0)
        if form == "concat":
            np.testing.assert_allclose(out[row].numpy(), acc / den,
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(alpha[lo:hi].numpy(), want_ex / den,
                                       rtol=1e-4, atol=1e-7)
        else:
            half = acc[:d] if c[row] else acc[d:]
            np.testing.assert_allclose(out[row].numpy(), half / den,
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(ex[lo:hi].numpy(), want_ex,
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(float(den_out[row]), den, rtol=1e-4)


def _bwd_chunk(src, w, m, go, ov, dst, a, den):
    """dud and da of one chunk of a row's slots, in f64, with the row's
    softmax term S_v = dout · out taken from the whole row."""
    ok = src >= 0
    alpha = np.where(ok, w / den, 0.0)
    dl = alpha * (m @ go) - alpha * (go @ ov)
    z = m + dst
    gate = np.where(z > 0, 1.0, SLOPE)
    h = np.where(z >= 0, z, SLOPE * z)
    dz = dl[:, None] * a * gate
    return dz.sum(0), (dl[:, None] * h).sum(0), alpha[:, None] * go + dz


@pytest.mark.parametrize("form", ["sel", "concat"])
@pytest.mark.parametrize("d", [1, 8, 64])
def test_heavy_row_bwd_merge_equals_plain_backward(rng, form, d):
    """Each heavy row split into the block's contiguous warp chunks, each
    chunk's dud and da partials taken alone and summed in warp order (the
    heavy block's merge), gives the plain backward's dud row, the row's
    share of [da1 ‖ da2] (the plain backward with dout zero on every
    other row) and its slots' dm. All in f64, to 1e-9: the heavy rows of
    the edge-case layout include rows whose every slot reads one sender,
    where dα = S_v and the true gradient is 0, so f32 would compare
    rounding noise."""
    lay = _edge_case_layout(rng)
    base = tuple(t.double() if t.is_floating_point() else t
                 for t in _args(rng, 64, 64, d))
    u1, u2, ud, c, a1, a2 = base
    sel, cat = _bwd_residuals(lay, base)
    res = sel if form == "sel" else cat
    plain = (fk.attention_sel_bwd_plain if form == "sel"
             else fk.attention_bwd_plain)
    dout = torch.from_numpy(rng.normal(size=(64, d)))
    out = res[-1]
    assert lay.dst_heavy.numel() == 7
    for row in lay.dst_heavy.tolist():
        only = torch.zeros_like(dout)
        only[row] = dout[row]
        dm, dud, da, _ = plain(lay, *base, *res, only, SLOPE)
        lo, hi = lay.dst_ranges[row].tolist()
        src = lay.slot_src[lo:hi].numpy()
        is_c = bool(c[row])
        m = (u1 if is_c else u2).numpy()[np.clip(src, 0, None)]
        w = res[0].numpy()[lo:hi]
        den = float(res[1][row]) if form == "sel" else 1.0
        a = (a1 if is_c else a2).numpy()
        chunk = -(-(hi - lo) // WARPS)
        parts = [_bwd_chunk(src[w0:w0 + chunk], w[w0:w0 + chunk],
                            m[w0:w0 + chunk], dout[row].numpy(),
                            out[row].numpy(), ud[row].numpy(), a, den)
                 for w0 in range(0, hi - lo, chunk)]
        dm_row = np.concatenate([p[2] for p in parts])
        dm_row[src < 0] = 0.0
        for got, want in ((dud[row], sum(p[0] for p in parts)),
                          (da[:d] if is_c else da[d:],
                           sum(p[1] for p in parts)),
                          (dm[lo:hi], dm_row)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                       atol=1e-9)
        assert np.all((da[d:] if is_c else da[:d]).numpy() == 0)
