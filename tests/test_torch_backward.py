"""PyTorch port, attention backward: the sender-keyed index against the
JAX package's src-keyed layout, the plain versions of the two backward
kernels and of the sender-keyed reduce against the JAX package's Pallas
kernels in interpret mode, the autograd Functions' gradients against
``jax.grad`` through the JAX custom VJPs (kernel forward and backward,
interpret mode), and ``gradcheck`` in float64. The kernels themselves run
on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
from bridged_gnn_tpu.ops import blocked_segment as jbs
from bridged_gnn_tpu.ops import fused_attention as jfa
from bridged_gnn_tpu.ops.pallas_fused import (
    _attention_sel_bwd_call,
    adapted_attention_bwd_pallas,
)
from bridged_gnn_tpu.ops.pallas_padded import slot_reduce_pallas
from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops import fused_attention as tfa
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph

from tests.test_torch_cuda import random_edges, skewed_data
from tests.test_torch_fused_kernels import (
    CASES,
    N,
    N_PAD,
    SLOPE,
    WIDE,
    _inputs,
    _jax_concat_kernel,
    _jax_sel_kernel,
    _jax_sel_operands,
    _layouts,
    _port_args,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _close(got, want, scaled=False):
    """``got`` against ``want`` at TOL; ``scaled`` takes atol times the
    largest magnitude of ``want`` (at least 1), for the wide widths, where
    dα and the da and dud sums add 257–512 products per slot and entries
    that cancel to near zero carry f32 rounding of that size."""
    tol = dict(TOL)
    if scaled:
        tol["atol"] *= max(float(np.abs(np.asarray(want)).max()), 1.0)
    np.testing.assert_allclose(got, want, **tol)


def _jax_sender_csr(lay_src, sfd):
    """The real slots of the JAX src-keyed layout, in its slot order: the
    dst-layout slot each one reads (``src_from_dst``) and its sender."""
    b, et, nb = lay_src.num_blocks, lay_src.tile_e, lay_src.node_block
    real = np.asarray(lay_src.slot_mask).reshape(-1)
    sender = (np.arange(b)[:, None] * nb
              + np.asarray(lay_src.rel_key)).reshape(-1)
    return np.asarray(sfd)[real], sender[real]


def _port_sender_csr(lay):
    r = lay.src_ranges.numpy()
    sender = np.repeat(np.arange(r.shape[0]), r[:, 1] - r[:, 0])
    return lay.src_slots.numpy(), sender


def _tiered_pair(data, nb):
    gj = j_with_self_loops(j_graph_from_dict(dict(data)))
    gt = with_self_loops(graph_from_dict(dict(data)))
    tops_j = j_adj(gj, method="tiered", node_block=nb).tiered_fn
    tops_t = adjacency_from_graph(gt, method="tiered", node_block=nb,
                                  device="cpu").tiered_fn
    assert len(tops_t.tiers) == len(tops_j.tiers) >= 2
    return gt, tops_j, tops_t


@pytest.mark.parametrize("nb", [16, 64, 128])
def test_sender_csr_matches_jax_src_layout(rng, nb):
    """src_slots is JAX's src_from_dst over the real slots of its
    src-keyed layout, in the same order, and src_ranges its senders."""
    s, r, em = random_edges(rng, n=50, n_pad=N_PAD)
    ops_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb)
    lay_t = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb).lay_dst
    want = _jax_sender_csr(ops_j.lay_src, ops_j.src_from_dst)
    got = _port_sender_csr(lay_t)
    assert lay_t.src_ranges.shape == (N_PAD, 2)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)
    # masked edges are left out
    assert len(got[0]) == int(em.sum())


@pytest.mark.parametrize("nb", [16, 64])
def test_sender_csr_matches_jax_tiers(rng, nb):
    _, tops_j, tops_t = _tiered_pair(skewed_data(rng, n=150), nb)
    for tj, tt in zip(tops_j.tiers, tops_t.tiers):
        want = _jax_sender_csr(tj.lay_src, tj.src_from_dst)
        got = _port_sender_csr(tt.lay_dst)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_, w_)


def _dout(rng, n_out, d):
    return rng.normal(size=(n_out, d)).astype(np.float32)


def _blocks(a, lay_j):
    """[n_out, D] rows padded to the layout's [B, nb, D] blocks."""
    b, nb = lay_j.num_blocks, lay_j.node_block
    pad = np.zeros((b * nb, a.shape[1]), np.float32)
    pad[: a.shape[0]] = a
    return jnp.asarray(pad.reshape(b, nb, -1))


def _check_sel_bwd(lay_j, lay_t, inp, dout, scaled=False):
    """The selective plain backward (``S_v`` from the forward's ``out``)
    against _attention_sel_bwd_kernel (``S_v`` as its segment sum of
    α·dα), at TOL (``scaled``: see :func:`_close`); returns the port's
    outputs and the slots' rows."""
    nb, d = lay_j.node_block, inp["u1"].shape[1]
    _, alpha_j = _jax_sel_kernel(lay_j, inp)
    b, et = lay_j.num_blocks, lay_j.tile_e
    dm_j, dud_j, da_j = _attention_sel_bwd_call(
        lay_j.rel_key, *_jax_sel_operands(lay_j, inp),
        jnp.asarray(inp["a1"])[None], jnp.asarray(inp["a2"])[None],
        jnp.asarray(alpha_j.reshape(b, et, 1).astype(np.float32)),
        _blocks(dout, lay_j), nb, SLOPE, interpret=True)
    args = _port_args(inp)
    out, ex, den = fk.attention_sel_fwd_plain(lay_t, *args, SLOPE)
    got = fk.attention_sel_bwd_plain(lay_t, *args, ex, den, out,
                                     torch.from_numpy(dout), SLOPE)
    dm, dud, da, slot_c = got
    row, valid = tbs.slot_rows(lay_t)
    valid = valid.numpy()
    _close(dm.numpy()[valid], np.asarray(dm_j).reshape(b * et, d)[valid],
           scaled)
    assert np.all(dm.numpy()[~valid] == 0)
    assert np.all(slot_c.numpy()[~valid] == 0)
    np.testing.assert_array_equal(slot_c.numpy()[valid],
                                  inp["central"][row.numpy()[valid]])
    _close(dud.numpy(), np.asarray(dud_j).reshape(-1, d)[:len(dout)],
           scaled)
    _close(da.numpy(), np.asarray(da_j)[:, 0].sum(0), scaled)
    return got, out, row.numpy(), valid


def _check_concat_bwd(lay_j, lay_t, inp, dout, scaled=False):
    """The concatenated plain backward against _attention_bwd_kernel: the
    port's D-wide ``dm`` is the selected half of the TPU kernel's 2D
    ``dm``, whose other half is zero, and ``slot_c`` is the destination's
    flag on real slots. At TOL (``scaled``: see :func:`_close`)."""
    d = inp["u1"].shape[1]
    _, alpha_j = _jax_concat_kernel(lay_j, inp)
    b, et = lay_j.num_blocks, lay_j.tile_e
    u_cat = np.concatenate([inp["u1"], inp["u2"]], axis=1)
    m = u_cat[np.asarray(lay_j.other_slot)].reshape(b, et, -1)
    dm_j, du1_j, du2_j, da1_j, da2_j = adapted_attention_bwd_pallas(
        lay_j, jnp.asarray(m), jnp.asarray(inp["u1_dst"]),
        jnp.asarray(inp["u2_dst"]),
        jnp.asarray(inp["central"].astype(np.float32)),
        jnp.asarray(inp["a1"]), jnp.asarray(inp["a2"]),
        jnp.asarray(alpha_j.reshape(b, et).astype(np.float32)),
        jnp.asarray(dout), negative_slope=SLOPE, interpret=True)
    args = _port_args(inp)
    out2, alpha = fk.attention_fwd_plain(lay_t, *args, SLOPE)
    out = torch.where(args[3][:, None], out2[:, :d], out2[:, d:])
    got = fk.attention_bwd_plain(lay_t, *args, alpha, out,
                                 torch.from_numpy(dout), SLOPE)
    dm, dud, da, slot_c = got
    row, valid = tbs.slot_rows(lay_t)
    row, valid = row.numpy(), valid.numpy()
    c_slot = inp["central"][row] & valid
    dm_j = np.asarray(dm_j).reshape(b * et, 2 * d)
    sel = np.where(c_slot[:, None], dm_j[:, :d], dm_j[:, d:])
    other = np.where(c_slot[:, None], dm_j[:, d:], dm_j[:, :d])
    assert np.all(other[valid] == 0)
    assert dm.shape == (b * et, d)
    _close(dm.numpy()[valid], sel[valid], scaled)
    assert np.all(dm.numpy()[~valid] == 0)
    np.testing.assert_array_equal(slot_c.numpy(), c_slot)
    c = inp["central"][:, None]
    _close(dud.numpy(), np.where(c, np.asarray(du1_j), np.asarray(du2_j)),
           scaled)
    _close(da.numpy(), np.concatenate([np.asarray(da1_j),
                                       np.asarray(da2_j)]), scaled)
    return got, out, row, valid


@pytest.mark.parametrize("nb,pattern,d", CASES)
def test_sel_bwd_plain_matches_pallas_interpret(rng, nb, pattern, d):
    """Per-slot dm and slot_c, dud and [da1 ‖ da2] of the selective
    backward against _attention_sel_bwd_kernel; the slots are the same in
    both layouts. The port takes each destination's softmax term as
    dout · out, the TPU kernel as a segment sum over its slots."""
    lay_j, lay_t = _layouts(rng, nb)
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, pattern)
    _check_sel_bwd(lay_j, lay_t, inp, _dout(rng, N_PAD, d))


@pytest.mark.parametrize("nb,pattern,d", CASES)
def test_concat_bwd_plain_matches_pallas_interpret(rng, nb, pattern, d):
    """Per-slot dm (D wide, in the destination's branch) and slot_c, dud
    and [da1 ‖ da2] of the concatenated backward against
    _attention_bwd_kernel, whose dm is 2D wide with the unselected half
    zero."""
    lay_j, lay_t = _layouts(rng, nb)
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, pattern)
    _check_concat_bwd(lay_j, lay_t, inp, _dout(rng, N_PAD, d))


@pytest.mark.parametrize("nb,d", WIDE)
@pytest.mark.parametrize("form", ["sel", "concat"])
def test_wide_bwd_plain_matches_pallas_interpret(rng, form, nb, d):
    """Both plain backwards at D = 257 and 512 against the Pallas
    kernels in interpret mode, at rtol 1e-4 and atol 1e-5 times each
    output's largest magnitude (see :func:`_close`)."""
    lay_j, lay_t = _layouts(rng, nb)
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, "blocks")
    check = _check_sel_bwd if form == "sel" else _check_concat_bwd
    (dm, _, _, _), _, _, _ = check(lay_j, lay_t, inp, _dout(rng, N_PAD, d),
                                   scaled=True)
    assert dm.shape[1] == d


@pytest.mark.parametrize("form", ["sel", "concat"])
def test_bwd_plain_destination_without_real_slot(rng, form):
    """Destinations whose slots are all masked, and destinations with no
    slot at all, have out_v = 0 and so S_v = 0: their dud is zero, their
    slots' dm and slot_c are zero, and the rest still matches the TPU
    kernel."""
    s, r, em = random_edges(rng, n=N, n_pad=N_PAD)
    hot = np.bincount(r[em], minlength=N_PAD)
    masked = np.argsort(-hot, kind="stable")[:3]   # rows with many slots
    em = em & ~np.isin(r, masked)
    lay_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=16).lay_dst
    lay_t = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=16).lay_dst
    inp = _inputs(rng, N_PAD, N_PAD, 8, 16, "blocks")
    check = _check_sel_bwd if form == "sel" else _check_concat_bwd
    (dm, dud, _, slot_c), out, row, valid = check(
        lay_j, lay_t, inp, _dout(rng, N_PAD, 8))
    empty = np.setdiff1d(np.arange(N_PAD), row[valid])
    assert set(masked) <= set(empty) and len(empty) > len(masked)
    assert np.all(out.numpy()[empty] == 0)
    assert np.all(dud.numpy()[empty] == 0)
    lo_hi = lay_t.dst_ranges.numpy()[masked]
    for lo, hi in lo_hi:
        assert hi > lo
        assert np.all(dm.numpy()[lo:hi] == 0)
        assert np.all(slot_c.numpy()[lo:hi] == 0)


@pytest.mark.parametrize("nb", [16, 64, 128])
@pytest.mark.parametrize("split", [False, True])
def test_slot_reduce_plain_matches_pallas_interpret(rng, nb, split):
    """The sender-keyed reduce of dst-ordered slot rows against
    _reduce_kernel over the JAX src-keyed layout fed ``dm[src_from_dst]``
    (with the branch split: ``[dm·c ‖ dm·(1−c)]``, as _gather_sel_vjp
    builds it). Without the split every real slot is in branch 1: the
    first half of the output is the JAX reduce of ``dm`` itself and the
    second half is zero."""
    _check_slot_reduce(rng, nb, split, 8)


@pytest.mark.parametrize("w", [257, 512])
def test_slot_reduce_plain_wide_matches_pallas_interpret(rng, w):
    """The same at W = 257 and 512 (the backwards' dm rows at the wide
    widths), with the branch split."""
    _check_slot_reduce(rng, 64, True, w)


def _check_slot_reduce(rng, nb, split, w):
    s, r, em = random_edges(rng, n=50, n_pad=N_PAD)
    ops_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb)
    lay_t = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb).lay_dst
    n_slots = lay_t.slot_src.shape[0]
    real = lay_t.slot_src.numpy() >= 0
    dm = rng.normal(size=(n_slots, w)).astype(np.float32) * real[:, None]
    branch = ((rng.random(n_slots) < 0.5) if split else True) & real
    vals = (np.concatenate([dm * branch[:, None], dm * ~branch[:, None]], 1)
            if split else dm)
    lay_s = ops_j.lay_src
    sfd = np.asarray(ops_j.src_from_dst)
    want = slot_reduce_pallas(
        lay_s, jnp.asarray(vals[sfd].reshape(lay_s.num_blocks,
                                             lay_s.tile_e, -1)),
        interpret=True)
    got = fk.slot_reduce_plain(lay_t, torch.from_numpy(dm), N_PAD,
                               torch.from_numpy(branch.astype(np.uint8)))
    assert got.shape == (N_PAD, 2 * w)
    if not split:
        assert np.all(got.numpy()[:, w:] == 0)
        got = got[:, :w]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _grads_jax(fn, inp, cot):
    """jax.grad of sum(out·cot) wrt (u1, u2, a1, a2), the destination rows
    taken from the same tables (u1_dst is u1, as on one device)."""
    c = jnp.asarray(inp["central"].astype(np.float32))

    def loss(u1, u2, a1, a2):
        return jnp.sum(fn(u1, u2, u1, u2, c, a1, a2) * cot)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(inp[k]) for k in ("u1", "u2", "a1", "a2")))


def _grads_port(apply, inp, cot):
    leaves = [torch.from_numpy(inp[k]).requires_grad_()
              for k in ("u1", "u2", "a1", "a2")]
    u1, u2, a1, a2 = leaves
    out = apply(u1, u2, torch.from_numpy(inp["central"]), a1, a2)
    (out * torch.from_numpy(cot)).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("nb,pattern,d", CASES)
@pytest.mark.parametrize("form", ["sel", "concat"])
def test_function_grads_match_jax_custom_vjp(rng, nb, pattern, d, form):
    """Gradients of sum(out·cot) wrt (u1, u2, a1, a2) through AttentionSel
    / AttentionCat (plain versions) against jax.grad through
    make_adapted_attention_sel / make_adapted_attention with the Pallas
    forward and backward in interpret mode."""
    s, r, em = random_edges(rng, n=50, n_pad=N_PAD)
    ops_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb)
    lay = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb).lay_dst
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, pattern)
    cot = _dout(rng, N_PAD, d)
    make = (jfa.make_adapted_attention_sel if form == "sel"
            else jfa.make_adapted_attention)
    fj = make(ops_j, SLOPE, kernel_fwd=True, kernel_bwd=True, interpret=True)
    want = _grads_jax(fj, inp, cot)

    def apply(u1, u2, c, a1, a2):
        if form == "sel":
            return tfa.attention_sel(lay, u1, u2, c, a1, a2, SLOPE)
        ud = torch.where(c[:, None], u1, u2)
        return tfa.AttentionCat.apply(lay, u1, u2, ud, c, a1, a2, SLOPE)

    got = _grads_port(apply, inp, cot)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def test_tiered_grads_match_jax(rng):
    """adapted_attention_tiered's gradients (AttentionCat per tier, the
    tier permutation, the destination rows' cotangent) against the JAX
    tiered kernel path, Pallas forward and backward in interpret mode."""
    gt, tops_j, tops_t = _tiered_pair(skewed_data(rng), 64)
    n_pad = gt.num_nodes_padded
    inp = _inputs(rng, n_pad, n_pad, 8, 64, "blocks")
    inp["central"] = gt.central_mask.numpy()
    cot = _dout(rng, n_pad, 8)

    def fj(u1, u2, _u1d, _u2d, c, a1, a2):
        return jfa.adapted_attention_tiered(
            tops_j, u1, u2, c, a1=a1, a2=a2, negative_slope=SLOPE,
            kernel_fwd=True, kernel_bwd=True, interpret=True)

    want = _grads_jax(fj, inp, cot)
    got = _grads_port(
        lambda u1, u2, c, a1, a2: tfa.adapted_attention_tiered(
            tops_t, u1, u2, c, a1, a2, SLOPE), inp, cot)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("fn", [tfa.AttentionSel, tfa.AttentionCat])
def test_functions_pass_gradcheck(fn):
    """Finite differences in float64 on every differentiable input,
    the destination rows ``ud`` included."""
    rng = np.random.default_rng(3)
    s, r, em = random_edges(rng, n=12, n_pad=16, e=40, e_pad=48)
    lay = tbs.make_blocked_ops(s, r, em, 16, node_block=8).lay_dst
    c = torch.from_numpy(rng.random(16) < 0.5)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape)).requires_grad_()

    inputs = (t(16, 3), t(16, 3), t(16, 3), t(3), t(3))

    def f(u1, u2, ud, a1, a2):
        return fn.apply(lay, u1, u2, ud, c, a1, a2, SLOPE)

    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-5)
