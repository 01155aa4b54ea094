"""PyTorch port, attention forward: the plain versions of the two CUDA
kernels (ops/fused_kernels.py) against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs; the fused-attention
callables and the tiered attention against their JAX counterparts. The
kernels themselves run on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridged_gnn_tpu.ops import blocked_segment as jbs
from bridged_gnn_tpu.ops import fused_attention as jfa
from bridged_gnn_tpu.ops.pallas_fused import (
    _attention_sel_call,
    adapted_attention_fwd_pallas,
)

from bridged_gnn_tpu_torch.graph import graph_from_dict, with_self_loops
from bridged_gnn_tpu_torch.ops import blocked_segment as tbs
from bridged_gnn_tpu_torch.ops import fused_attention as tfa
from bridged_gnn_tpu_torch.ops import fused_kernels as fk
from bridged_gnn_tpu_torch.ops.spmm import adjacency_from_graph

from tests.test_torch_cuda import random_edges, skewed_data

SLOPE = 0.1
TOL = dict(rtol=1e-4, atol=1e-5)
N, N_PAD = 50, 64
CASES = [(16, "blocks", 8), (16, "blocks", 16), (64, "blocks", 8),
         (64, "target", 16), (128, "blocks", 8)]


def _central(rng, n_out, nb, pattern):
    """'blocks': block 0 all central, block 1 all target, rest random;
    'target': no central destination at all."""
    if pattern == "target":
        return np.zeros(n_out, bool)
    c = rng.random(n_out) < 0.5
    c[:nb] = True
    c[nb:2 * nb] = False
    return c


def _inputs(rng, n_in, n_out, d, nb, pattern):
    f = np.float32
    return dict(
        u1=rng.normal(size=(n_in, d)).astype(f),
        u2=rng.normal(size=(n_in, d)).astype(f),
        u1_dst=rng.normal(size=(n_out, d)).astype(f),
        u2_dst=rng.normal(size=(n_out, d)).astype(f),
        central=_central(rng, n_out, nb, pattern),
        a1=rng.normal(size=d).astype(f),
        a2=rng.normal(size=d).astype(f),
    )


def _port_args(inp):
    c = torch.from_numpy(inp["central"])
    ud = torch.where(c[:, None], torch.from_numpy(inp["u1_dst"]),
                     torch.from_numpy(inp["u2_dst"]))
    return (torch.from_numpy(inp["u1"]), torch.from_numpy(inp["u2"]), ud,
            c, torch.from_numpy(inp["a1"]), torch.from_numpy(inp["a2"]))


def _slot_rows(lay_j):
    b, et, nb = lay_j.num_blocks, lay_j.tile_e, lay_j.node_block
    rel = np.asarray(lay_j.rel_key)
    valid = rel < nb
    rows = np.where(valid, np.arange(b)[:, None] * nb + rel, 0)
    return rows, valid


def _jax_sel_operands(lay_j, inp):
    """The selected-branch slot rows ``m`` [B, Et, D] and the packed
    ``udc`` [B, nb, D+128] operand, as make_adapted_attention_sel feeds
    the Pallas selective kernels."""
    b, et, nb = lay_j.num_blocks, lay_j.tile_e, lay_j.node_block
    u1, u2, c = inp["u1"], inp["u2"], inp["central"]
    n_in, d = u1.shape
    n_out = len(c)
    rows, valid = _slot_rows(lay_j)
    c_pad = np.zeros(b * nb, bool)
    c_pad[:n_out] = c
    c_slot = valid & c_pad[rows]
    other = np.asarray(lay_j.other_slot).reshape(b, et)
    m = np.concatenate([u1, u2])[other + np.where(c_slot, 0, n_in)]
    ud = np.where(c[:, None], inp["u1_dst"], inp["u2_dst"])
    udc = np.zeros((b * nb, d + 128), np.float32)
    udc[:n_out, :d] = ud
    udc[:n_out, d] = c
    udc[:n_out, d + 1] = 1.0
    return jnp.asarray(m), jnp.asarray(udc.reshape(b, nb, -1))


def _jax_sel_kernel(lay_j, inp):
    """The Pallas selective kernel (interpret mode) fed as
    make_adapted_attention_sel._forward_kernel feeds it; returns out and
    α = ex / den per slot."""
    b, nb = lay_j.num_blocks, lay_j.node_block
    n_out, d = len(inp["central"]), inp["u1"].shape[1]
    rows, valid = _slot_rows(lay_j)
    out, ex, den = _attention_sel_call(
        lay_j.rel_key, *_jax_sel_operands(lay_j, inp),
        jnp.asarray(inp["a1"])[None], jnp.asarray(inp["a2"])[None],
        nb, SLOPE, interpret=True,
    )
    den = np.asarray(den).reshape(-1)
    alpha = np.where(valid, np.asarray(ex)[..., 0] / den[rows], 0.0)
    return np.asarray(out).reshape(b * nb, d)[:n_out], alpha.reshape(-1)


def _jax_concat_kernel(lay_j, inp):
    """The Pallas concatenated kernel (interpret mode) through
    adapted_attention_fwd_pallas; returns the destination's branch and α."""
    b, et = lay_j.num_blocks, lay_j.tile_e
    u_cat = np.concatenate([inp["u1"], inp["u2"]], axis=1)
    m = u_cat[np.asarray(lay_j.other_slot)].reshape(b, et, -1)
    res, alpha, _ = adapted_attention_fwd_pallas(
        lay_j, jnp.asarray(m), jnp.asarray(inp["u1_dst"]),
        jnp.asarray(inp["u2_dst"]),
        jnp.asarray(inp["central"].astype(np.float32)),
        jnp.asarray(inp["a1"]), jnp.asarray(inp["a2"]),
        negative_slope=SLOPE, interpret=True,
    )
    return np.asarray(res), np.asarray(alpha).reshape(-1)


def _layouts(rng, nb):
    s, r, em = random_edges(rng, n=N, n_pad=N_PAD)
    lay_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb).lay_dst
    lay_t = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb).lay_dst
    # the cases must hold pad slots and destinations with no real edge
    assert (~np.asarray(lay_j.slot_mask)).any()
    rows, valid = _slot_rows(lay_j)
    assert len(np.unique(rows[valid])) < N_PAD
    return lay_j, lay_t


@pytest.mark.parametrize("nb,pattern,d", CASES)
def test_sel_plain_matches_pallas_interpret(rng, nb, pattern, d):
    lay_j, lay_t = _layouts(rng, nb)
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, pattern)
    want_out, want_alpha = _jax_sel_kernel(lay_j, inp)
    out, ex, den = fk.attention_sel_fwd_plain(lay_t, *_port_args(inp), SLOPE)
    row, valid = tbs.slot_rows(lay_t)
    alpha = torch.where(valid, ex / den[row], 0.0)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, **TOL)
    # no real edge -> zero row and den 1; pad slots carry no weight
    empty = np.setdiff1d(np.arange(N_PAD), row[valid].numpy())
    assert len(empty) and np.all(out.numpy()[empty] == 0)
    assert np.all(den.numpy()[empty] == 1)
    assert torch.all(ex[~valid] == 0)


@pytest.mark.parametrize("nb,pattern,d", CASES)
def test_concat_plain_matches_pallas_interpret(rng, nb, pattern, d):
    lay_j, lay_t = _layouts(rng, nb)
    inp = _inputs(rng, N_PAD, N_PAD, d, nb, pattern)
    want_res, want_alpha = _jax_concat_kernel(lay_j, inp)
    args = _port_args(inp)
    out2, alpha = fk.attention_fwd_plain(lay_t, *args, SLOPE)
    assert out2.shape == (N_PAD, 2 * d)
    res = torch.where(args[3][:, None], out2[:, :d], out2[:, d:])
    np.testing.assert_allclose(res.numpy(), want_res, **TOL)
    np.testing.assert_allclose(alpha.numpy(), want_alpha, **TOL)
    # both branches aggregate with the same weights
    sel_out, _, _ = fk.attention_sel_fwd_plain(lay_t, *args, SLOPE)
    np.testing.assert_allclose(res.numpy(), sel_out.numpy(), **TOL)


@pytest.mark.parametrize("nb", [16, 64])
def test_fused_attention_sel_matches_jax_kernel_path(rng, nb):
    """attention_sel: the port (plain on CPU) against the JAX
    kernel-forward callable of make_adapted_attention_sel in interpret
    mode, fed as AdaptedConv feeds it (destination rows from the sender
    tables)."""
    s, r, em = random_edges(rng, n=N, n_pad=N_PAD)
    ops_j = jbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb)
    ops_t = tbs.make_blocked_ops(s, r, em, N_PAD, node_block=nb)
    inp = _inputs(rng, N_PAD, N_PAD, 8, nb, "blocks")
    fj = jfa.make_adapted_attention_sel(ops_j, SLOPE, kernel_fwd=True,
                                        interpret=True)
    want = fj(*(jnp.asarray(inp[k]) for k in ("u1", "u2", "u1", "u2")),
              jnp.asarray(inp["central"].astype(np.float32)),
              jnp.asarray(inp["a1"]), jnp.asarray(inp["a2"]))
    got = tfa.attention_sel(
        ops_t.lay_dst, *(torch.from_numpy(inp[k]) for k in (
            "u1", "u2", "central", "a1", "a2")), SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tiered_attention_matches_jax_kernel_path(rng):
    """adapted_attention_tiered with the concatenated kernel on every
    tier, against the JAX tiered kernel path in interpret mode."""
    from bridged_gnn_tpu.graph import graph_from_dict as j_graph_from_dict
    from bridged_gnn_tpu.graph import with_self_loops as j_with_self_loops
    from bridged_gnn_tpu.ops.spmm import adjacency_from_graph as j_adj

    data = skewed_data(rng)
    gj = j_with_self_loops(j_graph_from_dict(data))
    gt = with_self_loops(graph_from_dict(data))
    tops_j = j_adj(gj, method="tiered", node_block=64).tiered_fn
    tops_t = adjacency_from_graph(gt, method="tiered", node_block=64,
                                  device="cpu").tiered_fn
    assert len(tops_t.tiers) >= 2
    n_pad = gt.num_nodes_padded
    inp = _inputs(rng, n_pad, n_pad, 8, 64, "blocks")
    inp["central"] = gt.central_mask.numpy()
    want = jfa.adapted_attention_tiered(
        tops_j, jnp.asarray(inp["u1"]), jnp.asarray(inp["u2"]),
        jnp.asarray(inp["central"].astype(np.float32)),
        a1=jnp.asarray(inp["a1"]), a2=jnp.asarray(inp["a2"]),
        negative_slope=SLOPE, kernel_fwd=True, interpret=True,
    )
    got = tfa.adapted_attention_tiered(
        tops_t, torch.from_numpy(inp["u1"]), torch.from_numpy(inp["u2"]),
        torch.from_numpy(inp["central"]), torch.from_numpy(inp["a1"]),
        torch.from_numpy(inp["a2"]), SLOPE,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
