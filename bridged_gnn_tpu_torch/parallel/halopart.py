"""Row-partitioned KT-GNN with a boundary (halo) feature exchange.

Port of ``bridged_gnn_tpu/parallel/halopart.py``. The bridged graph's
nodes are split into contiguous row blocks, one per rank; with the edges
sorted by destination each rank holds every edge into its own rows, so
each destination's softmax and sum stay on its rank. The only node-array
collective of a conv layer is one ``all_to_all`` that carries exactly the
boundary sender rows each rank needs (host-built per-pair plans); wire
bytes scale with the edge cut, not with N·D as the edge-shard layout's
all-reduces do (``parallel/edgeshard.py``). Domain means and batch-norm
moments ride [D]-sized all-reduces (``nn/common.py``).

Host side, numpy: :func:`build_halo_partition` gives the same arrays as
the JAX build (local senders and receivers, masks, the send plan, the
extended masks, the blocked-reduce offsets and the per-shard padded slot
layouts ``pl``/``pl2`` in the JAX package's form, with their uniform
static dims). :func:`shard_layouts` turns one shard's edges into the
port's :class:`~bridged_gnn_tpu_torch.ops.blocked_segment.PaddedLayout`:
the same slots (the shard-uniform ``tile_e`` forced), destinations in the
shard's ``rows``, senders in its extended row space ``x_ext = [own rows ‖
halo rows]`` of ``ext_len = rows + n·h_pair`` rows, which the attention
kernels read as any other sender table.

Device side: :class:`HaloView` is what the model's ``halo=`` hook takes
(``nn/ktgnn.py``): the rank's layouts and masks, and the exchange. The
exchange is an ``autograd.Function``: forward, the rows each peer needs
gathered (masked) into one ``[n·h_pair, D]`` buffer and one
``all_to_all_single``; backward, the reverse ``all_to_all_single`` and an
``index_add_`` of the cotangents into the sent rows, the transpose JAX
gets from autodiff. Gloo has no ``all_to_all`` for CUDA tensors: under a
gloo group a CUDA exchange copies its send and receive buffers through
pinned host memory, and the view counts that staging's time apart from
the exchange's (:class:`ExchangeStats`). Under NCCL the buffers stay on
the card.

Wire-byte accounting per layer of width D (fp32), n ranks
(:func:`wire_bytes_per_layer`):
  edge shard:  3 all-reduces of [N_pad, D] partials
               ≈ 3 · 2(n-1)/n · N_pad · D · 4 bytes          (per rank)
  halo (this): all_to_all ≈ (n-1)/n · H · D · 4 bytes + 3 of [D]
               where H = Σ halo rows ≤ N_pad (graph-cut dependent)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.graph import Graph, round_up
from bridged_gnn_tpu_torch.nn.common import dropout
from bridged_gnn_tpu_torch.ops.blocked_segment import (
    PaddedLayout,
    _layout_from_np,
    _padded_layout_np,
)
from bridged_gnn_tpu_torch.utils.profiling import collective_span


class HaloPartition(NamedTuple):
    """Host-built row partition + halo exchange plan (static per graph);
    the fields and their values are the JAX package's."""

    # per-shard edge arrays, flattened [n_dev * e_shard]
    senders_local: np.ndarray    # int32, ids into x_ext = [own ‖ halo]
    receivers_local: np.ndarray  # int32 in [0, rows)
    edge_mask: np.ndarray        # bool
    # halo send plan, flattened [n_dev(src) * n_dev(dst) * h_pair]
    send_idx: np.ndarray         # int32 local row ids on the SENDING rank
    send_mask: np.ndarray        # bool
    # per-shard extended masks, flattened [n_dev * (rows + n_dev*h_pair)]
    central_ext: np.ndarray      # bool
    node_mask_ext: np.ndarray    # bool
    # per-shard blocked-reduce offsets, flattened [n_dev * num_blocks]
    block_start: np.ndarray      # int32
    block_node_block: int
    block_max_edges: int
    block_num_blocks: int
    rows: int
    e_shard: int
    h_pair: int
    num_shards: int
    num_nodes_padded_total: int  # n_dev * rows
    halo_rows_real: int          # Σ real halo entries (wire accounting)
    # per-shard padded slot layouts (uniform static dims across shards),
    # dict of flattened [n_dev * ...] arrays
    pl: dict
    pd_tile: int                 # dst layout tile_e
    pd_blocks: int               # dst layout num_blocks (rows/node_block)
    ps_tile: int                 # src layout tile_e
    ps_blocks: int               # src layout num_blocks (ext_len/node_block)
    ext_len: int                 # rows + n_dev*h_pair
    # overlap split (built with overlap=True): local-sender and
    # halo-sender slot layouts; None when not built
    pl2: Optional[dict] = None
    t_ld: int = 0                # local-set dst tile_e
    t_ls: int = 0                # local-set src tile_e
    b_ls: int = 0                # local-set src num_blocks (rows space)
    t_hd: int = 0                # halo-set dst tile_e
    t_hs: int = 0                # halo-set src tile_e
    b_hs: int = 0                # halo-set src num_blocks (halo space)
    halo_len: int = 0            # n_dev * h_pair (halo buffer rows)


def _slot_grid_np(key_sorted, other, edge_ids, valid, num_nodes_padded,
                  node_block, min_tile_e=0):
    """The JAX package's host slot assignment
    (``ops/blocked_segment.py::_padded_layout_np``) without its loop over
    blocks: ``other_slot``, ``rel_key`` (``node_block`` on masked and pad
    slots), ``slot_edge``, ``slot_mask`` [num_blocks, tile_e], tile_e and
    num_blocks; ``min_tile_e`` forces a wider tile."""
    nb = node_block
    num_blocks = -(-num_nodes_padded // nb)
    key = np.asarray(key_sorted, dtype=np.int64)
    bounds = np.searchsorted(key, np.arange(num_blocks + 1) * nb,
                             side="left")
    tile_e = ((max(int(np.diff(bounds).max()), min_tile_e, 1) + 127)
              // 128) * 128
    e = np.arange(bounds[-1])
    blk = key[e] // nb
    pos = blk * tile_e + e - bounds[blk]
    grid = num_blocks * tile_e
    other_slot = np.zeros(grid, dtype=np.int32)
    rel_key = np.full(grid, nb, dtype=np.int32)
    slot_edge = np.zeros(grid, dtype=np.int32)
    slot_mask = np.zeros(grid, dtype=bool)
    other_slot[pos] = np.asarray(other)[e]
    rel_key[pos] = key[e] - blk * nb
    slot_edge[pos] = np.asarray(edge_ids)[e]
    slot_mask[pos] = np.asarray(valid)[e]
    rel_key[~slot_mask] = nb
    shape = (num_blocks, tile_e)
    return (other_slot.reshape(shape), rel_key.reshape(shape),
            slot_edge.reshape(shape), slot_mask.reshape(shape), tile_e,
            num_blocks)


def _dst_and_src(r, s, eid, valid, dst_space, src_space, nb, min_d, min_s):
    """One edge set's dst-keyed and src-keyed slot grids and, per src
    slot, the dst slot holding the same edge (JAX ``src_from_dst``)."""
    d = _slot_grid_np(r, s, eid, valid, dst_space, nb, min_tile_e=min_d)
    perm = np.argsort(s, kind="stable")
    sr = _slot_grid_np(s[perm], r[perm], eid[perm], valid[perm], src_space,
                       nb, min_tile_e=min_s)
    pos_dst = np.zeros(max(len(eid), 1), dtype=np.int32)
    d_edge, d_mask = d[2].reshape(-1), d[3].reshape(-1)
    pos_dst[d_edge[d_mask]] = np.nonzero(d_mask)[0].astype(np.int32)
    return d, sr, pos_dst[sr[2].reshape(-1)]


def _grid_dict(d, sr, s2d, dst_name, src_name) -> dict:
    out = {}
    for comp, name in ((0, "other"), (1, "rel"), (2, "edge"), (3, "mask")):
        out[f"{dst_name}_{name}"] = d[comp].reshape(-1)
        out[f"{src_name}_{name}"] = sr[comp].reshape(-1)
    out[f"{src_name}_from_dst"] = s2d
    return out


def _stack(per_shard) -> dict:
    return {k: np.stack([p[k] for p in per_shard]).reshape(-1)
            for k in per_shard[0]}


def _split_sets(out_s, out_m, rows, q):
    """Shard ``q``'s real edges with a sender among its own rows and with
    a sender in the halo buffer, as (edge positions, sender ids in that
    row set's space)."""
    m_q, s_q = out_m[q], out_s[q]
    is_local = s_q < rows
    return (("l", np.nonzero(m_q & is_local)[0], s_q),
            ("h", np.nonzero(m_q & ~is_local)[0], s_q - rows))


def _split_slot_layouts(out_s, out_r, out_m, rows, halo_len, node_block,
                        n_shards):
    """Per-shard local-sender vs halo-sender slot layouts with uniform
    static dims across shards, for the overlap attention path (JAX
    ``halopart.py:92-162``). Only valid edges enter them."""
    spaces = dict(l=rows, h=halo_len)

    def one_pass(mins):
        t = {k: 0 for k in ("ld", "ls", "hd", "hs")}
        per_shard = []
        for q in range(n_shards):
            entry = {}
            for key, idx, src in _split_sets(out_s, out_m, rows, q):
                r_sub = out_r[q][idx]
                s_sub = src[idx].astype(np.int32)
                eid = np.arange(len(idx))
                d, sr, s2d = _dst_and_src(
                    r_sub, s_sub, eid, np.ones(len(idx), bool), rows,
                    spaces[key], node_block, mins[key + "d"],
                    mins[key + "s"])
                entry[key] = (d, sr, s2d)
                t[key + "d"] = max(t[key + "d"], d[4])
                t[key + "s"] = max(t[key + "s"], sr[4])
            per_shard.append(entry)
        return per_shard, t

    _, tiles = one_pass(dict(ld=0, ls=0, hd=0, hs=0))
    per_shard, tiles = one_pass(tiles)
    pl2 = {}
    for key, dst_name, src_name in (("l", "ld", "ls"), ("h", "hd", "hs")):
        pl2.update(_stack([_grid_dict(*e[key], dst_name, src_name)
                           for e in per_shard]))
    b_ls = per_shard[0]["l"][1][5]
    b_hs = per_shard[0]["h"][1][5]
    return pl2, tiles, b_ls, b_hs


def build_halo_partition(
    g: Graph, n_shards: int, overlap: bool = False,
    node_block: Optional[int] = None,
) -> HaloPartition:
    """Build the row partition + per-pair halo plans (host, once per
    graph; JAX ``halopart.py:164-344``). ``overlap=True`` also builds the
    local/halo split slot layouts of the overlap path. ``node_block``
    overrides the slot layouts' block (default 128)."""
    n_pad = g.num_nodes_padded
    rows = round_up(-(-n_pad // n_shards), 8)
    n_total = rows * n_shards
    s = g.senders.cpu().numpy().astype(np.int64)
    r = g.receivers.cpu().numpy().astype(np.int64)
    em = g.edge_mask.cpu().numpy()
    central = np.zeros(n_total, dtype=bool)
    central[:n_pad] = g.central_mask.cpu().numpy()
    valid = np.zeros(n_total, dtype=bool)
    valid[:n_pad] = g.node_mask.cpu().numpy()

    dst_shard = r // rows
    e_counts = np.bincount(dst_shard[em], minlength=n_shards)
    e_shard = round_up(max(int(e_counts.max()), 1), 128)

    # per (q, p): rows owned by p that q's edges reference (p != q)
    halo_sets = [[None] * n_shards for _ in range(n_shards)]
    h_pair = 8
    for q in range(n_shards):
        sq = s[em & (dst_shard == q)]
        ext = sq[sq // rows != q]
        for p in range(n_shards):
            halo_sets[q][p] = np.unique(ext[ext // rows == p])
            h_pair = max(h_pair, len(halo_sets[q][p]))
    h_pair = round_up(h_pair, 8)

    ext_len = rows + n_shards * h_pair
    out_s = np.zeros((n_shards, e_shard), dtype=np.int32)
    out_r = np.full((n_shards, e_shard), rows - 1, dtype=np.int32)
    out_m = np.zeros((n_shards, e_shard), dtype=bool)
    send_idx = np.zeros((n_shards, n_shards, h_pair), dtype=np.int32)
    send_mask = np.zeros((n_shards, n_shards, h_pair), dtype=bool)
    central_ext = np.zeros((n_shards, ext_len), dtype=bool)
    nodemask_ext = np.zeros((n_shards, ext_len), dtype=bool)
    halo_real = 0
    for q in range(n_shards):
        # local-id lookup for x_ext rows: own rows then halo slots
        lut = np.full(n_total, -1, dtype=np.int64)
        own = np.arange(q * rows, (q + 1) * rows)
        lut[own] = np.arange(rows)
        central_ext[q, :rows] = central[own]
        nodemask_ext[q, :rows] = valid[own]
        for p in range(n_shards):
            hs = halo_sets[q][p]
            base = rows + p * h_pair
            lut[hs] = base + np.arange(len(hs))
            central_ext[q, base:base + len(hs)] = central[hs]
            nodemask_ext[q, base:base + len(hs)] = valid[hs]
            # rank p sends these rows (p-local ids) to rank q
            send_idx[p, q, : len(hs)] = (hs - p * rows).astype(np.int32)
            send_mask[p, q, : len(hs)] = True
            if p != q:
                halo_real += len(hs)
        sel = em & (dst_shard == q)
        k = int(sel.sum())
        out_s[q, :k] = lut[s[sel]].astype(np.int32)
        out_r[q, :k] = (r[sel] - q * rows).astype(np.int32)
        out_m[q, :k] = True
        if (out_s[q, :k] < 0).any():
            raise AssertionError("an edge's sender has no x_ext row")

    # the slot layouts' block (JAX :251-253): 128, or the shard's rows
    if node_block is None:
        node_block = 128 if rows >= 128 else max(8, rows)
    node_block = min(node_block, rows)
    # per-shard blocked-reduce offsets (JAX build_block_meta): padded
    # edges carry receiver rows-1 and land in the last block
    nbk = -(-rows // node_block)
    bounds = np.stack([np.searchsorted(out_r[q], np.arange(nbk + 1)
                                       * node_block, side="left")
                       for q in range(n_shards)])
    block_start = bounds[:, :-1].astype(np.int32)
    block_max_edges = max(round_up(int(np.diff(bounds, axis=1).max()), 128),
                          128)

    eid = np.arange(e_shard)

    def shard_grids(min_td, min_ts):
        return [_dst_and_src(out_r[q], out_s[q], eid, out_m[q], rows,
                             ext_len, node_block, min_td, min_ts)
                for q in range(n_shards)]

    raw = shard_grids(0, 0)
    pd_tile = max(d[4] for d, _, _ in raw)
    ps_tile = max(sr[4] for _, sr, _ in raw)
    raw = shard_grids(pd_tile, ps_tile)
    pl = _stack([_grid_dict(d, sr, s2d, "pd", "ps") for d, sr, s2d in raw])

    ov = dict(pl2=None, t_ld=0, t_ls=0, b_ls=0, t_hd=0, t_hs=0, b_hs=0,
              halo_len=n_shards * h_pair)
    if overlap:
        pl2, tiles, b_ls, b_hs = _split_slot_layouts(
            out_s, out_r, out_m, rows, n_shards * h_pair, node_block,
            n_shards)
        ov.update(pl2=pl2, t_ld=tiles["ld"], t_ls=tiles["ls"], b_ls=b_ls,
                  t_hd=tiles["hd"], t_hs=tiles["hs"], b_hs=b_hs)

    return HaloPartition(
        **ov,
        senders_local=out_s.reshape(-1),
        receivers_local=out_r.reshape(-1),
        edge_mask=out_m.reshape(-1),
        block_start=block_start.reshape(-1),
        block_node_block=node_block,
        block_max_edges=block_max_edges,
        block_num_blocks=nbk,
        send_idx=send_idx.reshape(-1),
        send_mask=send_mask.reshape(-1),
        central_ext=central_ext.reshape(-1),
        node_mask_ext=nodemask_ext.reshape(-1),
        rows=rows,
        e_shard=e_shard,
        h_pair=h_pair,
        num_shards=n_shards,
        num_nodes_padded_total=n_total,
        halo_rows_real=halo_real,
        pl=pl,
        pd_tile=pd_tile,
        pd_blocks=raw[0][0][5],
        ps_tile=ps_tile,
        ps_blocks=raw[0][1][5],
        ext_len=ext_len,
    )


def wire_bytes_per_layer(part: HaloPartition, d: int,
                         dtype_bytes: int = 4) -> dict:
    """Per-rank wire bytes for one AdaptedConv layer, halo vs edge-shard
    (see the module docstring for the formulas)."""
    n = part.num_shards
    n_pad = part.num_nodes_padded_total
    halo = (part.halo_rows_real / max(n, 1)) * d * dtype_bytes \
        + 3 * d * dtype_bytes * 2 * (n - 1) / max(n, 1)
    edgeshard = 3 * (2 * (n - 1) / n) * n_pad * d * dtype_bytes
    return dict(
        halo_bytes=int(halo),
        edgeshard_bytes=int(edgeshard),
        ratio=float(edgeshard / max(halo, 1)),
        halo_rows=part.halo_rows_real,
    )


def shard_edges(part: HaloPartition, q: int):
    """Shard ``q``'s (receivers, senders, mask) [e_shard], dst-sorted."""
    sl = slice(q * part.e_shard, (q + 1) * part.e_shard)
    return (part.receivers_local[sl], part.senders_local[sl],
            part.edge_mask[sl])


def shard_layouts(part: HaloPartition, q: int, device="cpu"):
    """Shard ``q``'s slot layouts as the port's ``PaddedLayout``: the
    layout over all its edges (senders in ``x_ext``, ``ext_len`` rows)
    and, when the partition was built with ``overlap``, the local-sender
    layout (senders in its own ``rows``) and the halo-sender one (senders
    in the ``halo_len`` receive buffer); else None for those two. Each
    holds the JAX layout's slots: the same tile (the shard-uniform one),
    the same edge in every slot."""
    nb = part.block_node_block
    r, s, m = shard_edges(part, q)
    lay = _layout_from_np(
        _padded_layout_np(r, s, m, part.rows, nb, min_tile_e=part.pd_tile),
        part.rows, nb, device, part.ext_len)
    if part.pl2 is None:
        return lay, None, None
    out = [lay]
    out_s = part.senders_local.reshape(part.num_shards, -1)
    out_m = part.edge_mask.reshape(part.num_shards, -1)
    tiles = dict(l=part.t_ld, h=part.t_hd)
    spaces = dict(l=part.rows, h=part.halo_len)
    for key, idx, src in _split_sets(out_s, out_m, part.rows, q):
        out.append(_layout_from_np(
            _padded_layout_np(r[idx], src[idx].astype(np.int32),
                              np.ones(len(idx), bool), part.rows, nb,
                              min_tile_e=tiles[key]),
            part.rows, nb, device, spaces[key]))
    return tuple(out)


def shard_node_array(a: np.ndarray, part: HaloPartition, q: int,
                     fill=0) -> np.ndarray:
    """Rows ``[q·rows, (q+1)·rows)`` of a node-indexed array, padded with
    ``fill`` past its end (JAX ``_shard_node``, one shard)."""
    lo, hi = q * part.rows, (q + 1) * part.rows
    out = np.full((part.rows,) + a.shape[1:], fill, dtype=a.dtype)
    take = a[lo:min(hi, a.shape[0])]
    out[: len(take)] = take
    return out


# ------------------------------------------------------------ the exchange


def _capturing() -> bool:
    """Whether the current CUDA stream is being captured in a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


@dataclasses.dataclass
class ExchangeStats:
    """What a view's eagerly run exchanges cost, on the host clock:
    calls, bytes sent per rank (the all_to_all's buffer, backward
    included), the seconds inside the exchange (for a gloo group on CUDA
    after the stream has drained, so that queued compute is not counted)
    and, of them, the seconds spent copying the buffers between the card
    and pinned host memory. An exchange recorded into a CUDA graph (scan
    mode under NCCL) adds nothing: a host clock there would time the
    capture, not the replays, which are timed as whole epochs."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    stage_seconds: float = 0.0


class _Pending:
    """An exchange in flight: :meth:`wait` completes it (and, for a gloo
    group on CUDA, copies the received rows to the card)."""

    def __init__(self, view, work, host_recv, recv, t0):
        self.view, self.work, self.host_recv, self.recv = (
            view, work, host_recv, recv)
        self.t0 = t0

    def wait(self) -> None:
        if self.work is None:
            return
        self.work.wait()
        self.work = None
        if _capturing():
            return
        stats = self.view.stats
        if self.host_recv is not None:
            t = time.perf_counter()
            with torch.no_grad():
                self.recv.copy_(self.host_recv)
            stats.stage_seconds += time.perf_counter() - t
        stats.seconds += time.perf_counter() - self.t0


class _Exchange(torch.autograd.Function):
    """``recv [n·h_pair, D]``: the halo rows this rank receives. Forward
    starts the all_to_all (``box`` gets the pending exchange); backward
    sends the cotangents back and adds them into the sent rows."""

    @staticmethod
    def forward(ctx, x, view, box):
        ctx.view, ctx.n_rows = view, x.shape[0]
        send = torch.where(view.send_mask[:, None], x[view.send_idx], 0.0)
        recv, pending = view.all_to_all(send.contiguous(), async_op=True)
        box.append(pending)
        return recv

    @staticmethod
    def backward(ctx, grad):
        view = ctx.view
        back, pending = view.all_to_all(grad.contiguous(), async_op=False)
        back = torch.where(view.send_mask[:, None], back, 0.0)
        dx = back.new_zeros((ctx.n_rows, back.shape[1]))
        dx.index_add_(0, view.send_idx, back)
        return dx, None, None


@dataclasses.dataclass
class HaloView:
    """One rank's view of a :class:`HaloPartition`, passed to the
    model's ``halo=`` hook: its group, send plan, extended masks and slot
    layouts on its device, and the exchange. ``selective`` picks the
    attention kernels: the selective pair (``KTGNN_noDTC``) or the
    concatenated pair (``KTGNN``)."""

    group: object
    rank: int
    num_shards: int
    rows: int
    h_pair: int
    send_idx: torch.Tensor       # [n·h_pair] int64, rows of this rank
    send_mask: torch.Tensor      # [n·h_pair] bool
    central_ext: torch.Tensor    # [ext_len] bool
    node_mask_ext: torch.Tensor  # [ext_len] bool
    lay: PaddedLayout
    lay_local: Optional[PaddedLayout]
    lay_halo: Optional[PaddedLayout]
    selective: bool
    stage_on_host: bool
    stats: ExchangeStats = dataclasses.field(default_factory=ExchangeStats)

    @property
    def overlap(self) -> bool:
        return self.lay_local is not None

    def all_to_all(self, send: torch.Tensor, async_op: bool):
        """``recv``, block ``p`` from rank ``p``, of an equal-split
        all_to_all of ``send`` [n·h_pair, D]; and the pending exchange
        (already waited on unless ``async_op``). The gloo staging through
        pinned host memory is host work and never captured: a CUDA graph
        records exchanges under NCCL alone."""
        if not _capturing():
            self.stats.calls += 1
            self.stats.bytes += send.numel() * send.element_size()
        t0 = time.perf_counter()
        host_recv = None
        if self.stage_on_host:
            torch.cuda.current_stream(send.device).synchronize()
            t0 = time.perf_counter()
            host_send = torch.empty(send.shape, dtype=send.dtype,
                                    pin_memory=True)
            host_send.copy_(send)
            host_recv = torch.empty_like(host_send, pin_memory=True)
            self.stats.stage_seconds += time.perf_counter() - t0
            recv = torch.empty_like(send)
            with collective_span("all_to_all"):
                work = dist.all_to_all_single(host_recv, host_send,
                                              group=self.group,
                                              async_op=True)
        else:
            recv = torch.empty_like(send)
            with collective_span("all_to_all"):
                work = dist.all_to_all_single(recv, send, group=self.group,
                                              async_op=True)
        pending = _Pending(self, work, host_recv, recv, t0)
        if not async_op:
            pending.wait()
        return recv, pending

    def exchange_recv_async(self, x: torch.Tensor
                            ) -> Tuple[torch.Tensor, Callable[[], None]]:
        """The halo receive buffer [n·h_pair, D] and the call that
        completes it: the overlap path computes its local partials
        between the two (JAX ``exchange_recv``, :510-523)."""
        box = []
        recv = _Exchange.apply(x, self, box)
        return recv, box[0].wait

    def exchange(self, x: torch.Tensor) -> torch.Tensor:
        """``x_ext = [own rows ‖ halo rows]`` [ext_len, D] (JAX
        ``exchange``, :525-530)."""
        recv, wait = self.exchange_recv_async(x)
        wait()
        return torch.cat([x, recv], dim=0)

    def dropout(self, x: torch.Tensor, p: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Dropout on this rank's rows with the mask of all ``n·rows``
        rows drawn from ``generator``, which every rank holds in the same
        state: the ranks draw alike and their generators stay equal."""
        return dropout(x, p, generator,
                       draw_rows=(self.rank * self.rows,
                                  self.num_shards * self.rows))


def halo_view(part: HaloPartition, group, device, selective: bool
              ) -> HaloView:
    """This rank's :class:`HaloView` of ``part`` on ``device``."""
    q = dist.get_rank(group)
    n, h = part.num_shards, part.h_pair
    dev = torch.device(device)
    # the rows this rank sends: its block of the [src, dst, h_pair] plan
    plan = slice(q * n * h, (q + 1) * n * h)
    ext = slice(q * part.ext_len, (q + 1) * part.ext_len)
    lay, lay_l, lay_h = shard_layouts(part, q, dev)
    return HaloView(
        group=group, rank=q, num_shards=n, rows=part.rows, h_pair=h,
        send_idx=torch.from_numpy(part.send_idx[plan].astype(np.int64)).to(
            dev),
        send_mask=torch.from_numpy(part.send_mask[plan]).to(dev),
        central_ext=torch.from_numpy(part.central_ext[ext]).to(dev),
        node_mask_ext=torch.from_numpy(part.node_mask_ext[ext]).to(dev),
        lay=lay, lay_local=lay_l, lay_halo=lay_h, selective=selective,
        stage_on_host=(dev.type == "cuda"
                       and dist.get_backend(group) == "gloo"))
