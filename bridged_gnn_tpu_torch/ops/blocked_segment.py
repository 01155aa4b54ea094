"""Destination-keyed padded slot layouts, single and degree-tiered.

Port of the forward half of ``bridged_gnn_tpu/ops/blocked_segment.py``.
The host assigns the dst-sorted edges to ``[num_blocks, tile_e]`` slots
(block ``b`` owns destination rows ``[b·nb, (b+1)·nb)``) exactly as the
JAX package does, so the slots are the same. A layout stores them in the
form the CUDA attention kernels read: the sender of every slot, -1 on
masked and pad slots (``slot_src``), and per destination row the
contiguous range of flat slot positions holding its edges
(``dst_ranges``). Edges are dst-sorted and the slot assignment keeps
their order, so every destination's slots form one run. The JAX
layout's ``other_slot``/``rel_key``/``slot_mask`` follow from these two
(:func:`slot_rows`).

Every layout also holds its sender-keyed index, the input of the
backward's sender-side reduce: a CSR by sender over the real slots.
``src_ranges`` gives each sender row its range of CSR entries and
``src_slots`` the dst-layout slot of each entry, ordered by a stable sort
on the sender. It stands for the JAX package's ``lay_src`` with its
``src_from_dst`` map (blocked_segment.py:594-608, :895-905) restricted to
real slots, in the same order. Masked edges and pad slots are left out.
It is not a padded ``[B, Et]`` grid: on a hub graph a few hundred
senders own ~850 slots each, and a padded sender layout would give every
block a tile that wide.

For weighted sums (the zoo's SpMM, ``ops/padded_spmm.py``) a layout also
maps each slot to the edge it holds (``slot_edge``, the JAX package's
``slot_edge``, blocked_segment.py:265) and each sender-CSR entry to its
slot's destination row (``src_dst``), which the transposed SpMM of the
backward gathers its cotangent rows by.

Both indexes list their heavy rows: ``dst_heavy`` the destination rows
with more than :data:`HEAVY_SLOTS` slots in their run, ``src_heavy`` the
senders with more than that many CSR entries. The attention kernels and
the sender reduce give each heavy row a thread block of its own and
every other row a warp or part of one (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``, ``csrc/slot_reduce.cu``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

# Slots (or CSR entries) above which a row is heavy. The kernels test the
# same bound (kHeavySlots in csrc/lane_groups.cuh, kHeavyEntries in
# csrc/slot_reduce.cu, whose headers give the reason); ops/fused_kernels.py
# checks at load time that the three agree.
HEAVY_SLOTS = 128


class PaddedLayout(NamedTuple):
    """Padded per-block edge layout keyed by destination.

    Index tensors live on the device the layout was built for."""

    slot_src: torch.Tensor     # [B*Et] int32: sender per real slot, else -1
    dst_ranges: torch.Tensor   # [B*nb, 2] int32: flat slot range per row
    src_ranges: torch.Tensor   # [N_send, 2] int32: CSR range per sender
    src_slots: torch.Tensor    # [real slots] int32: dst slot per CSR entry
    dst_heavy: torch.Tensor    # [H_dst] int32: rows with > HEAVY_SLOTS slots
    src_heavy: torch.Tensor    # [H_src] int32: senders with > HEAVY_SLOTS
    slot_edge: torch.Tensor    # [B*Et] int32: edge per slot, 0 on pad slots
    src_dst: torch.Tensor      # [real slots] int32: dst row per CSR entry
    node_block: int
    tile_e: int
    num_blocks: int
    num_nodes_padded: int
    sender_bound: int          # 1 + largest sender id on a real slot


def _padded_layout_np(
    key_sorted: np.ndarray,
    other: np.ndarray,
    valid: np.ndarray,
    num_nodes_padded: int,
    node_block: int,
    edge_ids=None,
):
    """Host slot assignment (the JAX package's): block ``b``'s edges fill
    the first slots of row ``b`` of a ``[num_blocks, tile_e]`` grid, in
    order. Returns ``slot_src`` [B*Et], ``dst_ranges`` [B*nb, 2], tile_e,
    num_blocks, ``slot_edge`` [B*Et] (``edge_ids`` of each slot's edge,
    by default its position in the input; 0 on pad slots) and
    ``slot_row`` [B*Et] (each slot's destination row, 0 on pad slots).

    ``dst_ranges`` comes from the sorted keys, so a masked edge that sorts
    inside a row's run stays inside it. The last row of a block always
    ends where the block's edges end, even when it owns none; the kernels
    zero the pad tail from there.
    """
    n = num_nodes_padded
    nb = node_block
    num_blocks = -(-n // nb)
    key = np.asarray(key_sorted, dtype=np.int64)
    if np.any(key[1:] < key[:-1]):
        raise ValueError("slot layouts need destination-sorted edges")
    bounds = np.searchsorted(key, np.arange(num_blocks + 1) * nb,
                             side="left")
    per_block = np.diff(bounds)
    tile_e = ((max(int(per_block.max()), 1) + 127) // 128) * 128
    if num_blocks * tile_e >= 2 ** 31:
        raise ValueError(f"{num_blocks * tile_e} slots exceed the int32 "
                         "slot index range")
    # flat slot of every edge of a block: its block's first slot plus its
    # rank among the block's edges
    e = np.arange(bounds[-1], dtype=np.int64)
    blk_e = key[: bounds[-1]] // nb
    pos = blk_e * tile_e + e - bounds[blk_e]
    slot_src = np.full(num_blocks * tile_e, -1, dtype=np.int32)
    slot_src[pos] = np.where(valid[: bounds[-1]], other[: bounds[-1]], -1)
    ids = e if edge_ids is None else np.asarray(edge_ids)[: bounds[-1]]
    slot_edge = np.zeros(num_blocks * tile_e, dtype=np.int32)
    slot_edge[pos] = ids
    slot_row = np.zeros(num_blocks * tile_e, dtype=np.int32)
    slot_row[pos] = key[: bounds[-1]]
    rows = np.arange(num_blocks * nb, dtype=np.int64)
    blk = rows // nb
    base = blk * tile_e - bounds[blk]
    lo = base + np.searchsorted(key, rows, side="left")
    hi = base + np.searchsorted(key, rows, side="right")
    ranges = np.stack([lo, hi], axis=1).astype(np.int32)
    return slot_src, ranges, tile_e, num_blocks, slot_edge, slot_row


def _sender_csr_np(slot_src: np.ndarray, num_senders: int):
    """Sender-keyed CSR over the real slots: ``src_ranges`` [N_send, 2]
    and ``src_slots``, the real slots in a stable sort by sender. Slots
    follow edge order, so this is the JAX package's stable argsort of the
    edges by sender, restricted to real edges."""
    real = np.flatnonzero(slot_src >= 0)
    order = np.argsort(slot_src[real], kind="stable")
    src_slots = real[order].astype(np.int32)
    sorted_src = slot_src[src_slots]
    rows = np.arange(num_senders)
    ranges = np.stack([np.searchsorted(sorted_src, rows, side="left"),
                       np.searchsorted(sorted_src, rows, side="right")],
                      axis=1).astype(np.int32)
    return ranges, src_slots


def heavy_rows_np(ranges: np.ndarray) -> np.ndarray:
    """Rows of a ``[n, 2]`` range array whose run holds more than
    :data:`HEAVY_SLOTS` slots, ascending, int32."""
    return np.flatnonzero(ranges[:, 1] - ranges[:, 0] > HEAVY_SLOTS
                          ).astype(np.int32)


def _layout_from_np(arrs, num_nodes_padded: int, node_block: int,
                    device, num_senders: int) -> PaddedLayout:
    slot_src, ranges, tile_e, num_blocks, slot_edge, slot_row = arrs
    src_ranges, src_slots = _sender_csr_np(slot_src, num_senders)
    return PaddedLayout(
        slot_src=torch.from_numpy(slot_src).to(device),
        dst_ranges=torch.from_numpy(ranges).to(device),
        src_ranges=torch.from_numpy(src_ranges).to(device),
        src_slots=torch.from_numpy(src_slots).to(device),
        dst_heavy=torch.from_numpy(heavy_rows_np(ranges)).to(device),
        src_heavy=torch.from_numpy(heavy_rows_np(src_ranges)).to(device),
        slot_edge=torch.from_numpy(slot_edge).to(device),
        src_dst=torch.from_numpy(slot_row[src_slots]).to(device),
        node_block=node_block,
        tile_e=tile_e,
        num_blocks=num_blocks,
        num_nodes_padded=num_nodes_padded,
        sender_bound=int(slot_src.max()) + 1,
    )


def slot_rows(lay: PaddedLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination row of every slot (0 on masked and pad slots) and
    whether the slot is a real edge: slot ``k`` lies in the run of the
    first row whose range ends after ``k``."""
    hi = lay.dst_ranges[:, 1].contiguous()
    k = torch.arange(lay.slot_src.shape[0], dtype=hi.dtype, device=hi.device)
    row = torch.searchsorted(hi, k, right=True)
    valid = lay.slot_src >= 0
    return torch.where(valid, row, 0), valid


class BlockedOps(NamedTuple):
    """Edge ops bound to one dst-sorted edge array: its slot layout, the
    input of the fused attention kernels and of the padded SpMM."""

    lay_dst: PaddedLayout


def make_blocked_ops(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes_padded: int,
    node_block: int = 256,
    device="cpu",
) -> BlockedOps:
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    em = np.asarray(edge_mask)
    # dst-keyed layout (edges already dst-sorted by the Graph container)
    dst_np = _padded_layout_np(
        r, s.astype(np.int32), em, num_nodes_padded, node_block
    )
    return BlockedOps(
        lay_dst=_layout_from_np(dst_np, num_nodes_padded, node_block,
                                device, num_nodes_padded))


class TieredOps(NamedTuple):
    """Degree-tiered dst-block slot layouts for skew-heavy graphs.

    A single PaddedLayout pads every dst block to the heaviest block's
    edge count. Here the dst blocks are partitioned by load into tiers;
    each tier is an independent slot layout whose tile_e fits ITS
    heaviest block (within 2×). Every destination lives in exactly one
    tier, so per-tier outputs are disjoint row ranges in tier-concat
    order; ``row_order``/``inv_order`` map them back to global rows.
    """

    tiers: Tuple[BlockedOps, ...]
    tier_spans: Tuple[Tuple[int, int], ...]  # (start, stop) block per tier
    row_order: torch.Tensor   # [num_blocks*nb] int64 global row per position
    inv_order: torch.Tensor   # [num_blocks*nb] int64 position per global row
    num_nodes_padded: int
    node_block: int
    slots_single: int         # diagnostics: single-layout slot count
    slots_tiered: int


def make_tiered_blocked_ops(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes_padded: int,
    node_block: int = 128,
    max_tiers: int = 4,
    device="cpu",
) -> TieredOps:
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    em = np.asarray(edge_mask)
    nb = node_block
    n_pad = num_nodes_padded
    num_blocks = -(-n_pad // nb)

    # per-block valid-edge counts (edges are dst-sorted)
    blk = (r // nb).astype(np.int64)
    counts = np.bincount(blk[em], minlength=num_blocks)
    order = np.argsort(-counts, kind="stable")       # heavy blocks first
    et_of = np.maximum(((counts + 127) // 128) * 128, 128)

    # tier boundaries: a tier spans blocks whose padded Et is within 2x
    # of the tier's heaviest block
    spans = []
    start = 0
    while start < num_blocks and len(spans) < max_tiers - 1:
        et0 = et_of[order[start]]
        stop = start + 1
        while stop < num_blocks and et_of[order[stop]] * 2 > et0:
            stop += 1
        spans.append((start, stop))
        start = stop
    if start < num_blocks:
        spans.append((start, num_blocks))

    # edge ranges per original block (dst-sorted input)
    bounds = np.searchsorted(r, np.arange(num_blocks + 1) * nb)

    tiers = []
    slots_tiered = 0
    for t0, t1 in spans:
        blocks_t = order[t0:t1]
        idx = np.concatenate(
            [np.arange(bounds[b], bounds[b + 1]) for b in blocks_t]
        ) if len(blocks_t) else np.zeros(0, np.int64)
        # tier-local dst key: local block index * nb + offset in block
        local_of = np.zeros(num_blocks, np.int64)
        local_of[blocks_t] = np.arange(len(blocks_t))
        r_t = local_of[blk[idx]] * nb + (r[idx] % nb)
        n_out_t = len(blocks_t) * nb
        d_np = _padded_layout_np(
            r_t, s[idx].astype(np.int32), em[idx], n_out_t, nb,
            edge_ids=idx,
        )
        lay_dst = _layout_from_np(d_np, n_out_t, nb, device, n_pad)
        tiers.append(BlockedOps(lay_dst=lay_dst))
        slots_tiered += lay_dst.num_blocks * lay_dst.tile_e

    row_order_np = (
        order[:, None] * nb + np.arange(nb)[None, :]
    ).reshape(-1)
    inv_order_np = np.zeros_like(row_order_np)
    inv_order_np[row_order_np] = np.arange(len(row_order_np))
    single_et = int(((counts.max() + 127) // 128) * 128) if len(counts) \
        else 128
    return TieredOps(
        tiers=tuple(tiers),
        tier_spans=tuple((int(a), int(b)) for a, b in spans),
        row_order=torch.from_numpy(row_order_np.astype(np.int64)).to(device),
        inv_order=torch.from_numpy(inv_order_np.astype(np.int64)).to(device),
        num_nodes_padded=n_pad,
        node_block=nb,
        slots_single=num_blocks * single_et,
        slots_tiered=int(slots_tiered),
    )
