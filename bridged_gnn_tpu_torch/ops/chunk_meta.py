"""Host-side chunk metadata for destination-sorted edge arrays.

Port of ``bridged_gnn_tpu/ops/chunk_meta.py`` (numpy only). For a
dst-sorted edge list each node block's edges form one contiguous range;
:func:`build_chunk_meta` gives each block the edge chunks that cover it.
It is the numpy version of the native library's ``gc_chunk_meta``
(``io/native.py::chunk_meta``), which the tests hold to it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SegmentChunkMeta(NamedTuple):
    """Host-precomputed chunk ranges for one (sorted) edge array."""

    chunk_base: np.ndarray   # [n_blocks] first edge-chunk index per block
    num_chunks: np.ndarray   # [n_blocks] chunks covering each block
    max_chunks: int          # largest num_chunks, at least 1
    node_block: int
    edge_chunk: int
    num_blocks: int


def build_chunk_meta(
    receivers: np.ndarray,
    num_edges_padded: int,
    num_nodes_padded: int,
    node_block: int = 256,
    edge_chunk: int = 1024,
) -> SegmentChunkMeta:
    """Per-node-block edge-chunk ranges (host side, once per graph).
    ``num_edges_padded`` is kept for the JAX signature; the ranges come
    from ``receivers`` alone."""
    r = np.asarray(receivers)
    n_blocks = -(-num_nodes_padded // node_block)
    block_edges_start = np.searchsorted(
        r, np.arange(n_blocks) * node_block, side="left"
    )
    block_edges_end = np.searchsorted(
        r, np.arange(1, n_blocks + 1) * node_block, side="left"
    )
    chunk_base = block_edges_start // edge_chunk
    chunk_end = np.where(
        block_edges_end > block_edges_start,
        (block_edges_end - 1) // edge_chunk + 1,
        chunk_base,
    )
    num_chunks = (chunk_end - chunk_base).astype(np.int32)
    max_chunks = int(num_chunks.max()) if len(num_chunks) else 1
    return SegmentChunkMeta(
        chunk_base=chunk_base.astype(np.int32),
        num_chunks=num_chunks,
        max_chunks=max(max_chunks, 1),
        node_block=node_block,
        edge_chunk=edge_chunk,
        num_blocks=n_blocks,
    )
