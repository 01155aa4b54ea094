"""The group of ranks a sharded run trains over.

Port of ``bridged_gnn_tpu/parallel/mesh.py``: where the JAX package lays
the first n devices out as a 1-D mesh, the port forms one process group
of ``n_shards`` ranks, one rank per shard (``parallel/multihost.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from bridged_gnn_tpu_torch.parallel.multihost import (
    init_distributed,
    rank_device,
)


def make_group(n_shards: int, device="cuda",
               group=None) -> Tuple[object, torch.device]:
    """The process group of ``n_shards`` ranks, one per shard, and this
    rank's device. Joins the group from torchrun's environment when the
    process is not in one yet; raises ``RuntimeError`` when there is no
    group to join and ``ValueError`` when its size is not ``n_shards``.
    ``group``: a group the caller formed, used in place of the default
    one (its size checked alike)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but "
            "torch.cuda.is_available() is false")
    if group is not None:
        if dist.get_world_size(group) != n_shards:
            raise ValueError(f"n_shards={n_shards} but the group has "
                             f"{dist.get_world_size(group)} ranks")
        return group, (torch.device("cuda", torch.cuda.current_device())
                       if dev.type == "cuda" else torch.device("cpu"))
    if not init_distributed(dev.type):
        raise RuntimeError(
            f"n_shards={n_shards} needs a process group of {n_shards} "
            "ranks: run under torchrun --nproc_per_node "
            f"{n_shards}, or start the ranks with parallel.multihost.spawn")
    n = dist.get_world_size()
    if n != n_shards:
        raise ValueError(f"n_shards={n_shards} but the process group has "
                         f"{n} ranks")
    return dist.group.WORLD, rank_device(dev.type, n, dist.get_rank())
