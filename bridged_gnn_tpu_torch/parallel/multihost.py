"""Process groups on ``torch.distributed``: joining one, and starting one.

Port of ``bridged_gnn_tpu/parallel/multihost.py``. Where the JAX package
has one process see every device of its host, the port runs one process
per shard (a *rank*), each on its own device, and combines them with
collectives.

* :func:`init_distributed` joins the process group, once per process.
  Under ``torchrun`` it reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (the roles of
  the JAX package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
  and ``JAX_PROCESS_ID``); a caller may pass an ``init_method`` instead,
  ``file://`` (no TCP store) or ``tcp://``.
* :func:`spawn` starts ``n`` local ranks itself (``torch.multiprocessing``,
  spawn context) on a ``file://`` store in a temporary directory, runs a
  function on every rank and returns each rank's result.

* :func:`make_pod_mesh` and :func:`flat_edge_mesh` lay the group's
  ranks out as the JAX package lays a pod's devices: hosts × local ranks
  in torchrun's node-major order, and the same ranks as one edge axis.

**Backend rule** (:func:`backend_for`), stated once here and printed by
:func:`describe` in the trainer's run header: ``nccl`` when every rank
of the host has a card of its own; ``gloo`` when ranks share one card
(NCCL refuses two ranks on one device) or run on the CPU. The backend is
chosen before the group forms and never switched on an error.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device_type: str, local_ranks: int,
                cards: Optional[int] = None) -> str:
    """``"nccl"`` when the ranks run on CUDA and the host has a card for
    each of its ``local_ranks``, else ``"gloo"``."""
    if device_type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count() if cards is None else cards
    return "nccl" if cards >= local_ranks else "gloo"


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def _local(world_size: int, rank: int):
    """(local rank, local world size): torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, or, without them, every rank on this host."""
    lr, lw = _env_int("LOCAL_RANK"), _env_int("LOCAL_WORLD_SIZE")
    return (rank if lr is None else lr, world_size if lw is None else lw)


def rank_device(device_type: str, world_size: int,
                rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda:<local rank>`` when the host
    has a card per local rank, ``cuda:0`` when its ranks share one, else
    the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    lr, lw = _local(world_size, rank)
    return torch.device("cuda", lr if backend_for("cuda", lw) == "nccl"
                        else 0)


def init_distributed(device_type: str = "cuda",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Join the process group (idempotent). Returns whether this process
    is in one.

    Arguments default to torchrun's environment (``WORLD_SIZE``,
    ``RANK``; ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). With
    neither arguments nor that environment the process is alone: no group
    forms and it returns False. The backend follows :func:`backend_for`
    for ``device_type``; on CUDA the rank's device (:func:`rank_device`)
    becomes the current one first, as NCCL needs."""
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world_size is None or rank is None:
        if init_method is not None:
            raise ValueError("init_method needs world_size and rank")
        return False
    backend = backend_for(device_type, _local(world_size, rank)[1])
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(device_type, world_size, rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def capture_rule(group, device) -> Tuple[bool, str]:
    """Scan mode's capture rule for a sharded run, fixed from the group's
    backend before the run: whether the epoch is captured in a CUDA graph
    (under NCCL on a card) and the rule's name, ``"nccl"`` or ``"none
    (<backend>)"`` (gloo's collectives on CUDA tensors go through the
    host, so a gloo epoch runs eagerly)."""
    backend = dist.get_backend(group)
    capture = torch.device(device).type == "cuda" and backend == "nccl"
    return capture, "nccl" if capture else f"none ({backend})"


def describe_capture(group, device) -> str:
    """The run header's line for scan mode's capture rule."""
    capture, name = capture_rule(group, device)
    return ("[parallel] scan capture: " + name
            + (": one CUDA graph of an epoch, replayed" if capture
               else ": every epoch runs eagerly, one copy to the host a "
               "chunk"))


def is_primary() -> bool:
    """True on rank 0, and in a process that is no rank (outside a group
    and without torchrun's ``RANK``): the process that prints and writes
    files."""
    if dist.is_initialized():
        return dist.get_rank() == 0
    return (_env_int("RANK") or 0) == 0


def describe(group, device: torch.device) -> str:
    """The run header's line: ranks, backend and where they run."""
    n = dist.get_world_size(group)
    backend = dist.get_backend(group)
    if device.type != "cuda":
        where = f"{n} ranks on the CPU"
    elif backend == "nccl":
        where = f"{n} ranks, one card each"
    else:
        where = f"{n} ranks share {device}"
    return (f"[parallel] backend {backend}: {where} (nccl when every rank "
            "has a card of its own, gloo when ranks share a card or run on "
            "the CPU)")


class RankMesh(NamedTuple):
    """Global ranks laid out on named axes (the port's counterpart of a
    JAX ``Mesh``): ``ranks`` holds rank ids, one axis per name."""

    ranks: np.ndarray
    axis_names: tuple


def make_pod_mesh(axis_names: Sequence[str] = ("host", "edges")
                  ) -> RankMesh:
    """The group's ranks as hosts × local ranks (JAX ``make_pod_mesh``):
    torchrun numbers ranks node-major, rank = node · local world size +
    local rank, so row ``h`` holds host ``h``'s ranks. Edge shards then
    lie on the inner axis, within a host; only small per-node partials
    cross hosts. A process outside a group is one host of one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = _local(world, rank)[1]
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{local}")
    return RankMesh(np.arange(world).reshape(world // local, local),
                    tuple(axis_names))


def flat_edge_mesh(mesh: RankMesh, axis_name: str = "edges") -> RankMesh:
    """``mesh``'s ranks as one edge axis, host-major (JAX
    ``flat_edge_mesh``): contiguous edge spans stay on one host."""
    return RankMesh(mesh.ranks.reshape(-1), (axis_name,))


# ------------------------------------------------------------------ spawn


def _rank_main(fn, rank: int, n: int, init_method: str, device_type: str,
               args: Sequence[Any], results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    if device_type != "cuda":
        # CPU ranks share the host's cores rather than each taking all
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    try:
        init_distributed(device_type, init_method, n, rank)
        # plain pickle bytes: torch's queue reductions would share tensor
        # storage by file descriptor, which dies with this process
        results.put(("ok", rank, pickle.dumps(fn(*args))))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, args: Sequence[Any] = (),
          device_type: str = "cuda",
          timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``n_ranks`` local ranks that form one process
    group (backend by :func:`backend_for`, store on a ``file://`` path in
    a temporary directory) and return their results, rank 0's first.
    CPU ranks split the host's cores between them.

    ``fn``, ``args`` and the results travel pickled, so ``fn`` is a
    module-level function. When a rank raises or dies, the others are
    terminated and ``RuntimeError`` carries its traceback. There is no
    deadline unless the caller gives one: past ``timeout_s`` every rank is
    terminated and ``TimeoutError`` raised."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="bgnn_group_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n_ranks, init_method, device_type,
                                   tuple(args), results), daemon=False)
                 for r in range(n_ranks)]
        for p in procs:
            p.start()
        got, ok = {}, False
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        try:
            while len(got) < n_ranks:
                try:
                    kind, rank, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0][0]} exited with code "
                            f"{dead[0][1]} before reporting a result")
                    if deadline is not None and time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{n_ranks} ranks did not finish in "
                            f"{timeout_s} s")
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
            ok = True
        finally:
            for p in procs:
                if not ok and p.is_alive():
                    p.terminate()
                p.join(timeout=60.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(n_ranks)]
