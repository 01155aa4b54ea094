"""Fused attention kernels: CUDA wrappers and their plain versions.

Port of the kernels of ``bridged_gnn_tpu/ops/pallas_fused.py`` and
``ops/pallas_padded.py``:

* :func:`attention_sel_fwd` — the selective (branch-selected) forward,
  ``_attention_sel_kernel`` (pallas_fused.py:501), on a single padded
  layout;
* :func:`attention_fwd` — the concatenated forward, ``_attention_kernel``
  (pallas_fused.py:168), run once per tier on degree-tiered layouts;
* :func:`attention_sel_bwd` — the selective backward,
  ``_attention_sel_bwd_kernel`` (pallas_fused.py:614);
* :func:`attention_bwd` — the concatenated backward,
  ``_attention_bwd_kernel`` (pallas_fused.py:281);
* :func:`slot_reduce` — the sender-keyed reduce of the backwards' slot
  cotangents, ``_reduce_kernel`` (pallas_padded.py:33).

The forwards live in ``csrc/attention_fwd.cu``, the backwards in
``csrc/attention_bwd.cu`` and the reduce in ``csrc/slot_reduce.cu``. Each
kernel also covers the index work its JAX wrapper ran around the Pallas
call: the forwards and backwards read sender rows by index from the
``u1``/``u2`` tables, and the reduce reads the dst-ordered slot rows by
index through the layout's sender CSR. The softmax is shifted by each
destination's own maximum (the TPU kernels shift by a block-wide maximum),
so raw ``ex`` differs from the TPU's by a per-block factor while
``α = ex / den`` and the outputs agree.

A wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; nothing else picks between the two. The plain versions
take the same arguments and compute the same function in straightforward
torch ops. No wrapper records autograd: the gradients come from the
autograd Functions of ``ops/fused_attention.py``, whose backwards launch
the backward kernels.

The kernels are built at first use for ``sm_90a``, one ``nvcc`` per
source started together, linked into one library under
``bridged_gnn_tpu_torch/_build/`` and loaded with ``ctypes``. Each wrapper
counts its launches (``launches``, and per attention width in
``launches_by_d``); :func:`record_launches` also times them with CUDA
events.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from bridged_gnn_tpu_torch.ops.blocked_segment import (
    HEAVY_SLOTS,
    PaddedLayout,
    slot_rows,
)

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG_DIR / "csrc").glob("*.cu")))
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)
_MAX_D = 256

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


# ------------------------------------------------------------------ build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _run_all(cmds: List[List[str]], what: str) -> None:
    """Run the commands at once; raise with the output of those that
    fail."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(c)} (exit {p.returncode}):\n{out}")
    if failed:
        raise RuntimeError(f"nvcc failed to build {what}:\n"
                           + "\n".join(failed))


def build_kernels() -> Tuple[Path, float]:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` per source, all started
    together) and link them into one library, unless that library is up
    to date (one hash over all the sources and the flags).

    Returns the library's path and the seconds the build took (0 when the
    library was already built). Raises with the compiler's output if
    ``nvcc`` fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"bgnn_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in SOURCES]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                  for src, o in zip(SOURCES, objs)],
                 str([s.name for s in SOURCES]))
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]], "the kernel library")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,
    # n_out, node_block, tile_e
    head = [p] * 8 + [f] + [i] * 5
    # ... out, ex|alpha, [den], stream
    lib.attention_sel_fwd.argtypes = head + [p, p, p, p]
    # ... dst_heavy, n_heavy, out, alpha, stream
    lib.attention_fwd.argtypes = head + [p, i, p, p, p]
    # ... ex, den, dout, dm, dud, da_part, n_parts, slot_c, stream
    lib.attention_sel_bwd.argtypes = head + [p] * 6 + [i, p, p]
    # ... alpha, dout, dm, dud, da_part, n_parts, stream
    lib.attention_bwd.argtypes = head + [p] * 5 + [i, p]
    # src_ranges, src_slots, vals, branch, src_heavy, n_heavy, w, n_ranges,
    # n_rows, out, stream
    lib.slot_reduce.argtypes = [p] * 5 + [i] * 4 + [p, p]
    consts = (lib.attention_bwd_rows_per_block, lib.attention_fwd_heavy_slots,
              lib.slot_reduce_heavy_entries)
    for fn in consts:
        fn.argtypes = []
    for fn in (lib.attention_sel_fwd, lib.attention_fwd,
               lib.attention_sel_bwd, lib.attention_bwd, lib.slot_reduce,
               *consts):
        fn.restype = i
    bounds = (lib.attention_fwd_heavy_slots(), lib.slot_reduce_heavy_entries())
    if bounds != (HEAVY_SLOTS, HEAVY_SLOTS):
        raise RuntimeError(
            f"the kernels' heavy-row bounds {bounds} differ from the "
            f"layouts' HEAVY_SLOTS = {HEAVY_SLOTS}")
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_kernels()[0])))
        return _lib


# ------------------------------------------------------------ validation


def _check_tensors(dev, floats: dict, others: dict) -> None:
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in {**floats, **others}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, u1 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_inputs(lay: PaddedLayout, u1, u2, ud, central, a1, a2) -> None:
    _check_tensors(u1.device, dict(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2),
                   dict(central=central, slot_src=lay.slot_src,
                        dst_ranges=lay.dst_ranges, dst_heavy=lay.dst_heavy))
    if central.dtype != torch.bool:
        raise TypeError(f"central must be bool, got {central.dtype}")
    for name in ("slot_src", "dst_ranges", "dst_heavy"):
        if getattr(lay, name).dtype != torch.int32:
            raise TypeError(f"layout {name} must be int32")
    if u1.dim() != 2 or u2.shape != u1.shape:
        raise ValueError(
            f"u1 and u2 must be equal [N, D]; got {list(u1.shape)} and "
            f"{list(u2.shape)}")
    n_in, d = u1.shape
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"D must be in [1, {_MAX_D}], got {d}")
    n_out = central.shape[0]
    n_rows = lay.num_blocks * lay.node_block
    if central.dim() != 1 or n_out > n_rows:
        raise ValueError(
            f"central must be [n_out] with n_out <= {n_rows}, got "
            f"{list(central.shape)}")
    if n_out < lay.num_nodes_padded:
        raise ValueError(
            f"central covers {n_out} rows but the layout has destinations "
            f"up to {lay.num_nodes_padded}")
    if list(ud.shape) != [n_out, d]:
        raise ValueError(f"ud must be [{n_out}, {d}], got {list(ud.shape)}")
    if list(a1.shape) != [d] or list(a2.shape) != [d]:
        raise ValueError(f"a1 and a2 must be [{d}]")
    if n_in < lay.sender_bound:
        raise ValueError(
            f"u tables have {n_in} rows; the layout gathers rows up to "
            f"{lay.sender_bound - 1}")
    if list(lay.dst_ranges.shape) != [n_rows, 2]:
        raise ValueError("layout dst_ranges must be [num_blocks*nb, 2]")


def _check_residuals(lay: PaddedLayout, u1, central, **floats) -> None:
    """The backward's per-slot weights (``ex``/``alpha`` [S]), the
    selective ``den`` [n_out] and ``dout`` [n_out, D]."""
    _check_tensors(u1.device, floats, {})
    n_out, d, n_slots = central.shape[0], u1.shape[1], lay.slot_src.shape[0]
    want = dict(ex=[n_slots], alpha=[n_slots], den=[n_out], dout=[n_out, d])
    for name, t in floats.items():
        if list(t.shape) != want[name]:
            raise ValueError(
                f"{name} must be {want[name]}, got {list(t.shape)}")


def _forward_only(**floats) -> None:
    """Raise where autograd would record through a kernel input."""
    if not torch.is_grad_enabled():
        return
    for name, t in floats.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad; the kernel wrappers record no "
                "autograd: differentiate through ops/fused_attention.py's "
                "AttentionSel and AttentionCat")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# While ``record_launches`` runs: (list of launch records, keep_inputs).
_recording: Optional[tuple] = None


@contextlib.contextmanager
def record_launches(keep_inputs: bool = False):
    """Record every kernel launch made inside the block.

    Yields a list that gets one dict per launch: the kernel's ``name``,
    its attention width ``d``, the CUDA events ``start`` and ``stop``
    recorded on the launch's stream around it and, with ``keep_inputs``,
    the wrapper's arguments ``inputs``, so that ``wrapper(*inputs)``
    replays the call. Costs two event records per launch while on and
    nothing while off. Plain runs on the CPU record nothing."""
    global _recording
    if _recording is not None:
        raise RuntimeError("record_launches does not nest")
    records: list = []
    _recording = (records, keep_inputs)
    try:
        yield records
    finally:
        _recording = None


def _launch(wrapper, d: int, args: List, inputs: tuple, dev) -> None:
    """Launch ``wrapper``'s kernel with the C arguments ``args`` on the
    current stream of ``dev`` and count the launch under width ``d``;
    ``inputs`` are the wrapper's own arguments, for recording.

    The stream comes as a raw handle (``_cuda_getCurrentRawStream``, as
    PyTorch's own generated kernels take it) and the device guard is set
    only when ``dev`` is not the current device: both keep the host's work
    per launch, which the card waits on when it is idle, small."""
    entry = getattr(_kernel_lib(), wrapper.__name__)
    recording = _recording
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    guard = (contextlib.nullcontext() if index == torch.cuda.current_device()
             else torch.cuda.device(index))
    with guard:
        if recording is not None:
            stream = torch.cuda.current_stream(index)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        wrapper.launches += 1
        wrapper.launches_by_d[d] = wrapper.launches_by_d.get(d, 0) + 1
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(index))
        if recording is not None:
            stop.record(stream)
            records, keep_inputs = recording
            records.append(dict(name=wrapper.__name__, d=d, start=start,
                                stop=stop,
                                inputs=inputs if keep_inputs else None))
    _raise_on(rc, wrapper.__name__)


def _attention_args(lay, u1, u2, ud, central, a1, a2, negative_slope):
    """The C arguments every attention kernel starts with."""
    return [
        lay.slot_src.data_ptr(), lay.dst_ranges.data_ptr(),
        u1.data_ptr(), u2.data_ptr(), ud.data_ptr(), central.data_ptr(),
        a1.data_ptr(), a2.data_ptr(), float(negative_slope), u1.shape[1],
        lay.num_blocks * lay.node_block, central.shape[0], lay.node_block,
        lay.tile_e,
    ]


# ------------------------------------------------------------ plain versions


def _plain_softmax(lay, u1, u2, ud, central, a1, a2, negative_slope):
    """Per-slot ``ex`` under the per-destination max, the destination
    sums ``den`` (0 ⇒ 1), the slot rows and the gathered sender rows."""
    n_out = central.shape[0]
    row, valid = slot_rows(lay)
    c = central[row] & valid
    s = lay.slot_src.clamp(min=0).long()
    m1, m2 = u1[s], u2[s]
    m = torch.where(c[:, None], m1, m2)
    h = torch.nn.functional.leaky_relu(m + ud[row], negative_slope)
    logit = torch.where(c, (h * a1).sum(-1), (h * a2).sum(-1))
    logit = torch.where(valid, logit, float("-inf"))
    mx = logit.new_full((n_out,), float("-inf")).scatter_reduce(
        0, row, logit, reduce="amax")
    ex = torch.where(valid, torch.exp(logit - mx[row]), 0.0)
    den = ex.new_zeros(n_out).index_add(0, row, ex)
    den = torch.where(den == 0, 1.0, den)
    return ex, den, row, m, m1, m2


def attention_sel_fwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_sel_fwd`."""
    ex, den, row, m, _, _ = _plain_softmax(
        lay, u1, u2, ud, central, a1, a2, negative_slope)
    n_out, d = central.shape[0], u1.shape[1]
    acc = m.new_zeros(n_out, d).index_add(0, row, ex[:, None] * m)
    return acc / den[:, None], ex, den


def attention_fwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_fwd`."""
    ex, den, row, _, m1, m2 = _plain_softmax(
        lay, u1, u2, ud, central, a1, a2, negative_slope)
    alpha = ex / den[row]
    n_out, d = central.shape[0], u1.shape[1]
    out = m1.new_zeros(n_out, 2 * d).index_add(
        0, row, alpha[:, None] * torch.cat([m1, m2], dim=1))
    return out, alpha


def _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha, dout,
               negative_slope):
    """Shared math of the two backward plain versions, from the per-slot
    ``alpha`` (0 on pad and masked slots): the D-wide ``dm`` of the
    selected branch, ``dud``, ``[da1 ‖ da2]`` and the slots' branch."""
    n_out, d = central.shape[0], u1.shape[1]
    row, valid = slot_rows(lay)
    c = central[row] & valid
    s = lay.slot_src.clamp(min=0).long()
    m = torch.where(c[:, None], u1[s], u2[s])
    go = dout[row]
    t = alpha * (m * go).sum(-1)
    seg = t.new_zeros(n_out).index_add(0, row, t)
    dl = t - alpha * seg[row]
    z = m + ud[row]
    h = torch.nn.functional.leaky_relu(z, negative_slope)
    g = torch.where(z > 0, 1.0, negative_slope)
    a_sel = torch.where(c[:, None], a1, a2)
    dz = torch.where(valid[:, None], dl[:, None] * a_sel * g, 0.0)
    dm = torch.where(valid[:, None], alpha[:, None] * go + dz, 0.0)
    dud = dz.new_zeros(n_out, d).index_add(0, row, dz)
    dlh = dl[:, None] * h
    da = torch.cat([torch.where(c[:, None], dlh, 0.0).sum(0),
                    torch.where((valid & ~c)[:, None], dlh, 0.0).sum(0)])
    return dm, dud, da, c


def attention_sel_bwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    ex: torch.Tensor, den: torch.Tensor, dout: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_sel_bwd`."""
    row, valid = slot_rows(lay)
    alpha = torch.where(valid, ex / den[row], 0.0)
    dm, dud, da, c = _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha,
                                dout, negative_slope)
    return dm, dud, da, c.to(torch.uint8)


def attention_bwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    alpha: torch.Tensor, dout: torch.Tensor, negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_bwd`."""
    dm, dud, da, c = _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha,
                                dout, negative_slope)
    zero = torch.zeros_like(dm)
    dm2 = torch.where(c[:, None], torch.cat([dm, zero], 1),
                      torch.cat([zero, dm], 1))
    return dm2, dud, da


def slot_reduce_plain(
    lay: PaddedLayout, vals: torch.Tensor, n_rows: int,
    branch: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`slot_reduce`."""
    r = lay.src_ranges.long()
    sender = torch.repeat_interleave(
        torch.arange(r.shape[0], device=vals.device), r[:, 1] - r[:, 0])
    p = lay.src_slots.long()
    v = vals[p]
    if branch is not None:
        b = branch[p].bool()[:, None]
        v = torch.cat([torch.where(b, v, 0.0), torch.where(b, 0.0, v)], 1)
    return v.new_zeros(n_rows, v.shape[1]).index_add(0, sender, v)


# ---------------------------------------------------------------- wrappers


def attention_sel_fwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selective fused attention forward over one padded layout.

    ``u1``/``u2`` [N_in, D]: sender rows of the branch used when the
    destination is central / target. ``ud`` [n_out, D]: the destination's
    own row of its branch. ``central`` [n_out] bool. ``a1``/``a2`` [D]:
    the GATv2 logit vectors of the two branches.

    Returns ``out`` [n_out, D], ``ex`` [B·Et] (per-slot softmax numerators
    under the per-destination max; 0 on pad slots) and ``den`` [n_out].
    """
    inputs = (lay, u1, u2, ud, central, a1, a2, negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2)
    if u1.device.type != "cuda":
        return attention_sel_fwd_plain(*inputs)
    _check_inputs(*inputs[:-1])
    n_out, d = central.shape[0], u1.shape[1]
    out = torch.empty(n_out, d, device=u1.device)
    ex = torch.empty(lay.slot_src.shape[0], device=u1.device)
    den = torch.empty(n_out, device=u1.device)
    args = _attention_args(*inputs) + [o.data_ptr() for o in (out, ex, den)]
    _launch(attention_sel_fwd, d, args, inputs, u1.device)
    return out, ex, den


def attention_fwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenated fused attention forward over one padded layout.

    Same arguments as :func:`attention_sel_fwd`. Returns ``out``
    [n_out, 2D] = ``[Σ α·u1[s] ‖ Σ α·u2[s]]`` (the caller keeps the
    destination's branch) and ``alpha`` [B·Et] (0 on pad slots)."""
    inputs = (lay, u1, u2, ud, central, a1, a2, negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2)
    if u1.device.type != "cuda":
        return attention_fwd_plain(*inputs)
    _check_inputs(*inputs[:-1])
    n_out, d = central.shape[0], u1.shape[1]
    out = torch.empty(n_out, 2 * d, device=u1.device)
    alpha = torch.empty(lay.slot_src.shape[0], device=u1.device)
    args = (_attention_args(*inputs)
            + [lay.dst_heavy.data_ptr(), lay.dst_heavy.shape[0]]
            + [o.data_ptr() for o in (out, alpha)])
    _launch(attention_fwd, d, args, inputs, u1.device)
    return out, alpha


def _bwd_outputs(lay, u1, central, dm_width: int):
    """dm [S, dm_width], dud [n_out, D] and one [da1 ‖ da2] partial row
    per thread block of the backward kernels."""
    dev, d = u1.device, u1.shape[1]
    rows = lay.num_blocks * lay.node_block
    per_block = _kernel_lib().attention_bwd_rows_per_block()
    n_parts = -(-rows // per_block)
    return (torch.empty(lay.slot_src.shape[0], dm_width, device=dev),
            torch.empty(central.shape[0], d, device=dev),
            torch.empty(n_parts, 2 * d, device=dev), n_parts)


def attention_sel_bwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    ex: torch.Tensor, den: torch.Tensor, dout: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selective fused attention backward over one padded layout.

    The forward's arguments, its residuals ``ex`` [B·Et] and ``den``
    [n_out] (:func:`attention_sel_fwd`), and the output cotangent ``dout``
    [n_out, D]. Returns ``dm`` [B·Et, D] (each slot's sender-row
    cotangent; 0 on pad and masked slots), ``dud`` [n_out, D] (the
    cotangent of ``ud``), ``da`` [2D] = ``[da1 ‖ da2]`` and ``slot_c``
    [B·Et] uint8 (1 where the slot's destination is central; 0 on pad and
    masked slots), which :func:`slot_reduce` takes as its branch."""
    inputs = (lay, u1, u2, ud, central, a1, a2, ex, den, dout,
              negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2, dout=dout)
    if u1.device.type != "cuda":
        return attention_sel_bwd_plain(*inputs)
    _check_inputs(lay, u1, u2, ud, central, a1, a2)
    _check_residuals(lay, u1, central, ex=ex, den=den, dout=dout)
    d = u1.shape[1]
    dm, dud, parts, n_parts = _bwd_outputs(lay, u1, central, d)
    slot_c = torch.empty(lay.slot_src.shape[0], dtype=torch.uint8,
                         device=u1.device)
    args = (_attention_args(lay, u1, u2, ud, central, a1, a2, negative_slope)
            + [t.data_ptr() for t in (ex, den, dout, dm, dud, parts)]
            + [n_parts, slot_c.data_ptr()])
    _launch(attention_sel_bwd, d, args, inputs, u1.device)
    return dm, dud, parts.sum(0), slot_c


def attention_bwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    alpha: torch.Tensor, dout: torch.Tensor, negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenated fused attention backward over one padded layout.

    The forward's arguments, its residual ``alpha`` [B·Et]
    (:func:`attention_fwd`) and the cotangent ``dout`` [n_out, D] of the
    destination's branch of its output. Returns ``dm`` [B·Et, 2D]
    (``[du1 row ‖ du2 row]`` per slot, the unselected half 0; 0 on pad and
    masked slots), ``dud`` [n_out, D] and ``da`` [2D] = ``[da1 ‖ da2]``."""
    inputs = (lay, u1, u2, ud, central, a1, a2, alpha, dout, negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2, dout=dout)
    if u1.device.type != "cuda":
        return attention_bwd_plain(*inputs)
    _check_inputs(lay, u1, u2, ud, central, a1, a2)
    _check_residuals(lay, u1, central, alpha=alpha, dout=dout)
    d = u1.shape[1]
    dm, dud, parts, n_parts = _bwd_outputs(lay, u1, central, 2 * d)
    args = (_attention_args(lay, u1, u2, ud, central, a1, a2, negative_slope)
            + [t.data_ptr() for t in (alpha, dout, dm, dud, parts)]
            + [n_parts])
    _launch(attention_bwd, d, args, inputs, u1.device)
    return dm, dud, parts.sum(0)


def slot_reduce(
    lay: PaddedLayout, vals: torch.Tensor, n_rows: int,
    branch: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sender-keyed reduce of per-slot rows over one padded layout.

    ``vals`` [B·Et, W]: one row per dst-layout slot (a backward's ``dm``).
    Returns ``out`` [n_rows, W] with ``out[r] = Σ vals[k]`` over the real
    slots ``k`` whose sender is ``r``, summed in the layout's sender-CSR
    order. With ``branch`` ([B·Et] uint8, :func:`attention_sel_bwd`'s
    ``slot_c``) it returns [n_rows, 2W]: a slot's row goes to ``[:, :W]``
    where its branch is 1 and to ``[:, W:]`` where it is 0. The launch
    counts under width ``W`` with ``branch`` and ``W/2`` without (the
    attention's D either way)."""
    inputs = (lay, vals, n_rows, branch)
    _forward_only(vals=vals)
    if vals.device.type != "cuda":
        return slot_reduce_plain(*inputs)
    others = dict(src_ranges=lay.src_ranges, src_slots=lay.src_slots,
                  src_heavy=lay.src_heavy)
    if branch is not None:
        others["branch"] = branch
    _check_tensors(vals.device, dict(vals=vals), others)
    n_slots, w = lay.slot_src.shape[0], vals.shape[-1]
    if vals.dim() != 2 or vals.shape[0] != n_slots or not 1 <= w <= 2 * _MAX_D:
        raise ValueError(f"vals must be [{n_slots}, W] with 1 <= W <= "
                         f"{2 * _MAX_D}, got {list(vals.shape)}")
    if branch is not None and (branch.dtype != torch.uint8
                               or list(branch.shape) != [n_slots]):
        raise ValueError(f"branch must be uint8 [{n_slots}]")
    for name in ("src_ranges", "src_slots", "src_heavy"):
        if getattr(lay, name).dtype != torch.int32:
            raise TypeError(f"layout {name} must be int32")
    if not lay.sender_bound <= n_rows:
        raise ValueError(f"n_rows is {n_rows}; the layout has senders up to "
                         f"{lay.sender_bound - 1}")
    out = torch.empty(n_rows, 2 * w if branch is not None else w,
                      device=vals.device)
    args = [lay.src_ranges.data_ptr(), lay.src_slots.data_ptr(),
            vals.data_ptr(), None if branch is None else branch.data_ptr(),
            lay.src_heavy.data_ptr(), lay.src_heavy.shape[0],
            w, lay.src_ranges.shape[0], n_rows, out.data_ptr()]
    _launch(slot_reduce, w if branch is not None else w // 2, args, inputs,
            vals.device)
    return out


KERNEL_WRAPPERS = (attention_sel_fwd, attention_fwd, attention_sel_bwd,
                   attention_bwd, slot_reduce)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counts (kernel launches only; plain
    runs never count)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_d = {}


reset_launch_counts()
