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
  cotangents, ``_reduce_kernel`` (pallas_padded.py:33);
* :func:`gather_reduce` — the same ``_reduce_kernel`` in its
  destination-keyed use, the padded SpMM ``y[v] = Σ w·x[u]`` of the model
  zoo (``gather_reduce_pallas``, pallas_padded.py:135), and its transpose
  over the sender CSR for the SpMM's backward.

The forwards live in ``csrc/attention_fwd.cu``, the backwards in
``csrc/attention_bwd.cu``, the reduce in ``csrc/slot_reduce.cu`` and the
SpMM in ``csrc/gather_reduce.cu``. Each
kernel also covers the index work its JAX wrapper ran around the Pallas
call: the forwards and backwards read sender rows by index from the
``u1``/``u2`` tables, and the reduce reads the dst-ordered slot rows by
index through the layout's sender CSR. The softmax is shifted by each
destination's own maximum (the TPU kernels shift by a block-wide maximum),
so raw ``ex`` differs from the TPU's by a per-block factor while
``α = ex / den`` and the outputs agree.

A wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; nothing else picks between the two. Every kernel takes
any width: past :data:`LANE_GROUP_COLUMNS` the attention kernels switch
to their wide path at launch. The plain versions take the same arguments and
compute the same function in straightforward torch ops, walking the slots
in chunks of whole layout blocks so that a wide ``D`` on a large graph
holds no more than a chunk's ``[slots, D]`` temporaries at once. No
wrapper records autograd: the gradients come from the autograd Functions
of ``ops/fused_attention.py``, whose backwards launch the backward
kernels.

Message dtypes. The ``u1``/``u2``/``ud`` tables (and the reduce's
``vals``) are float32 or bfloat16 (the SpMM's ``x``: float32 only), one
dtype per call: each kernel is built for both, widens bf16 rows to f32
on load and keeps every sum in f32. The backwards write ``dm`` in the tables' dtype, rounded once at the
store; every other output is f32. The plain versions take the same
arguments, widen the tables to f32 and round ``dm`` once on the way out.

The kernels are built at first use for ``sm_90a``, one ``nvcc`` per
source started together, linked into one library under
``bridged_gnn_tpu_torch/_build/`` and loaded with ``ctypes``. Each wrapper
counts its launches (``launches``, and per attention width and message
dtype in ``launches_by_d``, keyed by :func:`launch_key`);
:func:`record_launches` also times them with CUDA events. Inside a CUDA graph capture a wrapper counts its launch once,
when it is captured; :func:`launch_counts` snapshots give what each
replay launches. The C entry points only launch on the stream they are
given and call ``cudaGetLastError``, both legal while a stream captures.
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
from typing import Dict, List, Optional, Tuple

import torch

from bridged_gnn_tpu_torch.ops.blocked_segment import (
    HEAVY_SLOTS,
    PaddedLayout,
    slot_rows,
)

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG_DIR / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG_DIR / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC",
)
# The widest row the attention kernels' lane groups hold in registers
# (kLaneGroupColumns in csrc/lane_groups.cuh, checked at load time): wider
# rows take the kernels' wide path, whose backward needs a per-slot scratch.
LANE_GROUP_COLUMNS = 256
# Elements of one [slots, D] temporary of a plain version (see above).
_PLAIN_CHUNK = 1 << 25
# The padded SpMM's widest column panel (kMaxPanel in csrc/gather_reduce.cu,
# checked at load time): 32 lanes of 4 columns.
MAX_PANEL = 128
# The share of the card's L2 that one panel's rows of x may fill (the
# footprint sweep of tools/torch_spmm_panels.py, PERF.md).
PANEL_L2_SHARE = 0.75
# The message dtypes the kernels take, and the suffix of each one's C entry
# points.
_ENTRY_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

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
    to date (one hash over all the sources, the ``csrc/*.cuh`` headers they
    include and the flags).

    Returns the library's path and the seconds the build took (0 when the
    library was already built). Raises with the compiler's output if
    ``nvcc`` fails."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
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
    # n_out, node_block, tile_e, dst_heavy, n_heavy
    head = [p] * 8 + [f] + [i] * 5 + [p, i]
    argtypes = dict(
        # ... out, ex, den, stream
        attention_sel_fwd=head + [p, p, p, p],
        # ... out, alpha, stream
        attention_fwd=head + [p, p, p],
        # ... ex, den, out, dout, dm, dud, da_part, n_parts, slot_c,
        # scratch, stream
        attention_sel_bwd=head + [p] * 7 + [i, p, p, p],
        # ... alpha, out, dout, dm, dud, da_part, n_parts, slot_c, scratch,
        # stream
        attention_bwd=head + [p] * 6 + [i, p, p, p],
        # src_ranges, src_slots, vals, branch, src_heavy, n_heavy, w,
        # n_ranges, n_rows, out, stream
        slot_reduce=[p] * 5 + [i] * 4 + [p, p],
    )
    entries = []
    for name, types in argtypes.items():
        for suffix in _ENTRY_SUFFIX.values():
            fn = getattr(lib, name + suffix)
            fn.argtypes = types
            entries.append(fn)
    # ranges, idx, wmap, w, x, heavy, n_heavy, d, n_ranges, n_rows, panel,
    # out, stream (f32 only)
    lib.gather_reduce.argtypes = [p] * 6 + [i] * 5 + [p, p]
    entries.append(lib.gather_reduce)
    # n_rows_layout, n_heavy, d
    lib.attention_bwd_grid.argtypes = [i] * 3
    # the attention sources share their bounds (csrc/lane_groups.cuh)
    consts = ((lib.attention_fwd_heavy_slots, HEAVY_SLOTS),
              (lib.slot_reduce_heavy_entries, HEAVY_SLOTS),
              (lib.gather_reduce_heavy_entries, HEAVY_SLOTS),
              (lib.gather_reduce_max_panel, MAX_PANEL),
              (lib.attention_lane_group_columns, LANE_GROUP_COLUMNS))
    for fn, _ in consts:
        fn.argtypes = []
    for fn in (*entries, lib.attention_bwd_grid, *(fn for fn, _ in consts)):
        fn.restype = i
    for fn, want in consts:
        if fn() != want:
            raise RuntimeError(
                f"the kernels' {fn.__name__} is {fn()}, Python's {want}")
    return lib


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_kernels()[0])))
        return _lib


# ------------------------------------------------------------ validation


def _check_tensors(dev, floats: dict, others: dict,
                   tables: Optional[dict] = None) -> None:
    """Device and contiguity of every tensor; ``floats`` float32,
    ``tables`` float32 or bfloat16, all of one dtype."""
    tables = tables or {}
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in tables.items():
        if t.dtype not in _ENTRY_SUFFIX:
            raise TypeError(
                f"{name} must be float32 or bfloat16, got {t.dtype}")
    if len({t.dtype for t in tables.values()}) > 1:
        raise TypeError("the message tables must share one dtype, got "
                        + ", ".join(f"{n} {t.dtype}"
                                    for n, t in tables.items()))
    for name, t in {**floats, **others, **tables}.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, u1 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_inputs(lay: PaddedLayout, u1, u2, ud, central, a1, a2) -> None:
    _check_tensors(u1.device, dict(a1=a1, a2=a2),
                   dict(central=central, slot_src=lay.slot_src,
                        dst_ranges=lay.dst_ranges, dst_heavy=lay.dst_heavy),
                   dict(u1=u1, u2=u2, ud=ud))
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
    if d < 1:
        raise ValueError(f"D must be at least 1, got {d}")
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
    selective ``den`` [n_out], the forward's ``out`` and ``dout`` [n_out,
    D]."""
    _check_tensors(u1.device, floats, {})
    n_out, d, n_slots = central.shape[0], u1.shape[1], lay.slot_src.shape[0]
    want = dict(ex=[n_slots], alpha=[n_slots], den=[n_out], out=[n_out, d],
                dout=[n_out, d])
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
    its attention width ``d``, its message ``dtype`` (a torch dtype), its
    count ``key`` (:func:`launch_key`), the CUDA events ``start`` and
    ``stop``
    recorded on the launch's stream around it and, with ``keep_inputs``,
    the wrapper's arguments ``inputs``, so that ``wrapper(*inputs)``
    replays the call. Costs two event records per launch while on and
    nothing while off. Plain runs on the CPU record nothing. A launch
    inside a CUDA graph capture raises while it is on: events recorded
    into a graph would time its capture, not its replays."""
    global _recording
    if _recording is not None:
        raise RuntimeError("record_launches does not nest")
    records: list = []
    _recording = (records, keep_inputs)
    try:
        yield records
    finally:
        _recording = None


def launch_key(d: int, dtype: torch.dtype):
    """The key a launch counts under in ``launches_by_d``: the width ``d``
    for float32 message tables, ``"<d>:bf16"`` for bfloat16 ones."""
    return d if dtype == torch.float32 else f"{d}:bf16"


def _launch(wrapper, d: int, dtype: torch.dtype, args: List, inputs: tuple,
            dev) -> None:
    """Launch ``wrapper``'s kernel for message dtype ``dtype`` with the C
    arguments ``args`` on the current stream of ``dev`` and count the
    launch under :func:`launch_key`; ``inputs`` are the wrapper's own
    arguments, for recording.

    The stream comes as a raw handle (``_cuda_getCurrentRawStream``, as
    PyTorch's own generated kernels take it) and the device guard is set
    only when ``dev`` is not the current device: both keep the host's work
    per launch, which the card waits on when it is idle, small."""
    entry = getattr(_kernel_lib(), wrapper.__name__ + _ENTRY_SUFFIX[dtype])
    key = launch_key(d, dtype)
    recording = _recording
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    guard = (contextlib.nullcontext() if index == torch.cuda.current_device()
             else torch.cuda.device(index))
    with guard:
        if recording is not None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{wrapper.__name__}: record_launches is on during a "
                    "CUDA graph capture; count a graph's launches with "
                    "launch_counts() around the capture instead")
            stream = torch.cuda.current_stream(index)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        wrapper.launches += 1
        wrapper.launches_by_d[key] = wrapper.launches_by_d.get(key, 0) + 1
        rc = entry(*args, torch._C._cuda_getCurrentRawStream(index))
        if recording is not None:
            stop.record(stream)
            records, keep_inputs = recording
            records.append(dict(name=wrapper.__name__, d=d, dtype=dtype,
                                key=key, start=start, stop=stop,
                                inputs=inputs if keep_inputs else None))
    _raise_on(rc, wrapper.__name__)


def _attention_args(lay, u1, u2, ud, central, a1, a2, negative_slope):
    """The C arguments every attention kernel starts with."""
    return [
        lay.slot_src.data_ptr(), lay.dst_ranges.data_ptr(),
        u1.data_ptr(), u2.data_ptr(), ud.data_ptr(), central.data_ptr(),
        a1.data_ptr(), a2.data_ptr(), float(negative_slope), u1.shape[1],
        lay.num_blocks * lay.node_block, central.shape[0], lay.node_block,
        lay.tile_e, lay.dst_heavy.data_ptr(), lay.dst_heavy.shape[0],
    ]


# ------------------------------------------------------------ plain versions


def _widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 table widened to f32 for the plain versions' arithmetic;
    f32 and f64 tables as they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _block_chunks(lay: PaddedLayout, width: int):
    """Flat slot ranges of whole layout blocks, about ``_PLAIN_CHUNK //
    width`` slots each. A destination's slots never leave its block, so
    every per-destination sum of a chunk is complete."""
    per = max(1, _PLAIN_CHUNK // (lay.tile_e * max(width, 1)))
    for b0 in range(0, lay.num_blocks, per):
        yield slice(b0 * lay.tile_e,
                    min(b0 + per, lay.num_blocks) * lay.tile_e)


def _plain_fwd(lay, u1, u2, ud, central, a1, a2, negative_slope, concat):
    """Shared forward of the two plain versions: per-slot ``ex`` under the
    per-destination max (0 on pad and masked slots), the destination sums
    ``den`` (0 ⇒ 1), and ``Σ ex·m / den`` over the selected branch's
    sender rows ([n_out, D]) or over both tables' ([n_out, 2D]). bf16
    tables are widened to f32 first; every output is f32."""
    u1, u2, ud = _widen(u1), _widen(u2), _widen(ud)
    n_out, d = central.shape[0], u1.shape[1]
    row, valid = slot_rows(lay)
    ex = u1.new_zeros(lay.slot_src.shape[0])
    den = u1.new_zeros(n_out)
    acc = u1.new_zeros(n_out, 2 * d if concat else d)
    for sl in _block_chunks(lay, 2 * d if concat else d):
        r, v = row[sl], valid[sl]
        c = central[r] & v
        s = lay.slot_src[sl].clamp(min=0).long()
        m1, m2 = u1[s], u2[s]
        m = torch.where(c[:, None], m1, m2)
        h = torch.nn.functional.leaky_relu(m + ud[r], negative_slope)
        logit = torch.where(c, (h * a1).sum(-1), (h * a2).sum(-1))
        logit = torch.where(v, logit, float("-inf"))
        mx = logit.new_full((n_out,), float("-inf")).scatter_reduce(
            0, r, logit, reduce="amax")
        e = torch.where(v, torch.exp(logit - mx[r]), 0.0)
        ex[sl] = e
        den.index_add_(0, r, e)
        acc.index_add_(0, r, e[:, None] * (torch.cat([m1, m2], dim=1)
                                           if concat else m))
    den = torch.where(den == 0, 1.0, den)
    return acc / den[:, None], ex, den, row


def attention_sel_fwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_sel_fwd`."""
    out, ex, den, _ = _plain_fwd(lay, u1, u2, ud, central, a1, a2,
                                 negative_slope, concat=False)
    return out, ex, den


def attention_fwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_fwd`."""
    out, ex, den, row = _plain_fwd(lay, u1, u2, ud, central, a1, a2,
                                   negative_slope, concat=True)
    return out, ex / den[row]


def _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha, out, dout,
               negative_slope):
    """Shared math of the two backward plain versions, from the per-slot
    ``alpha`` (0 on pad and masked slots) and the forward's ``out``: the
    D-wide ``dm`` of the selected branch, ``dud``, ``[da1 ‖ da2]`` and
    the slots' branch as uint8. Each destination's softmax term
    ``S_v = Σ_k α_k (m_k · dout_v)`` is ``dout_v · out_v``, as in the
    kernels. bf16 tables are widened to f32 first; ``dm`` is written in
    the tables' dtype, each chunk rounded once."""
    dm = u1.new_empty(lay.slot_src.shape[0], u1.shape[1])
    u1, u2, ud = _widen(u1), _widen(u2), _widen(ud)
    n_out, d = central.shape[0], u1.shape[1]
    row, valid = slot_rows(lay)
    seg = (dout * out).sum(-1)
    dud = u1.new_zeros(n_out, d)
    da = u1.new_zeros(2 * d)
    for sl in _block_chunks(lay, d):
        r, v, al = row[sl], valid[sl], alpha[sl]
        c = central[r] & v
        s = lay.slot_src[sl].clamp(min=0).long()
        m = torch.where(c[:, None], u1[s], u2[s])
        go = dout[r]
        dl = al * (m * go).sum(-1) - al * seg[r]
        z = m + ud[r]
        h = torch.nn.functional.leaky_relu(z, negative_slope)
        g = torch.where(z > 0, torch.ones_like(z), negative_slope)
        a_sel = torch.where(c[:, None], a1, a2)
        dz = torch.where(v[:, None], dl[:, None] * a_sel * g, 0.0)
        dm[sl] = torch.where(v[:, None], al[:, None] * go + dz, 0.0)
        dud.index_add_(0, r, dz)
        dlh = dl[:, None] * h
        da += torch.cat([torch.where(c[:, None], dlh, 0.0).sum(0),
                         torch.where((v & ~c)[:, None], dlh, 0.0).sum(0)])
    return dm, dud, da, (central[row] & valid).to(torch.uint8)


def attention_sel_bwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    ex: torch.Tensor, den: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_sel_bwd`."""
    row, valid = slot_rows(lay)
    alpha = torch.where(valid, ex / den[row], 0.0)
    return _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha, out, dout,
                      negative_slope)


def attention_bwd_plain(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    alpha: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`attention_bwd`."""
    return _plain_bwd(lay, u1, u2, ud, central, a1, a2, alpha, out, dout,
                      negative_slope)


def slot_reduce_plain(
    lay: PaddedLayout, vals: torch.Tensor, n_rows: int, branch: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`slot_reduce`, over chunks of CSR entries;
    bf16 rows are widened to f32, and the output is f32."""
    r = lay.src_ranges.long()
    sender = torch.repeat_interleave(
        torch.arange(r.shape[0], device=vals.device), r[:, 1] - r[:, 0])
    p = lay.src_slots.long()
    w = vals.shape[1]
    out = _widen(vals.new_zeros(n_rows, 2 * w))
    step = max(1, _PLAIN_CHUNK // w)
    for k0 in range(0, p.shape[0], step):
        v = _widen(vals[p[k0:k0 + step]])
        b = branch[p[k0:k0 + step]].bool()[:, None]
        out.index_add_(0, sender[k0:k0 + step],
                       torch.cat([torch.where(b, v, 0.0),
                                  torch.where(b, 0.0, v)], 1))
    return out


def gather_index(lay: PaddedLayout, transpose: bool):
    """What :func:`gather_reduce` walks: per entry its key row, the row of
    ``x`` it gathers and its slot (for the weight), over the real slots;
    the forward's entries are the slots in order, the transpose's the
    sender CSR's."""
    if transpose:
        r = lay.src_ranges.long()
        key = torch.repeat_interleave(
            torch.arange(r.shape[0], device=r.device), r[:, 1] - r[:, 0])
        return key, lay.src_dst.long(), lay.src_slots.long()
    row, valid = slot_rows(lay)
    slot = torch.nonzero(valid)[:, 0]
    return row[slot].long(), lay.slot_src[slot].long(), slot


def gather_panel(n_x: int, d: int, l2_bytes: int) -> int:
    """The widest column panel, in columns, that :func:`gather_reduce`
    walks ``x`` [n_x, d] in: one panel of ``d`` (rounded up to 4) when the
    whole table fits :data:`PANEL_L2_SHARE` of ``l2_bytes`` and ``d <=``
    :data:`MAX_PANEL`; else the widest power of two times 4 columns, at
    least 4 and at most :data:`MAX_PANEL`, whose ``n_x`` rows fit that
    share. The kernel splits ``d`` into :func:`gather_panel_count` panels
    of at most this width."""
    fit = int(PANEL_L2_SHARE * l2_bytes) // (4 * max(n_x, 1))
    if d <= min(fit, MAX_PANEL):
        return -(-d // 4) * 4
    panel = 4
    while 2 * panel <= min(fit, MAX_PANEL):
        panel *= 2
    return panel


def gather_panel_count(d: int, panel: int) -> int:
    """The panels the kernel walks ``d`` columns in, each at most
    ``panel`` wide: ``⌈⌈d/4⌉ / ⌈panel/4⌉⌉`` (``panel_count`` in
    csrc/gather_reduce.cu, which splits the column quads over them as
    evenly as whole quads allow)."""
    m, q = -(-d // 4), -(-panel // 4)
    return -(-m // q)


_l2_bytes: Dict[int, int] = {}


def _l2_size(dev) -> int:
    """The L2 cache of CUDA device ``dev`` in bytes, read once per
    device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _l2_bytes:
        _l2_bytes[index] = torch.cuda.get_device_properties(
            index).L2_cache_size
    return _l2_bytes[index]


def gather_reduce_plain(
    lay: PaddedLayout, x: torch.Tensor, n_rows: int,
    w_slot: Optional[torch.Tensor] = None, transpose: bool = False,
) -> torch.Tensor:
    """Plain version of :func:`gather_reduce`, over chunks of entries."""
    key, src, slot = gather_index(lay, transpose)
    d = x.shape[1]
    out = x.new_zeros(n_rows, d)
    step = max(1, _PLAIN_CHUNK // d)
    for k0 in range(0, key.shape[0], step):
        rows = x[src[k0:k0 + step]]
        if w_slot is not None:
            rows = w_slot[slot[k0:k0 + step]][:, None] * rows
        out.index_add_(0, key[k0:k0 + step], rows)
    return out


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
    The kernel reads only the destination's table and gives each of the
    layout's ``dst_heavy`` rows a thread block of its own.
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
    _launch(attention_sel_fwd, d, u1.dtype, args, inputs, u1.device)
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
    args = _attention_args(*inputs) + [o.data_ptr() for o in (out, alpha)]
    _launch(attention_fwd, d, u1.dtype, args, inputs, u1.device)
    return out, alpha


def _bwd_launch(wrapper, lay, u1, u2, ud, central, a1, a2, residuals,
                negative_slope, inputs):
    """Allocate a backward kernel's outputs — ``dm`` [S, D] in the
    tables' dtype, ``dud``
    [n_out, D], one ``[da1 ‖ da2]`` partial row per thread block (the
    library gives the grid size) and ``slot_c`` [S] — and, past
    :data:`LANE_GROUP_COLUMNS`, the wide path's per-slot scratch; launch
    the kernel, and return its outputs with the partials summed in block
    order."""
    dev, d = u1.device, u1.shape[1]
    n_slots = lay.slot_src.shape[0]
    n_parts = _kernel_lib().attention_bwd_grid(
        lay.num_blocks * lay.node_block, lay.dst_heavy.shape[0], d)
    dm = torch.empty(n_slots, d, dtype=u1.dtype, device=dev)
    dud = torch.empty(central.shape[0], d, device=dev)
    parts = torch.empty(n_parts, 2 * d, device=dev)
    slot_c = torch.empty(n_slots, dtype=torch.uint8, device=dev)
    scratch = (torch.empty(n_slots, device=dev) if d > LANE_GROUP_COLUMNS
               else None)
    args = (_attention_args(lay, u1, u2, ud, central, a1, a2, negative_slope)
            + [t.data_ptr() for t in (*residuals, dm, dud, parts)]
            + [n_parts, slot_c.data_ptr(),
               None if scratch is None else scratch.data_ptr()])
    _launch(wrapper, d, u1.dtype, args, inputs, dev)
    return dm, dud, parts.sum(0), slot_c


def attention_sel_bwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    ex: torch.Tensor, den: torch.Tensor, out: torch.Tensor,
    dout: torch.Tensor, negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selective fused attention backward over one padded layout.

    The forward's arguments, its residuals ``ex`` [B·Et] and ``den``
    [n_out] and its output ``out`` [n_out, D] (:func:`attention_sel_fwd`),
    and the output cotangent ``dout`` [n_out, D]. Returns ``dm`` [B·Et, D]
    (each slot's sender-row cotangent; 0 on pad and masked slots), ``dud``
    [n_out, D] (the cotangent of ``ud``), ``da`` [2D] = ``[da1 ‖ da2]``
    and ``slot_c`` [B·Et] uint8 (1 where the slot's destination is
    central; 0 on pad and masked slots), which :func:`slot_reduce` takes
    as its branch."""
    inputs = (lay, u1, u2, ud, central, a1, a2, ex, den, out, dout,
              negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2, out=out, dout=dout)
    if u1.device.type != "cuda":
        return attention_sel_bwd_plain(*inputs)
    _check_inputs(lay, u1, u2, ud, central, a1, a2)
    _check_residuals(lay, u1, central, ex=ex, den=den, out=out, dout=dout)
    return _bwd_launch(attention_sel_bwd, lay, u1, u2, ud, central, a1, a2,
                       (ex, den, out, dout), negative_slope, inputs)


def attention_bwd(
    lay: PaddedLayout, u1: torch.Tensor, u2: torch.Tensor, ud: torch.Tensor,
    central: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    alpha: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    negative_slope: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenated fused attention backward over one padded layout.

    The forward's arguments, its residual ``alpha`` [B·Et]
    (:func:`attention_fwd`), the destination's branch ``out`` [n_out, D]
    of its output and that branch's cotangent ``dout`` [n_out, D].
    Returns what :func:`attention_sel_bwd` returns: ``dm`` [B·Et, D] in
    the destination's branch, ``dud``, ``da`` and the slots' branch
    ``slot_c``."""
    inputs = (lay, u1, u2, ud, central, a1, a2, alpha, out, dout,
              negative_slope)
    _forward_only(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2, out=out, dout=dout)
    if u1.device.type != "cuda":
        return attention_bwd_plain(*inputs)
    _check_inputs(lay, u1, u2, ud, central, a1, a2)
    _check_residuals(lay, u1, central, alpha=alpha, out=out, dout=dout)
    return _bwd_launch(attention_bwd, lay, u1, u2, ud, central, a1, a2,
                       (alpha, out, dout), negative_slope, inputs)


def slot_reduce(
    lay: PaddedLayout, vals: torch.Tensor, n_rows: int, branch: torch.Tensor,
) -> torch.Tensor:
    """Sender-keyed reduce of per-slot rows over one padded layout.

    ``vals`` [B·Et, W], float32 or bfloat16: one row per dst-layout slot
    (a backward's ``dm``);
    ``branch`` [B·Et] uint8: the slot's branch (the backward's ``slot_c``).
    Returns ``out`` [n_rows, 2W] = ``[du1 ‖ du2]``: ``out[r, :W]`` sums
    ``vals[k]`` over the real slots ``k`` whose sender is ``r`` and whose
    branch is 1, ``out[r, W:]`` those whose branch is 0, each in the
    layout's sender-CSR order, in f32. The launch counts under width ``W``
    and ``vals``' dtype."""
    inputs = (lay, vals, n_rows, branch)
    _forward_only(vals=vals)
    if vals.device.type != "cuda":
        return slot_reduce_plain(*inputs)
    _check_tensors(vals.device, {},
                   dict(src_ranges=lay.src_ranges, src_slots=lay.src_slots,
                        src_heavy=lay.src_heavy, branch=branch),
                   dict(vals=vals))
    n_slots, w = lay.slot_src.shape[0], vals.shape[-1]
    if vals.dim() != 2 or vals.shape[0] != n_slots or w < 1:
        raise ValueError(f"vals must be [{n_slots}, W] with W >= 1, got "
                         f"{list(vals.shape)}")
    if branch.dtype != torch.uint8 or list(branch.shape) != [n_slots]:
        raise ValueError(f"branch must be uint8 [{n_slots}]")
    for name in ("src_ranges", "src_slots", "src_heavy"):
        if getattr(lay, name).dtype != torch.int32:
            raise TypeError(f"layout {name} must be int32")
    if not lay.sender_bound <= n_rows:
        raise ValueError(f"n_rows is {n_rows}; the layout has senders up to "
                         f"{lay.sender_bound - 1}")
    out = torch.empty(n_rows, 2 * w, device=vals.device)
    args = [lay.src_ranges.data_ptr(), lay.src_slots.data_ptr(),
            vals.data_ptr(), branch.data_ptr(),
            lay.src_heavy.data_ptr(), lay.src_heavy.shape[0],
            w, lay.src_ranges.shape[0], n_rows, out.data_ptr()]
    _launch(slot_reduce, w, vals.dtype, args, inputs, vals.device)
    return out


def gather_reduce(
    lay: PaddedLayout, x: torch.Tensor, n_rows: int,
    w_slot: Optional[torch.Tensor] = None, transpose: bool = False,
) -> torch.Tensor:
    """Padded SpMM over one layout, or its transpose; f32.

    Forward (``transpose=False``): ``out[v] = Σ w_slot[k] · x[slot_src[k]]``
    over the real slots ``k`` of destination row ``v``, in slot order, for
    ``v < n_rows`` (``lay.num_nodes_padded`` for the SpMM). Transpose:
    ``out[u] = Σ w_slot[k] · x[dst(k)]`` over the real slots ``k`` whose
    sender is ``u``, in the sender CSR's order, for ``u < n_rows`` (the
    SpMM input's row count): the SpMM's ``dx`` from its output cotangent
    ``x``. ``w_slot`` [B·Et] per-slot weights, or None for the unweighted
    sum. Rows without slots are 0. The kernel sums ``x`` in column panels
    whose rows fit the card's L2 (:func:`gather_panel`), one after another,
    to the same bits at any panel width. The launch counts under ``x``'s
    width."""
    inputs = (lay, x, n_rows, w_slot, transpose)
    _forward_only(x=x, **({} if w_slot is None else dict(w_slot=w_slot)))
    if x.device.type != "cuda":
        return gather_reduce_plain(*inputs)
    return _gather_reduce_launch(*inputs)


def _gather_reduce_launch(
    lay: PaddedLayout, x: torch.Tensor, n_rows: int,
    w_slot: Optional[torch.Tensor], transpose: bool,
    panel: Optional[int] = None,
) -> torch.Tensor:
    """:func:`gather_reduce`'s kernel launch on CUDA tensors. ``panel`` (1
    to :data:`MAX_PANEL` columns) defaults to :func:`gather_panel` of
    ``x`` and the card's L2; the card tests and the panel tool force it,
    and every width gives the same bits."""
    inputs = (lay, x, n_rows, w_slot, transpose)
    if transpose:
        ranges, idx, wmap, heavy = (lay.src_ranges, lay.src_dst,
                                    lay.src_slots, lay.src_heavy)
        need_x, need_out = lay.num_nodes_padded, lay.sender_bound
    else:
        ranges, idx, wmap, heavy = (lay.dst_ranges, lay.slot_src, None,
                                    lay.dst_heavy)
        need_x, need_out = lay.sender_bound, 1
    floats = dict(x=x) if w_slot is None else dict(x=x, w_slot=w_slot)
    _check_tensors(x.device, floats,
                   dict(ranges=ranges, idx=idx, heavy=heavy,
                        **({} if wmap is None else dict(wmap=wmap))))
    for name, t in (("ranges", ranges), ("idx", idx), ("heavy", heavy),
                    ("wmap", wmap)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"layout {name} must be int32")
    if x.dim() != 2 or x.shape[1] < 1 or x.shape[0] < need_x:
        raise ValueError(f"x must be [N, D] with N >= {need_x} and D >= 1, "
                         f"got {list(x.shape)}")
    if n_rows < max(need_out, 1):
        raise ValueError(f"n_rows is {n_rows}; the layout needs at least "
                         f"{max(need_out, 1)}")
    if w_slot is not None and list(w_slot.shape) != [lay.slot_src.shape[0]]:
        raise ValueError(f"w_slot must be [{lay.slot_src.shape[0]}], got "
                         f"{list(w_slot.shape)}")
    d = x.shape[1]
    if panel is None:
        panel = gather_panel(x.shape[0], d, _l2_size(x.device))
    if not 1 <= panel <= MAX_PANEL:
        raise ValueError(f"panel {panel}: the kernel takes 1 to {MAX_PANEL} "
                         "columns")
    if w_slot is None:
        wmap = None
    elif wmap is not None and gather_panel_count(d, panel) > 1:
        # every panel reads each entry's weight again: gather the weights
        # into the sender CSR's order once, not through src_slots per panel
        w_slot, wmap = w_slot[wmap.long()], None
    out = torch.empty(n_rows, d, device=x.device)
    args = [ranges.data_ptr(), idx.data_ptr(),
            None if wmap is None else wmap.data_ptr(),
            None if w_slot is None else w_slot.data_ptr(), x.data_ptr(),
            heavy.data_ptr(), heavy.shape[0], d, ranges.shape[0], n_rows,
            panel, out.data_ptr()]
    _launch(gather_reduce, d, x.dtype, args, inputs, x.device)
    return out


KERNEL_WRAPPERS = (attention_sel_fwd, attention_fwd, attention_sel_bwd,
                   attention_bwd, slot_reduce, gather_reduce)


def launch_counts() -> Dict[str, Dict]:
    """Every wrapper's launches by :func:`launch_key`, as a snapshot: the
    difference
    of two snapshots around a CUDA graph capture is what each replay of
    the graph launches (a replay runs no wrapper, so counts nothing)."""
    return {fn.__name__: dict(fn.launches_by_d) for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counts (kernel launches only; plain
    runs never count)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_d = {}


reset_launch_counts()
