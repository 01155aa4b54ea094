"""Fused attention forward kernels: CUDA wrappers and their plain versions.

Port of the forward kernels of ``bridged_gnn_tpu/ops/pallas_fused.py``:

* :func:`attention_sel_fwd` — the selective (branch-selected) forward,
  ``_attention_sel_kernel`` (pallas_fused.py:501), the serving default on a
  single padded layout;
* :func:`attention_fwd` — the concatenated forward, ``_attention_kernel``
  (pallas_fused.py:168), run once per tier on degree-tiered layouts.

Both kernels live in ``csrc/attention_fwd.cu``. Each also covers the
sender-row gather that its JAX wrapper ran before the Pallas call: the
kernel reads sender rows by index from the ``u1``/``u2`` tables. The
softmax is shifted by each destination's own maximum (the TPU kernels
shift by a block-wide maximum), so raw ``ex`` differs from the TPU's by a
per-block factor while ``α = ex / den`` and the outputs agree.

A wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; nothing else picks between the two. The plain versions
take the same arguments and compute the same function in straightforward
torch ops.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``bridged_gnn_tpu_torch/_build/`` and loaded with ``ctypes``. Each wrapper
counts its launches (``launches``, and per width in ``launches_by_d``);
:func:`record_launches` also times them with CUDA events.
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
from typing import Optional, Tuple

import torch

from bridged_gnn_tpu_torch.ops.blocked_segment import PaddedLayout, slot_rows

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "attention_fwd.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
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


def build_kernels() -> Tuple[Path, float]:
    """Compile ``csrc/attention_fwd.cu`` unless its library is up to date.

    Returns the library's path and the seconds the build took (0 when the
    library was already built). Raises with the compiler's output if
    ``nvcc`` fails."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{SOURCE.stem}-{digest}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # src, ranges, u1, u2, ud, central, a1, a2, slope, d, n_rows_layout,
    # n_out, node_block, tile_e, out, ex|alpha, [den], stream
    head = [p] * 8 + [f] + [i] * 5
    lib.attention_sel_fwd.argtypes = head + [p, p, p, p]
    lib.attention_sel_fwd.restype = i
    lib.attention_fwd.argtypes = head + [p, p, p]
    lib.attention_fwd.restype = i
    return lib


def _attention_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build_kernels()[0])))
        return _lib


# ------------------------------------------------------------ validation


def _check_inputs(lay: PaddedLayout, u1, u2, ud, central, a1, a2) -> None:
    dev = u1.device
    floats = dict(u1=u1, u2=u2, ud=ud, a1=a1, a2=a2)
    for name, t in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    tensors = dict(floats, central=central, slot_src=lay.slot_src,
                   dst_ranges=lay.dst_ranges)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, u1 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if central.dtype != torch.bool:
        raise TypeError(f"central must be bool, got {central.dtype}")
    for name in ("slot_src", "dst_ranges"):
        if tensors[name].dtype != torch.int32:
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


def _forward_only(**floats) -> None:
    """Raise where autograd would record through a kernel input."""
    if not torch.is_grad_enabled():
        return
    for name, t in floats.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad; the attention forward kernels have "
                "no backward yet")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# While ``record_launches`` runs: (list of launch records, keep_inputs).
_recording: Optional[tuple] = None


@contextlib.contextmanager
def record_launches(keep_inputs: bool = False):
    """Record every kernel launch made inside the block.

    Yields a list that gets one dict per launch: the kernel's ``name``,
    its width ``d``, the CUDA events ``start`` and ``stop`` recorded on
    the launch's stream around it and, with ``keep_inputs``, the launch's
    arguments ``inputs`` (layout, u1, u2, ud, central, a1, a2,
    negative_slope). Costs two event records per launch while on and
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


def _launch(wrapper, inputs, outs) -> None:
    """Validate ``inputs``, launch ``wrapper``'s kernel on the current
    stream of their device and count the launch."""
    lay, u1, u2, ud, central, a1, a2, negative_slope = inputs
    _check_inputs(lay, u1, u2, ud, central, a1, a2)
    entry = getattr(_attention_lib(), wrapper.__name__)
    d = u1.shape[1]
    args = [
        lay.slot_src.data_ptr(), lay.dst_ranges.data_ptr(),
        u1.data_ptr(), u2.data_ptr(), ud.data_ptr(), central.data_ptr(),
        a1.data_ptr(), a2.data_ptr(), float(negative_slope), d,
        lay.num_blocks * lay.node_block, central.shape[0], lay.node_block,
        lay.tile_e,
    ] + [o.data_ptr() for o in outs]
    recording = _recording
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream()
        if recording is not None:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        wrapper.launches += 1
        wrapper.launches_by_d[d] = wrapper.launches_by_d.get(d, 0) + 1
        rc = entry(*args, stream.cuda_stream)
        if recording is not None:
            stop.record(stream)
            records, keep_inputs = recording
            records.append(dict(name=wrapper.__name__, d=d, start=start,
                                stop=stop,
                                inputs=inputs if keep_inputs else None))
    _raise_on(rc, wrapper.__name__)


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
    mx = torch.full((n_out,), float("-inf"), device=u1.device).scatter_reduce(
        0, row, logit, reduce="amax")
    ex = torch.where(valid, torch.exp(logit - mx[row]), 0.0)
    den = torch.zeros(n_out, device=u1.device).index_add(0, row, ex)
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
    acc = torch.zeros(n_out, d, device=u1.device).index_add(
        0, row, ex[:, None] * m)
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
    out = torch.zeros(n_out, 2 * d, device=u1.device).index_add(
        0, row, alpha[:, None] * torch.cat([m1, m2], dim=1))
    return out, alpha


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
    n_out, d = central.shape[0], u1.shape[1]
    out = torch.empty(n_out, d, device=u1.device)
    ex = torch.empty(lay.slot_src.shape[0], device=u1.device)
    den = torch.empty(n_out, device=u1.device)
    _launch(attention_sel_fwd, inputs, (out, ex, den))
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
    n_out, d = central.shape[0], u1.shape[1]
    out = torch.empty(n_out, 2 * d, device=u1.device)
    alpha = torch.empty(lay.slot_src.shape[0], device=u1.device)
    _launch(attention_fwd, inputs, (out, alpha))
    return out, alpha


KERNEL_WRAPPERS = (attention_sel_fwd, attention_fwd)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch counts (kernel launches only; plain
    runs never count)."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_d = {}


reset_launch_counts()
