"""ctypes bindings to the port's native graph-core library.

Port of ``bridged_gnn_tpu/io/native.py``. The library is the port's own
copy of the source, ``csrc/graphcore.cpp``, compiled at first use with
``g++ -O3 -march=native -fPIC -std=c++17 -shared`` into
``bridged_gnn_tpu_torch/_build/`` (a file named by a hash of the source,
the compiler and its flags, so a changed source builds anew). ``$CXX``
names another compiler.

Unlike the JAX package's loader, which gives up without a word when
``make`` fails and leaves numpy to run, every entry point here raises
``RuntimeError`` when the library cannot be built or loaded: a caller that
asked for the native path (``graph.py`` does above
``NATIVE_EDGE_THRESHOLD`` edges, and the slot layouts' sender index above
as many real slots) never gets another one in its place.
The numpy versions stay in ``graph.py``, ``ops/chunk_meta.py`` and
``ops/blocked_segment.py``, and the tests hold each entry point to them.
:func:`call_counts` counts each entry point's calls, as the kernel
wrappers count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "graphcore.cpp"
BUILD_DIR = _PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_c64 = ctypes.c_int64
# entry point: (restype, argtypes), as the JAX package declares them
# (bridged_gnn_tpu/io/native.py:45-68), but for gc_sort_by_dst, which
# returns -1 as gc_coalesce does when the ids do not pack into one key
_SIGNATURES = dict(
    gc_coalesce=(_c64, [_I64, _I64, _c64, _I64, _I64]),
    gc_sort_by_dst=(_c64, [_I64, _I64, _c64, _I64, _I64]),
    gc_csr_rowptr=(None, [_I64, _c64, _c64, _I64]),
    gc_chunk_meta=(_c64, [_I64, _c64, _c64, _c64, _c64, _I32, _I32]),
    gc_degrees=(None, [_I64, _I64, _c64, _c64, _I64, _I64]),
    gc_edge_partition=(None, [_c64, _c64, _c64, _I64]),
    gc_sender_csr=(_c64, [_I32, _c64, _c64, _I32, _I32]),
)

_lock = threading.Lock()
_libs: dict = {}
_calls = dict.fromkeys(_SIGNATURES, 0)


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found ($CXX, default g++); the native "
            f"graph-core library ({SOURCE.name}) cannot be built")
    return path


def build_native(build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/graphcore.cpp`` into ``build_dir`` (default
    ``_build/``) unless a library of the same source, compiler and flags
    is there; return its path. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    cxx = _compiler()
    build_dir = Path(build_dir or BUILD_DIR)
    h = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = build_dir / f"libgraphcore-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """The library, built on first use (:func:`build_native`) and loaded
    once per build directory, its entry points declared. Raises
    ``RuntimeError`` when it cannot be built or loaded."""
    key = str(Path(build_dir or BUILD_DIR).resolve())
    with _lock:
        if key not in _libs:
            path = build_native(build_dir)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[key] = lib
        return _libs[key]


def _call(name: str, *args):
    """Entry point ``name`` of the default build, called and counted."""
    fn = getattr(load(), name)
    _calls[name] += 1
    return fn(*args)


def call_counts() -> Dict[str, int]:
    """Each entry point's calls since import, as a snapshot: the
    difference of two snapshots is what ran between them."""
    return dict(_calls)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_packed(ret: int) -> None:
    if ret < 0:
        raise ValueError("node ids must be non-negative, and the bits of "
                         "the largest src and dst id fit in 64 together")


def coalesce(edge_index: np.ndarray) -> np.ndarray:
    """Edges sorted by (dst, src) with duplicates dropped, [2, E'] int64
    (``graph.coalesce_np``'s result)."""
    src, dst = _i64(edge_index[0]), _i64(edge_index[1])
    e = src.shape[0]
    out_src = np.empty(e, dtype=np.int64)
    out_dst = np.empty(e, dtype=np.int64)
    n = _call("gc_coalesce", src, dst, e, out_src, out_dst)
    _check_packed(n)
    return np.stack([out_src[:n], out_dst[:n]])


def sort_by_dst(edge_index: np.ndarray) -> np.ndarray:
    """Edges in a stable sort by (dst, src), duplicates kept, [2, E]
    int64 (``graph.sort_edges_by_dst``'s result)."""
    src, dst = _i64(edge_index[0]), _i64(edge_index[1])
    e = src.shape[0]
    out_src = np.empty(e, dtype=np.int64)
    out_dst = np.empty(e, dtype=np.int64)
    _check_packed(_call("gc_sort_by_dst", src, dst, e, out_src, out_dst))
    return np.stack([out_src, out_dst])


def csr_rowptr(dst_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    """CSR row pointers [num_nodes + 1] of dst-sorted edges."""
    dst = _i64(dst_sorted)
    if len(dst) and not 0 <= dst.min() <= dst.max() < num_nodes:
        raise ValueError(f"destinations must lie in [0, {num_nodes})")
    out = np.empty(num_nodes + 1, dtype=np.int64)
    _call("gc_csr_rowptr", dst, len(dst), num_nodes, out)
    return out


def degrees(edge_index: np.ndarray,
            num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(in_degree, out_degree) [num_nodes] int64 of each node."""
    src, dst = _i64(edge_index[0]), _i64(edge_index[1])
    for ids in (src, dst):
        if len(ids) and not 0 <= ids.min() <= ids.max() < num_nodes:
            raise ValueError(f"node ids must lie in [0, {num_nodes})")
    in_deg = np.empty(num_nodes, dtype=np.int64)
    out_deg = np.empty(num_nodes, dtype=np.int64)
    _call("gc_degrees", src, dst, src.shape[0], num_nodes, in_deg, out_deg)
    return in_deg, out_deg


def edge_partition(num_edges: int, num_shards: int,
                   align: int = 128) -> np.ndarray:
    """Contiguous near-equal edge shard offsets [num_shards + 1], each
    but the last rounded down to ``align``."""
    if num_shards < 1 or align < 1:
        raise ValueError("num_shards and align must be at least 1")
    out = np.empty(num_shards + 1, dtype=np.int64)
    _call("gc_edge_partition", num_edges, num_shards, align, out)
    return out


def chunk_meta(dst_sorted: np.ndarray, num_nodes_padded: int,
               node_block: int, edge_chunk: int
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per node block the first edge chunk and the count of chunks that
    cover its edges, and the largest count (``ops/chunk_meta.py``)."""
    dst = _i64(dst_sorted)
    n_blocks = -(-num_nodes_padded // node_block)
    chunk_base = np.empty(n_blocks, dtype=np.int32)
    num_chunks = np.empty(n_blocks, dtype=np.int32)
    mx = _call("gc_chunk_meta", dst, len(dst), num_nodes_padded,
               node_block, edge_chunk, chunk_base, num_chunks)
    return chunk_base, num_chunks, int(mx)


def sender_csr(slot_src: np.ndarray,
               num_senders: int) -> Tuple[np.ndarray, np.ndarray]:
    """A slot layout's sender-keyed CSR by a stable counting sort:
    ``src_ranges`` [num_senders, 2] and ``src_slots``, the real slots
    (``slot_src >= 0``) ascending within each sender, both int32
    (``ops/blocked_segment.py::_sender_csr_np``'s arrays). Raises
    ``RuntimeError`` when a sender id is at or above ``num_senders``."""
    src = np.ascontiguousarray(slot_src, dtype=np.int32)
    src_ranges = np.empty((num_senders, 2), dtype=np.int32)
    src_slots = np.empty(np.count_nonzero(src >= 0), dtype=np.int32)
    if _call("gc_sender_csr", src, len(src), num_senders, src_ranges,
             src_slots) < 0:
        raise RuntimeError(f"sender ids must lie in [0, {num_senders})")
    return src_ranges, src_slots
