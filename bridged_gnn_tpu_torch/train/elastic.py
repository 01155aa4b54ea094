"""Failure detection and elastic retries.

Port of ``bridged_gnn_tpu/train/elastic.py``. :func:`run_elastic` wraps a
training entry point with bounded retries: a transient failure (memory
exhaustion, a lost peer or connection, a collective's timeout) runs the
call again, which resumes from the last periodic checkpoint where the
call reads one (``Stage2Config.ckpt_dir`` with ``resume``). A heartbeat
file records liveness for an external watchdog.

:data:`TRANSIENT_ERRORS` keeps the JAX package's tokens, so that the same
messages get the same answer, and adds the PyTorch names of the same
failure classes: ``torch.OutOfMemoryError``'s "CUDA out of memory" as
resource exhaustion, NCCL's and gloo's timeouts and closed connections as
unavailability. Before a retry the failed attempt's frames are cleared
and, where CUDA is initialised, the caching allocator's free blocks go
back to the card (``torch.cuda.empty_cache``).

A sticky CUDA error (:data:`STICKY_CUDA_ERRORS`: an illegal memory
access, a device-side assert, an unspecified launch failure) is never
transient here, whatever else its message says: it leaves the calling
process's CUDA context unusable, so no retry in that process can
succeed. Only a new process recovers from it.
"""

from __future__ import annotations

import gc
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional

TRANSIENT_ERRORS = (
    # the JAX package's (XLA's status names and its messages)
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "INTERNAL",
    "connection",
    "Unable to initialize backend",
    # PyTorch's for the same classes
    "CUDA out of memory",
    "OutOfMemoryError",
    "NCCL timeout",
    "Watchdog caught collective operation timeout",
    "Timed out",
    "DistNetworkError",
)

# errors after which the process's CUDA context is lost (cudaError_t
# 700, 710 and 719 and their PyTorch messages)
STICKY_CUDA_ERRORS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
)


def is_transient(exc: BaseException) -> bool:
    """Whether a retry in this process may succeed: the message (with
    the exception's type name) holds a :data:`TRANSIENT_ERRORS` token and
    no :data:`STICKY_CUDA_ERRORS` one, case aside."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(tok.lower() in msg for tok in STICKY_CUDA_ERRORS):
        return False
    return any(tok.lower() in msg for tok in TRANSIENT_ERRORS)


class Heartbeat:
    """A JSON file holding the time of the last beat, the process id and
    what the caller adds; replaced atomically at every beat."""

    def __init__(self, path: str):
        self.path = path

    def beat(self, **info) -> None:
        payload = dict(ts=time.time(), pid=os.getpid(), **info)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def age(self) -> Optional[float]:
        """Seconds since the last beat; None without a readable file."""
        try:
            with open(self.path) as f:
                return time.time() - json.load(f)["ts"]
        except (OSError, ValueError, KeyError):
            return None


def _release_cuda_cache() -> None:
    import torch

    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def run_elastic(
    fn: Callable[..., Dict[str, Any]],
    *args,
    max_retries: int = 3,
    retry_delay_s: float = 10.0,
    heartbeat_path: Optional[str] = None,
    retry_all: bool = False,
    **kwargs,
) -> Dict[str, Any]:
    """``fn(*args, **kwargs)``, run again up to ``max_retries`` times
    after a transient failure (:func:`is_transient`; any failure with
    ``retry_all``), ``retry_delay_s`` apart; the last failure, or a
    permanent one, is raised.

    For a resumable function (``train_ktgnn`` with ``cfg.ckpt_dir``) pass
    ``cfg.resume=True`` yourself: this wrapper drives the retry loop and
    the heartbeat alone. ``KeyboardInterrupt`` is never retried.

    The retry is this process's alone. Where ``fn`` takes collectives
    over a process group, every rank must fail together, before the
    next collective, for the group to start again in step; a rank that
    fails alone leaves its peers waiting in a collective."""
    hb = Heartbeat(heartbeat_path) if heartbeat_path else None
    for attempt in range(max_retries + 1):
        if hb:
            hb.beat(attempt=attempt, status="running")
        try:
            out = fn(*args, **kwargs)
            if hb:
                hb.beat(attempt=attempt, status="done")
            return out
        except KeyboardInterrupt:
            raise
        except BaseException as exc:  # noqa: BLE001 - classified below
            if hb:
                hb.beat(attempt=attempt, status="failed",
                        error=f"{type(exc).__name__}: {exc}")
            if attempt == max_retries or not (retry_all or is_transient(exc)):
                raise
            traceback.print_exc()
            # the failed attempt's frames hold its tensors
            traceback.clear_frames(exc.__traceback__)
        gc.collect()
        _release_cuda_cache()
        print(f"[elastic] attempt {attempt + 1} failed; retrying in "
              f"{retry_delay_s}s")
        time.sleep(retry_delay_s)
    raise AssertionError("unreachable")  # pragma: no cover
