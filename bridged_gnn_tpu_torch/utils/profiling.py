"""Tracing and epoch timing (the port's counterpart of
``bridged_gnn_tpu/utils/profiling.py``: ``trace``, ``annotate`` and
``StepTimer``).

Card work runs asynchronously, so the timer synchronizes the device
before it reads the clock at both ends of a step: a step's time is the
host clock around work that has finished on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cpu") -> Iterator[None]:
    """Run the block under ``torch.profiler`` (CPU activities, and CUDA
    activities when ``device`` is a card) and write its Chrome trace to
    ``<log_dir>/trace.json``, which Perfetto and chrome://tracing read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range around the block in a ``torch.profiler`` trace
    (``record_function``; JAX ``TraceAnnotation``): a row of its own in
    ``key_averages()`` and a span in the Chrome trace. Outside a profiler
    it costs one small host object."""
    with torch.profiler.record_function(name):
        yield


COLLECTIVE = "collective:"


def collective_span(kind: str):
    """:func:`annotate` around one collective call, named
    ``collective:<kind>``. The runtime calls that launch the collective's
    device work fall inside the range, so a trace can name that work (by
    its correlation ids) apart from the rest of the step. Inside a CUDA
    graph capture the range is the capture's; replays carry no ranges."""
    return annotate(COLLECTIVE + kind)


class EpochTimer:
    """Wall-clock step times on ``device`` and their summary; the first
    ``warmup`` steps are left out of the steady-state statistics.

    ``with timer:`` times one epoch; ``with timer.chunk(k):`` times k
    epochs run as one unit and records a k-th of it for each."""

    def __init__(self, device: torch.device, num_edges: int = 0,
                 warmup: int = 2):
        self.device = torch.device(device)
        self.num_edges = num_edges
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._epochs = 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def chunk(self, epochs: int) -> "EpochTimer":
        self._epochs = epochs
        return self

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self.times.extend([dt / self._epochs] * self._epochs)
        self._epochs = 1

    @property
    def steady(self) -> np.ndarray:
        return np.asarray(self.times[self.warmup:] or self.times)

    def summary(self) -> Dict[str, float]:
        s = self.steady
        mean = float(s.mean()) if len(s) else float("nan")
        out = dict(
            mean_s=mean,
            p50_s=float(np.percentile(s, 50)) if len(s) else float("nan"),
            p95_s=float(np.percentile(s, 95)) if len(s) else float("nan"),
            steps=len(self.times),
            steady_steps=len(s),
        )
        if self.num_edges and mean > 0:
            out["edges_per_sec"] = self.num_edges / mean
        return out
