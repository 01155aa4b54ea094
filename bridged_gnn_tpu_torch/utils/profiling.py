"""Tracing and epoch timing (the port's counterpart of
``bridged_gnn_tpu/utils/profiling.py``: ``trace``, ``annotate`` and
``StepTimer``).

While a profiler runs, ``annotate``'s ranges also go to an in-memory log
(``recorded``): the trainer's and the predictor's named host layers, on
the host clock, each under its run or request.

Card work runs asynchronously, so the timer synchronizes the device
before it reads the clock at both ends of a step: a step's time is the
host clock around work that has finished on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


@dataclasses.dataclass
class Span:
    """One :func:`annotate` range: its name, its host clock
    (``time.perf_counter_ns``) at entry and exit, the index in the log of
    the range it opened inside (None at a root) and of its root, and the
    counts passed in."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    root: int
    counts: Dict[str, int]


_LOG: List[Span] = []
_OPEN: List[int] = []   # indices of the ranges open now, innermost last


class _Off:
    """What :func:`annotate` gives with no profiler running: no range,
    and counts set on it go nowhere."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def counts(self) -> Dict[str, int]:
        return {}


_OFF = _Off()


class _Range:
    __slots__ = ("name", "counts", "_rf")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        index = len(_LOG)
        parent = _OPEN[-1] if _OPEN else None
        root = index if parent is None else _LOG[parent].root
        _LOG.append(Span(self.name, time.perf_counter_ns(), 0, parent, root,
                         self.counts))
        _OPEN.append(index)
        return self

    def __exit__(self, *exc):
        _LOG[_OPEN.pop()].end_ns = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        return False


def annotate(name: str, **counts: int):
    """A named range around the block while a ``torch.profiler`` runs on
    this thread (``record_function``; JAX ``TraceAnnotation``), and with
    no profiler nothing at all: no range, no clock read.

    The range is a row of its own in ``key_averages()`` and a span in the
    Chrome trace, on the profiler's clock beside the device's work, so an
    idle stretch of the card lies inside the host work that held it up.
    Each range is also kept in :func:`recorded`'s log, under the range it
    opened inside, with the integer ``counts`` given (a copy's ``bytes``)
    and any set on the range's ``counts`` before it closes (``with
    annotate(name) as span: ...; span.counts.update(pairs=n)``).
    Ranges opened inside a CUDA graph's capture are the capture's; its
    replays carry none."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Range(name, counts)


def recorded() -> List[Span]:
    """The ranges :func:`annotate` has kept since the last
    :func:`clear_recorded`, in the order they opened; a root's index is
    shared by every range inside it (one training run, one request)."""
    return list(_LOG)


def clear_recorded() -> None:
    """Empty the log (with no range open)."""
    _LOG.clear()


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

    def __init__(self, device: torch.device, warmup: int = 2):
        self.device = torch.device(device)
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
        return dict(
            mean_s=float(s.mean()) if len(s) else float("nan"),
            p50_s=float(np.percentile(s, 50)) if len(s) else float("nan"),
            steps=len(self.times),
            steady_steps=len(s),
        )
