"""The device trace of a traced run, and its reduction to what the
per-layer readers read.

``Tracer`` runs ``torch.profiler`` (host and CUDA activities, CUPTI) over
the calls it is entered around; ``reduce_events`` turns the raw events
into a :class:`TraceSummary`: the time and count of every device
operation by name, the union of their intervals (the busy time), and the
idle gaps between them, each labelled by what the host was doing then.
Only the raw kinetic events are read, so no per-operation Python objects
are built for the hundreds of thousands of kernels a training run
launches.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from typing import Dict, List, Sequence, Tuple

SPAN_PREFIX = "bench:"


@dataclasses.dataclass
class Event:
    name: str
    start: float   # seconds, on the profiler's clock
    end: float
    device: bool
    annotation: bool


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops: Dict[str, List[float]]          # name -> [seconds, count]
    gaps: List[Tuple[str, float]]        # longest idle gaps, labelled
    device_ops: int

    def time_of(self, pattern: str) -> Tuple[float, int]:
        """Seconds and count of the device operations whose name holds
        ``pattern`` (a regular expression)."""
        rx = re.compile(pattern)
        s = n = 0
        for name, (t, c) in self.ops.items():
            if rx.search(name):
                s += t
                n += c
        return s, int(n)

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        ranked = sorted(self.ops.items(), key=lambda kv: -kv[1][0])
        return [(name, t) for name, (t, _) in ranked[:k]]


def _ns(ev, what: str) -> int:
    """An event's start or end in ns, across profiler versions."""
    if hasattr(ev, f"{what}_ns"):
        return getattr(ev, f"{what}_ns")()
    if what == "start":
        return ev.start_us() * 1000
    return (ev.start_us() + ev.duration_us()) * 1000


def _events(result) -> List[Event]:
    from torch.autograd import DeviceType

    out = []
    for ev in result.events():
        start, end = _ns(ev, "start"), _ns(ev, "end")
        dev = ev.device_type() == DeviceType.CUDA
        ann = (ev.is_user_annotation() if hasattr(ev, "is_user_annotation")
               else ev.name().startswith(SPAN_PREFIX))
        if dev and (ann or ev.name().startswith(SPAN_PREFIX)):
            continue  # a host span's mirror on the device's timeline
        out.append(Event(ev.name(), start * 1e-9, end * 1e-9, dev, ann))
    return out


class Tracer:
    """``torch.profiler`` over the calls made inside ``with tracer:``
    (entered at most once). The window is the host clock from entry to
    exit, after the card has drained."""

    def __init__(self):
        self.result = None
        self.window_s = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self.result = self._prof.profiler.kineto_results
        return False

    def summary(self, top_gaps: int = 10) -> TraceSummary:
        return reduce_events(_events(self.result), self.window_s, top_gaps)


def _union(intervals: Sequence[Tuple[float, float]]):
    """Merged, sorted intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(host: List[Event], starts: List[float], t0: float,
                t1: float) -> str:
    """What the host was doing in the idle gap ``[t0, t1]``: the harness
    span that holds it and the innermost host event running across its
    middle, or else the host events just before and after it."""
    t = (t0 + t1) / 2
    span = inner = last = None
    i = bisect.bisect_right(starts, t)
    for ev in host[:i]:
        if ev.end < t:
            if ev.end <= t0 and (last is None or ev.end >= last.end):
                last = ev
            continue
        if ev.annotation and ev.name.startswith(SPAN_PREFIX):
            if span is None or ev.start >= span.start:
                span = ev
        elif inner is None or ev.start >= inner.start:
            inner = ev
    if inner is not None:
        doing = inner.name
    else:
        after = host[i].name if i < len(host) else "the end"
        doing = (f"host work after {last.name if last else 'the start'} "
                 f"before {after}")
    return " / ".join([span.name if span else "outside the harness's spans",
                       doing])


def reduce_events(events: Sequence[Event], window_s: float,
                  top_gaps: int = 10) -> TraceSummary:
    device = [ev for ev in events if ev.device and ev.end > ev.start]
    host = sorted((ev for ev in events if not ev.device),
                  key=lambda ev: ev.start)
    ops: Dict[str, List[float]] = {}
    for ev in device:
        rec = ops.setdefault(ev.name, [0.0, 0])
        rec[0] += ev.end - ev.start
        rec[1] += 1
    merged = _union([(ev.start, ev.end) for ev in device])
    busy = sum(e - s for s, e in merged)
    # the window's edges: the first and the last host event
    flat = [x for s, e in merged for x in (s, e)]
    edges = ([min([ev.start for ev in host] + flat[:1])] + flat
             + [max([ev.end for ev in host] + flat[-1:])]) if flat else []
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    starts = [ev.start for ev in host]
    labelled: Dict[str, float] = {}
    for length, at in gaps[:4 * top_gaps]:
        if len(labelled) >= top_gaps:
            break
        label = _host_label(host, starts, at, at + length)
        # the same host activity, gap after gap, is one entry: its longest
        labelled.setdefault(label, length)
    return TraceSummary(
        window_s=window_s, busy_s=busy, ops=ops,
        gaps=sorted(labelled.items(), key=lambda kv: -kv[1]),
        device_ops=len(device))
