"""The scan engine of both trainers (``train/stage2.py``,
``train/stage1.py``): epochs in segments, one host round trip a segment,
and on the card one CUDA graph of an epoch, captured once and replayed.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional

import torch

from bridged_gnn_tpu_torch.ops import fused_kernels
from bridged_gnn_tpu_torch.utils.profiling import EpochTimer, annotate

# Eager epochs before the capture, on the capture's side stream: they
# create Adam's state, cuBLAS's workspace for that stream and the
# allocator's blocks. They are real epochs of the run, scored as the
# others.
WARMUP_EPOCHS = 2


def capture_epoch(body, generators, stream: torch.cuda.Stream):
    """``body()``, one epoch, captured in a CUDA graph on ``stream``, the
    ``generators`` it draws from registered with it; and the kernel
    launches each replay makes, by wrapper and width. A failed capture
    raises. The capture is ``"thread_local"``: an unsafe call made by the
    capturing thread still voids it, while one made by another thread
    (NCCL's watchdog polls the events of finished collectives) does
    not."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = fused_kernels.launch_counts()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        body()
    per_replay = {}
    for name, by_d in fused_kernels.launch_counts().items():
        diff = {d: n - before[name].get(d, 0) for d, n in by_d.items()
                if n != before[name].get(d, 0)}
        if diff:
            per_replay[name] = diff
    return graph, per_replay


# One capture stream per device for the whole process. cuBLAS keeps a
# workspace (65 MiB on an H100) for every stream it has run on, and frees
# none, so a new stream per run would leave one behind after each run.
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


def run_scan(segments, body, generators, i: torch.Tensor,
             timer: EpochTimer, fetch, after, load=None,
             capture: Optional[bool] = None,
             spans: Optional[str] = None) -> dict:
    """The segment loop of both trainers' scan modes. For each segment
    ``(first, last)`` of k epochs, timed as one ``timer.chunk(k)``: the
    segment's inputs (``load(k)``), the record row counter ``i`` zeroed,
    ``body()`` k times, and ``fetch(first, last)``, the segment's one
    synchronize and copy to the host; then, outside the timer,
    ``after(first, last, fetched)``.

    With ``capture`` (default: on a card) the first :data:`WARMUP_EPOCHS`
    epochs run eagerly on the capture stream, the next is captured there
    once (``generators`` registered with it), and every later epoch is a
    replay of that graph. Without it (the CPU, or a sharded run over
    gloo) every epoch runs eagerly. A failed capture raises. Returns the
    eager epochs, the captures, the replays and each replay's kernel
    launches.

    ``spans``: a name under which a profiler sees the capture
    (``<spans>.capture``) and each ``after`` (``<spans>.score``) as
    ranges of their own; None for no ranges."""
    dev = i.device
    on_card = dev.type == "cuda" if capture is None else capture
    stream = capture_stream(dev) if on_card else None
    graph, per_replay = None, {}
    eager = replays = 0
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
    with (torch.cuda.stream(stream) if on_card
          else contextlib.nullcontext()):
        for first, last in segments:
            k = last - first + 1
            captured, eager_before = False, eager
            with timer.chunk(k):
                if load is not None:
                    load(k)
                i.zero_()
                for _ in range(k):
                    if not on_card or eager < WARMUP_EPOCHS:
                        with warnings.catch_warnings():
                            # capturable Adam warns when it steps outside
                            # a capture, as the warm-up epochs do
                            warnings.filterwarnings(
                                "ignore", message=".*capturable=True")
                            body()
                        eager += 1
                        continue
                    if graph is None:
                        with _span(spans, "capture"):
                            # nothing in flight when the capture starts
                            torch.cuda.synchronize(dev)
                            graph, per_replay = capture_epoch(
                                body, generators, stream)
                        captured = True
                    graph.replay()
                    replays += 1
                fetched = fetch(first, last)
            if (first == segments[0][0] or captured
                    or (on_card and eager > eager_before)):
                # the first segment, and on the card the warm-up epochs
                # and the capture, stay out of the steady statistics
                timer.warmup = len(timer.times)
            with _span(spans, "score"):
                after(first, last, fetched)
    if stream is not None:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return dict(eager_epochs=eager, captures=int(graph is not None),
                replays=replays, launches_per_replay=per_replay)


def _span(prefix: Optional[str], name: str):
    return (contextlib.nullcontext() if prefix is None
            else annotate(f"{prefix}.{name}"))
