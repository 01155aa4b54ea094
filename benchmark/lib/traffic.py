"""The one general generator of the benchmark's traffic, driven by the
parameters in ``benchmark/traffic/<mix>.json``.

Two kinds of mix:

* ``train_runs``: whole training runs of the configuration's recipe on
  one graph, started back to back while the window is open. Run ``i``
  takes the seed ``seed + i``, so no two runs of a window are the same
  run, and the first is the run the comparison follows.
* ``closed_loop``: one client that sends its next request when the last
  one has returned. Requests cycle through a pool drawn from the seed:
  ``nodes_per_request`` distinct node ids and a fresh feature row for
  each. A seeded reservoir keeps ``sample_requests`` of the answers for
  the comparison.

The graph comes from the configuration's ``graph`` sizes and the mix's
``skew`` (``benchmark/data/graphs.py``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import numpy as np

from lib.trace import SPAN_PREFIX


def make_graph(config: dict, traffic: dict, seed: int):
    from data.graphs import make_graph as build

    sizes = ("num_nodes", "avg_degree", "num_features", "num_classes")
    return build(dict({k: config[k] for k in sizes},
                      skew=traffic.get("skew")), seed)


def request_pool(traffic: dict, num_nodes: int, dim: int,
                 seed: int) -> List[dict]:
    """``pool`` requests of ``nodes_per_request`` distinct node ids and
    their new feature rows (standard normal, as the graph's features)."""
    rng = np.random.default_rng([seed, 1])
    k = traffic["nodes_per_request"]
    return [dict(nodes=rng.choice(num_nodes, size=k, replace=False),
                 rows=rng.normal(size=(k, dim)).astype(np.float32))
            for _ in range(traffic["pool"])]


def _span(name: str):
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def train_runs(call: Callable[[int], dict], seconds: float,
               tracer=None) -> dict:
    """Runs ``call(i)`` back to back while fewer than ``seconds`` have
    passed since the first started. The first run is the one the
    comparison follows; with ``tracer`` the second runs inside it, so the
    trace holds none of the first run's recording, and the window holds
    two runs at least. Returns the records and the window: from the
    first start to the last return."""
    records = []
    least = 1 if tracer is None else 2
    t0 = time.perf_counter()
    while len(records) < least or time.perf_counter() - t0 < seconds:
        i = len(records)
        traced = tracer is not None and i == 1
        ctx = tracer if traced else contextlib.nullcontext()
        with ctx, _span("train_run"):
            rec = call(i)
        rec["traced"] = traced
        records.append(rec)
    return dict(records=records, window_s=time.perf_counter() - t0)


def closed_loop(request: Callable[[dict], dict], pool: List[dict],
                seconds: float, sample: int, seed: int, sync: Callable,
                tracer=None, trace_calls: int = 0) -> dict:
    """One client's requests while the window is open, each timed by the
    host clock from its send to its answer on the host. The first
    ``trace_calls`` run inside ``tracer``. Keeps a uniform sample of
    ``sample`` answers, drawn from ``seed``."""
    rng = np.random.default_rng([seed, 2])
    latencies: List[float] = []
    kept: Dict[int, dict] = {}
    traced_n = trace_calls if tracer is not None else 0
    stack = contextlib.ExitStack()
    if traced_n:
        stack.enter_context(tracer)
    t0 = time.perf_counter()
    try:
        i = 0
        while i == 0 or time.perf_counter() - t0 < seconds:
            if traced_n and i == traced_n:
                stack.close()
            req = pool[i % len(pool)]
            t1 = time.perf_counter()
            with _span("predict"):
                out = request(req)
            latencies.append(time.perf_counter() - t1)
            if len(kept) < sample:
                kept[i] = out
            else:
                j = int(rng.integers(0, i + 1))
                if j < sample:
                    del kept[sorted(kept)[j]]
                    kept[i] = out
            i += 1
    finally:
        stack.close()
    sync()
    return dict(latencies=latencies, kept=kept,
                window_s=time.perf_counter() - t0,
                traced=min(traced_n, len(latencies)))
