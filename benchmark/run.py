"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the chips the cell asks
for. The run makes its inputs from ``--seed``, sets up (the port's
kernel library, the data, a warm-up of the window's own calls),
measures for ``--seconds``, compares what the timed path
produced with the plain reference under ``benchmark/reference/``, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its
limit. Those numbers are also the last lines on standard error.

It exits non-zero and prints no result when there is no card, fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from lib import guard, traffic  # noqa: E402
from lib.kernels import hand_written, pattern  # noqa: E402
from lib.spec import (  # noqa: E402
    Cell,
    load_cell,
    load_json,
    load_metric,
    load_module,
)
from lib.stats import percentile  # noqa: E402

PACKAGE = ROOT / "bridged_gnn_tpu_torch"


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _memory(device: str, reset: bool = False) -> int:
    import torch

    if not device.startswith("cuda"):
        return 0
    if reset:
        torch.cuda.reset_peak_memory_stats()
        return 0
    return int(torch.cuda.max_memory_allocated())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0) -> dict:
    """Set up, measure and compare one cell; the result's fields."""
    from lib.trace import Tracer

    family = cell.config["family"]
    system = load_module("systems", family)
    checks = load_module("checks", family)
    kind = cell.traffic["kind"]

    t_start = time.perf_counter()
    data = traffic.make_graph(cell.config, cell.traffic, seed)
    t_data = time.perf_counter()
    state = system.setup(kind, data, cell.config, cell.traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    # where set-up went: up to the cell's start (imports, CUDA), the
    # inputs, the system's set-up
    parts = dict(start_s=t_start - t0, inputs_s=t_data - t_start,
                 system_s=setup_s - (t_data - t0))

    tracer = Tracer() if trace else None
    _memory(device, reset=True)
    if kind == "train_runs":
        window = traffic.train_runs(lambda i: system.call(state, i), seconds,
                                    tracer)
        attempted = len(window["records"])
    elif kind == "closed_loop":
        window = traffic.closed_loop(
            lambda req: system.request(state, req), state["pool"], seconds,
            cell.traffic["sample_requests"], seed, lambda: _sync(device),
            tracer, cell.traffic["trace_calls"])
        attempted = len(window["latencies"])
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    peak = _memory(device)

    system.release(state)
    gc.collect()
    summary = tracer.summary() if tracer is not None else None
    t_check = time.perf_counter()
    numbers, info, sizes = checks.check(kind, data, cell.config, cell.traffic,
                                        seed, state, window, device)
    info["check_s"] = time.perf_counter() - t_check
    if kind == "closed_loop":
        # the serving tail, printed and not bounded (PERF.md section 2)
        info["predict_p95_ms"] = 1e3 * percentile(window["latencies"], 95)
    ctx = SimpleNamespace(
        kind=kind, config=cell.config, traffic=cell.traffic,
        setup_s=setup_s, window=window, peak_bytes=peak, trace=summary,
        graph=sizes, peaks=load_json(BENCH / "peaks.json"),
        costs=load_module("costs", family),
        hand_kernels=pattern(hand_written(PACKAGE)))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    # the numbers with a limit in the cell's file decide; the others are
    # printed beside them (PERF.md says why each has no limit)
    checked = {k: dict(value=numbers.get(k, math.nan), limit=limit)
               for k, limit in cell.limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checked.values())
    out = dict(correct=correct, attempted=attempted, failed=0,
               metrics=metrics, device=dict(memory_peak_bytes=peak),
               info=dict(info, setup=parts, not_compared={
                   k: v for k, v in numbers.items() if k not in checked},
                   calls=[{k: r[k] for k in ("wall_s", "total_time",
                                             "mean_epoch_time")}
                          for r in window.get("records", [])]))
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s,
                             window_s=summary.window_s)
        out["breakdown"] = dict(device_ops=summary.top_ops(10),
                                idle_gaps=summary.gaps[:10])
    out["checks"] = checked
    return out


def _card(chips: int) -> dict:
    import subprocess

    import torch

    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.split("\n")[0]
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, power_limit=power.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = guard.forbidden()
    if loaded:
        print(f"the run loaded forbidden modules: {loaded}", file=sys.stderr)
        return 4
    result["device"] = dict(_card(cell.chips), **result["device"])
    print(f"info: {json.dumps(result.pop('info'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
