"""The readings the limits of ``correct`` are set from, on the chip at a
cell's own size. Not run by the benchmark's runs.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        --what sound control half_batch

For each seed, in one process: the program's set-up and, for training,
the window's first run under the recorder, or, for serving, a few
answers; then ``sound`` the program's numbers (what a run's check
computes); ``control`` the reference put in the program's place one
precision step below the configuration's; a fault's name (training:
``half_batch``, ``frozen``, ``stale_rate`` in the reference in the
program's place, fed the same recorded inputs; ``stale_record``,
``dropout_rate``, ``dropout_scale`` in the program's own readings;
serving: ``altered``). One JSON line per reading on standard output; ``--out``
appends them to a file too.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

from lib import traffic  # noqa: E402
from lib.spec import load_cell, load_module  # noqa: E402


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["sound", "control"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    family, kind = cell.config["family"], cell.traffic["kind"]
    system = load_module("systems", family)
    checks = load_module("checks", family)
    ref = checks.ref
    control = ref.Precision(**cell.config["control"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        data = traffic.make_graph(cell.config, cell.traffic, seed)
        state = system.setup(kind, data, cell.config, cell.traffic, seed,
                             args.device)
        if kind == "train_runs":
            window = dict(records=[system.call(state, 0)])
        else:
            pool = state["pool"]
            window = dict(kept={i: system.request(state, pool[i])
                                for i in range(cell.traffic["sample_requests"])})
        system.release(state)
        memo: dict = {}
        for what in args.what:
            side = (None if what == "sound" else
                    (control, None) if what == "control" else
                    (ref.JUDGE, what))
            numbers, info, _ = checks.check(kind, data, cell.config,
                                            cell.traffic, seed, state, window,
                                            args.device, side, memo)
            line = dict(workload=args.workload, seed=seed, what=what,
                        numbers=numbers, info=info,
                        seconds=time.perf_counter() - t0)
            emit(line)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
