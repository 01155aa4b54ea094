"""Time the port's bench predict and the main-path calls of its five
kernels, for any checkout of the port, on one GPU.

    python3 tools/torch_kernel_replay.py [PORT_ROOT]

PORT_ROOT is the directory that holds the ``bridged_gnn_tpu_torch`` to
time (default: this checkout). First one line (``kernel``: "predict")
with the median and minimum of ``PREDICT_REPS`` full-graph predicts on
the bench graph (host clock, the D2H copy included), as
``chip_smoke.py`` phase 4 times them. Then the script records, as
``chip_smoke.py`` phases 3, 7 and 12 do, the ``attention_sel_fwd`` calls
of one predict on the bench graph and on the lead graph (one layout with
1,024 heavy rows), the ``attention_fwd`` calls of one predict on the hub
graph and, where the checkout has training (``train_step``; the first
serving-only checkouts have not), the backward (``attention_sel_bwd`` on
the bench graph, ``attention_bwd`` on the hub graph) and ``slot_reduce``
calls of one training step on each graph, then replays each call on its
recorded inputs and prints one JSON line per call: ``ms``
(``chip_smoke.cuda_ms``: the wrapper's host work included) and
``device_ms`` (``chip_smoke.cuda_device_ms``: the card's time alone),
and for the reduce the same two of ``index_add_`` on the same inputs.
Per graph one more line (``kernel``: "backward+reduce") sums the step's
backward and reduce calls, so that checkouts that split the work between
the two differently (a 2D-wide ``dm`` reduced without a branch, or a
D-wide one with it) are compared on the same gradient. Timing two
checkouts in turns in one run compares their kernels on one card. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
NAMES = ("attention_sel_fwd", "attention_fwd", "attention_sel_bwd",
         "attention_bwd", "slot_reduce")
PREDICT_REPS = 20


def main(argv) -> int:
    root = Path(argv[1]).resolve() if len(argv) > 1 else REPO
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    # this checkout's chip_smoke.py, whatever PORT_ROOT holds
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    card = cs.card_line()
    print(card, flush=True)
    bench = make_benchmark_graph(**cs.BENCH)
    hub = cs.hub_graph(bench, cs.BENCH["seed"])

    def emit(kernel, graph, layouts, rec, fn, library=None):
        inputs = rec["inputs"]
        row = dict(kernel=kernel, graph=graph, d=rec["d"],
                   layout=next(i for i, lay in enumerate(layouts)
                               if lay is inputs[0]),
                   ms=cs.cuda_ms(lambda: fn(*inputs), cs.KERNEL_REPS),
                   device_ms=cs.cuda_device_ms(lambda: fn(*inputs),
                                               cs.KERNEL_REPS))
        if library is not None:
            call = library(inputs)
            row.update(library_ms=cs.cuda_ms(call, cs.KERNEL_REPS),
                       library_device_ms=cs.cuda_device_ms(
                           call, cs.KERNEL_REPS))
        print(json.dumps(dict(row, port=str(root), card=card)), flush=True)
        return row

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    model = cs.seeded_model(cs.BENCH["num_classes"], cs.BENCH["dim"],
                            cs.BENCH["seed"])
    pred = KTGNNPredictor(copy.deepcopy(model), None, bench, device="cuda")
    pred.predict()
    times = []
    for _ in range(PREDICT_REPS):
        t = time.perf_counter()
        pred.predict()
        times.append((time.perf_counter() - t) * 1e3)
    print(json.dumps(dict(kernel="predict", graph="bench",
                          ms=statistics.median(times), ms_min=min(times),
                          reps=PREDICT_REPS, port=str(root), card=card)),
          flush=True)
    lead = cs.lead_graph(bench, cs.BENCH["seed"])
    for graph, p in (("bench", pred), ("lead", KTGNNPredictor(
            copy.deepcopy(model), None, lead, device="cuda"))):
        layouts = [p.adj.fast_fn.lay_dst]
        with torch.inference_mode():
            for rec in cs.record_run(p.predict, ("attention_sel_fwd",)):
                emit("attention_sel_fwd", graph, layouts, rec,
                     fk.attention_sel_fwd)
        del p, layouts
    del pred, lead
    torch.cuda.empty_cache()

    pred = KTGNNPredictor(copy.deepcopy(model), None, hub, device="cuda")
    layouts = [t.lay_dst for t in pred.adj.tiered_fn.tiers]
    with torch.inference_mode():
        for rec in cs.record_run(pred.predict, ("attention_fwd",)):
            emit("attention_fwd", "hub", layouts, rec, fk.attention_fwd)
    del pred, layouts
    from bridged_gnn_tpu_torch.train import stage2

    if not hasattr(stage2, "train_step"):
        print(json.dumps(dict(port=str(root), training="not in this "
                              "checkout: no backward replayed")), flush=True)
        return 0
    Stage2Config, train_step = stage2.Stage2Config, stage2.train_step

    cfg = Stage2Config(to_undirected=True)
    for graph, data in (("bench", bench), ("hub", hub)):
        g, adj, net, opt, gen = cs.train_setup(data, cfg)
        recs = cs.record_run(
            lambda: train_step(net, g, adj, opt, cfg.Lambda, gen), NAMES)
        layouts = cs.layouts_of(adj)
        bwd = (fk.attention_bwd if adj.fast_fn is None
               else fk.attention_sel_bwd)
        step = dict(kernel="backward+reduce", graph=graph, calls=0, ms=0.0,
                    device_ms=0.0)
        with torch.no_grad():
            for rec in recs:
                if rec["name"] == "slot_reduce":
                    row = emit("slot_reduce", graph, layouts, rec,
                               fk.slot_reduce, cs.reduce_library)
                elif rec["name"] == bwd.__name__:
                    row = emit(bwd.__name__, graph, layouts, rec, bwd)
                else:
                    continue
                step["calls"] += 1
                step["ms"] += row["ms"]
                step["device_ms"] += row["device_ms"]
        print(json.dumps(dict(step, port=str(root), card=card)), flush=True)
        del g, adj, net, opt, recs, layouts
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
