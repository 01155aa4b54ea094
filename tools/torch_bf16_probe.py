"""Time each main-path kernel call with f32 message tables and with the
same tables in bf16, on one GPU; or, with ``--memory``, the device memory
that training runs leave behind, for any checkout of the port.

    python3 tools/torch_bf16_probe.py
    python3 tools/torch_bf16_probe.py --memory [PORT_ROOT]

The first form records, as ``chip_smoke.py`` phases 3 and 7 do, the
forward calls of one f32 predict (``attention_sel_fwd`` on the bench
graph, ``attention_fwd`` on the hub graph) and the backward and
``slot_reduce`` calls of one f32 training step on each graph, then times
every call on its recorded inputs and on the same inputs with the tables
(``u1``, ``u2``, ``ud``; the reduce's ``vals``) cast to bf16, in turns
(f32, bf16, bf16, f32), each the card's time per call over ``REPS``
launches behind a sleep (``chip_smoke.cuda_device_ms``). One JSON line
per call: both dtypes' medians, the call's width, layout and heavy rows.
The two dtypes run the same graph, slots and launch configuration, so
the difference is what the row bytes and the bf16 loads change.

``--memory`` trains the bench graph (``Stage2Config`` defaults, 6
epochs) as a per-epoch loop, then three times in scan mode
(``scan_epochs=5``), in one process, and prints after each run the
bytes still allocated on the device before and after ``gc.collect()``.
PORT_ROOT is the directory that holds the ``bridged_gnn_tpu_torch`` to
run (default: this checkout). Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REPS = 25
MEMORY_EPOCHS = 6


def _memory(cs, card) -> None:
    import torch

    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_ktgnn

    bench = make_benchmark_graph(**cs.BENCH)
    for i, scan in enumerate((0, 5, 5, 5)):
        train_ktgnn(bench, Stage2Config(num_epoch=MEMORY_EPOCHS,
                                        to_undirected=True,
                                        scan_epochs=scan), device="cuda")
        torch.cuda.synchronize()
        before_gc = torch.cuda.memory_allocated()
        gc.collect()
        print(json.dumps(dict(
            run=i, mode="scan" if scan else "loop", card=card,
            allocated_bytes=before_gc,
            allocated_bytes_after_gc=torch.cuda.memory_allocated())),
            flush=True)


def _replay(cs, card) -> None:
    import torch

    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config, train_step

    bench = make_benchmark_graph(**cs.BENCH)
    hub = cs.hub_graph(bench, cs.BENCH["seed"])
    model = cs.seeded_model(cs.BENCH["num_classes"], cs.BENCH["dim"],
                            cs.BENCH["seed"])
    bf16 = torch.bfloat16

    def to_bf16(name, inputs):
        idx = (1,) if name == "slot_reduce" else (1, 2, 3)
        return tuple(a.to(bf16) if i in idx else a
                     for i, a in enumerate(inputs))

    def report(graph, recs, layouts):
        for rec in recs:
            name, inputs = rec["name"], rec["inputs"]
            fn = getattr(fk, name)
            half = to_bf16(name, inputs)
            times = {"float32": [], "bfloat16": []}
            for dt in ("float32", "bfloat16", "bfloat16", "float32"):
                args = inputs if dt == "float32" else half
                times[dt].append(cs.cuda_device_ms(lambda: fn(*args), REPS))
            lay = inputs[0]
            print(json.dumps(dict(
                graph=graph, kernel=name, d=rec["d"],
                layout=next(j for j, x in enumerate(layouts) if x is lay),
                heavy_rows=int(lay.dst_heavy.numel()), card=card,
                f32_device_ms=statistics.median(times["float32"]),
                bf16_device_ms=statistics.median(times["bfloat16"]),
                runs=times)), flush=True)

    for graph, data, fwd, bwd in (
            ("bench", bench, "attention_sel_fwd", "attention_sel_bwd"),
            ("hub", hub, "attention_fwd", "attention_bwd")):
        pred = KTGNNPredictor(copy.deepcopy(model), None, data,
                              device="cuda")
        with torch.inference_mode():
            report(graph, cs.record_run(pred.predict, (fwd,)),
                   cs.layouts_of(pred.adj))
        del pred
        cfg = Stage2Config(to_undirected=True)
        g, adj, net, opt, gen = cs.train_setup(data, cfg)
        recs = cs.record_run(
            lambda: train_step(net, g, adj, opt, cfg.Lambda, gen),
            (fwd, bwd, "slot_reduce"))
        with torch.no_grad():
            report(graph, [r for r in recs if r["name"] != fwd],
                   cs.layouts_of(adj))
        del recs, g, adj, net, opt, gen
        torch.cuda.empty_cache()


def main(argv) -> int:
    args = [a for a in argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve() if args else REPO
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
    card = cs.card_line()
    if "--memory" in argv:
        _memory(cs, card)
    else:
        _replay(cs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
