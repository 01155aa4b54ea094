"""Time the port's training epoch, per-epoch loop and scan mode, for any
checkout of the port, on one GPU.

    python3 tools/torch_epoch_timing.py [PORT_ROOT] [--adam]

PORT_ROOT is the directory that holds the ``bridged_gnn_tpu_torch`` to
time (default: this checkout). On the bench graph and the hub graph of
``chip_smoke.py`` (KT-GNN at the ``Stage2Config`` defaults) the script
runs ``train_ktgnn`` for ``EPOCHS`` epochs as a per-epoch loop and,
where the checkout has scan mode, with ``scan_epochs=CHUNK``, and prints
one JSON line per run: the host-clock epoch median and mean of the
steady epochs (``utils/profiling.EpochTimer``) and the losses, beside
the card's name and power limit. The graph and its layouts are built
once per graph. Timing two checkouts in turns in one call
compares them on one card.

``--adam`` adds, for this checkout's model on the bench graph, the time
of ``STEP_REPS`` Adam steps (host clock, the card synchronized at both
ends) with a float rate (foreach) and with a float64 tensor rate
(capturable), the per-epoch loop's and scan mode's. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent.parent
EPOCHS = 12
CHUNK = 5
STEP_REPS = 50


def _adam_steps(model, lr, capturable: bool) -> float:
    """Seconds per Adam step over STEP_REPS steps on fixed gradients."""
    import torch

    opt = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=5e-3,
                           capturable=capturable)
    for p in model.parameters():
        p.grad = torch.ones_like(p) * 1e-3
    for _ in range(3):
        opt.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_REPS):
        opt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEP_REPS


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

    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.train import stage2

    card = cs.card_line()
    bench = make_benchmark_graph(**cs.BENCH)
    graphs = (("bench", bench), ("hub", cs.hub_graph(bench,
                                                     cs.BENCH["seed"])))
    has_scan = "scan_epochs" in stage2.Stage2Config.__dataclass_fields__
    for name, data in graphs:
        cfg = stage2.Stage2Config(num_epoch=EPOCHS, to_undirected=True)
        prepared = stage2.prepare_stage2_graph(data, cfg, "cuda")
        modes = [("loop", 0)] + ([("scan", CHUNK)] if has_scan else [])
        with mock.patch.object(stage2, "prepare_stage2_graph",
                               lambda *a, **k: prepared):
            for mode, k in modes:
                kw = dict(scan_epochs=k) if has_scan else {}
                try:
                    res = stage2.train_ktgnn(
                        data, stage2.Stage2Config(num_epoch=EPOCHS,
                                                  to_undirected=True, **kw),
                        device="cuda")
                except NotImplementedError as e:   # scan not ported there
                    print(json.dumps(dict(root=str(root), graph=name,
                                          mode=mode, skipped=str(e))))
                    continue
                tp = res["throughput"]
                print(json.dumps(dict(
                    root=str(root), graph=name, mode=mode, card=card,
                    epochs=EPOCHS, epoch_ms_median=tp["p50_s"] * 1e3,
                    epoch_ms_mean=tp["mean_s"] * 1e3,
                    steady_epochs=tp.get("steady_steps"),
                    losses=[h["loss"] for h in res["history"]])),
                    flush=True)
        del prepared
        torch.cuda.empty_cache()
    if "--adam" in argv:
        g, adj = stage2.prepare_stage2_graph(bench, stage2.Stage2Config(),
                                             "cuda")
        model = stage2.build_model(stage2.Stage2Config(), g.num_classes,
                                   g.num_features, "cuda")
        lr64 = torch.tensor(1e-3, dtype=torch.float64, device="cuda")
        print(json.dumps(dict(
            root=str(root), card=card, adam_step_reps=STEP_REPS,
            foreach_float_lr_ms=_adam_steps(model, 1e-3, False) * 1e3,
            capturable_tensor_lr_ms=_adam_steps(model, lr64, True) * 1e3)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
