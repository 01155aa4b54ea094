"""Measure the padded SpMM kernel (``gather_reduce``) on one GPU: its
column panels, the rate a uniform-random gather reaches from L2, and
this checkout against another one in turns.

    python3 tools/torch_spmm_panels.py [--parent DIR] [--ptxas]

Every line is one JSON object beside the card's name and power limit
(``nvidia-smi``); times are the card's alone (``chip_smoke.cuda_device_ms``).

1. ``ptxas`` (with ``--ptxas``): registers, spills and shared memory of
   every instantiation of ``csrc/gather_reduce.cu`` (``nvcc -Xptxas -v``
   with the kernels' own flags).
2. ``sweep``: the unweighted forward (GraphSAGE's form) on the
   ``--no_dtc`` bench layout (256-row blocks, ~4.19M entries) with seeded
   rows at D = 64, 128, 512 and 1030, forced to panels of 32, 64 and 128
   columns and of D where the kernel takes it, and the wrapper's own
   choice; every output bit-identical to the wrapper's. At D = 64 and 128 the
   unweighted transpose too.
3. ``footprint``: the same entries and ranges with fresh uniform
   indices into tables of 16,384 to 262,144 rows at D = 64 (4.2 to 67 MB;
   one panel): the gather's rate against
   the bytes its rows take in L2. The 16,384-row table is the gather
   ceiling, what the walk reaches when every row hits L2.
4. ``turn`` (with ``--parent DIR``): DIR, this checkout, this checkout,
   DIR, each in a process of its own (``--replay ROOT``): the
   ``gather_reduce`` calls of one ``--no_dtc`` epoch on the bench graph
   and on the hub graph, the weighted forward and transpose at D = 8 (the
   classes' width, where GCN and APPNP aggregate) on the bench layout
   with seeded weights, and the unweighted forward, weighted forward
   and weighted transpose at D = 257, 512 and 1030 with seeded rows; per
   call its device time, its bound (``chip_smoke.gather_bound``) and the
   SHA-256 of its output, and the
   GraphSAGE scan epoch (12 epochs in chunks of 5, host clock). A
   ``compare`` line per call gives each tree's median and whether every
   turn of both trees gave the same bits.

Gathered bytes count each entry's row once per panel, as wide as the
panel: entries × D × 4 in all. Exits non-zero without a CUDA device, or
when two trees' outputs differ.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent.parent
SWEEP_DS = (64, 128, 512, 1030)
SWEEP_PANELS = (32, 64, 128)
FOOTPRINT_ROWS = (16_384, 65_536, 98_304, 131_072, 163_840, 196_608,
                  262_144)
TURN_WIDE_DS = (257, 512, 1030)
SCAN_EPOCHS, SCAN_CHUNK = 12, 5
REPS = 25


def _smoke():
    """This checkout's chip_smoke.py, whatever tree is imported."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_panels", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _emit(card, **row):
    print(json.dumps(dict(card=card, **row)), flush=True)


def _bench_setup(cs, data):
    """The --no_dtc recipe's training setup on ``data`` and one epoch's
    recorded gather_reduce calls (train step and eval forward)."""
    from bridged_gnn_tpu_torch.train import stage2

    cfg = cs.no_dtc_cfg()
    g, adj, model, opt, gen = cs.train_setup(data, cfg)
    backend = stage2.Stage2Backend(model, g, adj, {}, cfg, g.num_classes)

    def epoch():
        backend.train_step(opt, gen)
        backend.eval_heads()

    recs = cs.record_run(epoch, ("gather_reduce",))
    return g, adj, recs


def ptxas() -> None:
    """Registers, spills and shared memory per instantiation."""
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    src = next(s for s in fk.SOURCES if s.name == "gather_reduce.cu")
    out = subprocess.run(
        [fk._nvcc(), *fk.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         "/dev/null", str(src)], capture_output=True, text=True, check=True)
    kernel = None
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line:
            m = re.search(
                r"gather_reduce_kernelILb(\d)ELi(\d+)ELi(\d+)ELb(\d)E", line)
            kernel = (None if m is None else
                      "vec={} G={} kU={} weighted={}".format(*m.groups()))
        elif "Used" in line and kernel is not None:
            print(json.dumps(dict(ptxas=kernel, used=line.split(
                "Used", 1)[1].strip())), flush=True)
        elif "spill" in line and kernel is not None:
            print(json.dumps(dict(ptxas=kernel, spills=line.strip())),
                  flush=True)


def sweep(cs, card, lay) -> None:
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    n = lay.num_nodes_padded
    entries = int((lay.slot_src >= 0).sum())
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    for d in SWEEP_DS:
        gen = torch.Generator(device="cuda").manual_seed(d)
        x = torch.randn(n, d, generator=gen, device="cuda")
        for transpose in (False, True) if d <= 128 else (False,):
            args = (lay, x, n, None, transpose)
            want = fk.gather_reduce(*args)
            default = fk.gather_panel(n, d, l2)
            choices = [None] + [p for p in sorted({*SWEEP_PANELS, d})
                                if p <= min(d, fk.MAX_PANEL)]
            for panel in choices:
                def call():
                    return fk._gather_reduce_launch(*args, panel)
                same = torch.equal(call(), want)
                ms = cs.cuda_device_ms(call, REPS)
                p = default if panel is None else panel
                _emit(card, phase="sweep", d=d, transpose=transpose,
                      panel=p, wrapper=panel is None,
                      panels=fk.gather_panel_count(d, p),
                      panel_mb=n * p * 4 / 1e6, device_ms=ms,
                      gathered_gb=entries * d * 4 / 1e9,
                      rate_tb_s=entries * d * 4 / ms / 1e9,
                      bit_identical=same)
                if not same:
                    raise RuntimeError(f"D={d} panel {panel} differs")
        del x
        torch.cuda.empty_cache()


def footprint(cs, card, lay) -> None:
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    d = 64
    valid = lay.slot_src >= 0
    entries = int(valid.sum())
    for rows in FOOTPRINT_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(rows)
        idx = torch.randint(0, rows, (entries,), generator=gen,
                            device="cuda", dtype=torch.int32)
        src = torch.full_like(lay.slot_src, -1)
        src[valid] = idx
        lay_r = lay._replace(slot_src=src, sender_bound=rows)
        x = torch.randn(rows, d, generator=gen, device="cuda")
        args = (lay_r, x, lay.num_nodes_padded, None, False)
        want = fk.gather_reduce_plain(*args)
        got = fk._gather_reduce_launch(*args, 64)
        scale = float(want.abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            raise RuntimeError(f"footprint {rows} rows disagrees with the "
                               "plain version")
        ms = cs.cuda_device_ms(lambda: fk._gather_reduce_launch(*args, 64),
                               REPS)
        _emit(card, phase="footprint", rows=rows, d=d,
              table_mb=rows * d * 4 / 1e6, entries=entries, device_ms=ms,
              gathered_gb=entries * d * 4 / 1e9,
              rate_tb_s=entries * d * 4 / ms / 1e9)
        del x, src, idx, lay_r, want, got
        torch.cuda.empty_cache()


def replay(root: str) -> int:
    """One turn: this process imports the port from ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    cs = _smoke()
    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2

    card = cs.card_line()
    bench = make_benchmark_graph(**cs.BENCH)
    hub = cs.hub_graph(bench, cs.BENCH["seed"])

    def emit(graph, name, d, args):
        def fn():
            return fk.gather_reduce(*args)
        with torch.no_grad():   # the recorded inputs may require grad
            out = fn()
            ms = cs.cuda_device_ms(fn, REPS)
            bound = max(cs.gather_bound(args)[:2])
        _emit(card, phase="turn", root=root, graph=graph, call=name, d=d,
              device_ms=ms, bound_ms=bound, sha256=_digest(out))

    for graph, data in (("bench", bench), ("hub", hub)):
        g, adj, recs = _bench_setup(cs, data)
        layouts = cs.layouts_of(adj)
        for i, rec in enumerate(recs):
            args = rec["inputs"]
            tier = next(j for j, lay in enumerate(layouts) if lay is args[0])
            name = (f"epoch{i}:tier{tier}:" + ("T" if args[4] else "F")
                    + ("w" if args[3] is not None else "u"))
            emit(graph, name, rec["d"], args)
        if graph == "bench":
            lay, n = layouts[0], g.num_nodes_padded
            w = torch.rand(lay.slot_src.shape[0], device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(0))
            for d in (8, *TURN_WIDE_DS):
                gen = torch.Generator(device="cuda").manual_seed(d)
                x = torch.randn(n, d, generator=gen, device="cuda")
                forms = (((True, False), (True, True)) if d == 8 else
                         ((False, False), (True, False), (True, True)))
                for weighted, transpose in forms:
                    args = (lay, x, n, w if weighted else None, transpose)
                    emit(graph, ("T" if transpose else "F")
                         + ("w" if weighted else "u"), d, args)
                del x
                torch.cuda.empty_cache()
        del g, adj, recs
        torch.cuda.empty_cache()
    prepared = stage2.prepare_stage2_graph(bench, cs.no_dtc_cfg(), "cuda")
    with mock.patch.object(stage2, "prepare_stage2_graph",
                           lambda *a, **k: prepared):
        res = stage2.train_ktgnn(bench, cs.no_dtc_cfg(
            num_epoch=SCAN_EPOCHS, scan_epochs=SCAN_CHUNK), device="cuda")
    _emit(card, phase="turn", root=root, graph="bench", call="scan_epoch",
          epoch_ms=res["throughput"]["p50_s"] * 1e3)
    return 0


def turns(card, parent: str) -> int:
    """parent, this checkout, this checkout, parent; a compare line per
    call."""
    rows = []
    for root in (parent, str(REPO), str(REPO), parent):
        run = subprocess.run([sys.executable, __file__, "--replay", root],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the turn on {root} exited {run.returncode}")
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
                rows.append(json.loads(line))
    bad = 0
    keys = sorted({(r["graph"], r["call"], r.get("d")) for r in rows},
                  key=str)
    for graph, call, d in keys:
        mine = [r for r in rows if (r["graph"], r["call"], r.get("d"))
                == (graph, call, d)]
        key = "epoch_ms" if call == "scan_epoch" else "device_ms"
        by_root = {root: statistics.median(r[key] for r in mine
                                           if r["root"] == root)
                   for root in (parent, str(REPO))}
        digests = {r["sha256"] for r in mine if "sha256" in r}
        same = len(digests) <= 1
        bad += not same
        _emit(card, phase="compare", graph=graph, call=call, d=d,
              **{key + "_parent": by_root[parent],
                 key: by_root[str(REPO)]},
              bound_ms=mine[0].get("bound_ms"),
              bit_identical=same if digests else None)
    return 1 if bad else 0


def main(argv) -> int:
    if "--replay" in argv:
        return replay(argv[argv.index("--replay") + 1])
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    card = cs.card_line()
    print(card, flush=True)
    if "--ptxas" in argv:
        ptxas()
    t0 = time.perf_counter()
    fk.build_kernels()
    bench = make_benchmark_graph(**cs.BENCH)
    g, adj, recs = _bench_setup(cs, bench)
    lay = cs.layouts_of(adj)[0]
    sweep(cs, card, lay)
    footprint(cs, card, lay)
    del g, adj, recs
    torch.cuda.empty_cache()
    _emit(card, phase="panels_s", s=time.perf_counter() - t0)
    if "--parent" in argv:
        return turns(card, argv[argv.index("--parent") + 1])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
