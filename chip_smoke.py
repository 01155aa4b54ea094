"""Drive the PyTorch/CUDA port's KT-GNN serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the CUDA kernels from ``bridged_gnn_tpu_torch/csrc`` (nvcc);
3. kernel phase: one predict on each graph records its kernel launches
   with their inputs (the main path's real layouts and tensors, D=64 and
   D=8); each recorded call is replayed through the kernel and its plain
   PyTorch version on the card (f32, rtol and atol 1e-4), timed with CUDA
   events, and set beside its bound counted from its own inputs;
4. serving, single layout: ``KTGNNPredictor`` on the bench graph
   (131,072 nodes, 2M edges before ``to_undirected``; KT-GNN hidden 64,
   2 layers, batch norm, 8 classes, seeded weights and BN statistics):
   ``predict`` ×10 on the host clock, ×10 more with CUDA events around
   every kernel launch, ``predict_live`` full and partial; the selective
   kernel launched once at D=64 and 3 times at D=8 per predict;
   log-probs against the same predictor on the CPU (plain versions)
   within 1e-4;
5. serving, degree tiers: the "hub graph" (the bench graph with every
   10th edge's destination redrawn from [0, 256)), where the skew rule
   picks >= 2 tiers and the concatenated kernel runs on every tier;
   compared with the CPU as in phase 4;
6. HTTP: ``make_server`` on an ephemeral port answers /healthz, a cached
   and a live /v1/predict.

The launch counts in the ``{"kernels": [...]}`` line are those of the
serving phases (each count is set to 0 just before its phase); its
``ms`` is the kernel's time per predict inside the serving run, and its
``plain_ms`` and ``bound_ms`` sum the replayed calls of one predict.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

BENCH = dict(n=131072, avg_degree=16, dim=128, num_classes=8, seed=0)
HIDDEN = 64              # Stage2Config().hidden: the conv's width
HUB_NODES = 256          # hub destinations of the tiered graph
RTOL = ATOL = 1e-4       # kernel vs plain version, f32
LOGPROB_ATOL = 1e-4      # card vs CPU log-probabilities
KERNEL_REPS = 25
PREDICT_REPS = 10
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM data sheet, f32 outside tensor cores


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def hub_graph(data: dict, seed: int) -> dict:
    """The bench graph with the destination of every 10th edge (before
    to_undirected) replaced by a hub id drawn from [0, HUB_NODES)."""
    rng = np.random.default_rng(seed)
    ei = data["edge_index"].copy()
    ei[1, ::10] = rng.integers(0, HUB_NODES, size=ei[1, ::10].shape[0])
    return dict(data, edge_index=ei)


def seeded_model(num_classes: int, in_channels: int, seed: int):
    """KT-GNN at the serving defaults (Stage2Config: 2 layers, hidden 64,
    batch norm, no root weight) with weights and BN statistics drawn from
    one seeded generator, so batch norm is not the identity."""
    import torch

    from bridged_gnn_tpu_torch.nn.common import MaskedBatchNorm
    from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    cfg = Stage2Config()
    if cfg.hidden != HIDDEN:
        raise RuntimeError(f"Stage2Config().hidden is {cfg.hidden}, "
                           f"not {HIDDEN}")
    gen = torch.Generator().manual_seed(seed)
    model = KTGNN(num_classes, in_channels, layer_num=cfg.num_layer,
                  hidden=cfg.hidden, dropout=cfg.dropout, use_bn=cfg.use_bn,
                  generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, MaskedBatchNorm):
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.bias.normal_(0.0, 0.1, generator=gen)
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


# ------------------------------------------------------------ kernel phase


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times (ms) after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_bound(inputs, concat: bool):
    """Least time for one call on these inputs: the bytes it must move
    over the HBM rate and its f32 operations over the f32 rate.

    Bytes count each input once, as far as this call's data needs it: the
    sender index of every real slot, the slot range of every row, the
    sender rows the slots reach (distinct (sender, branch) pairs for the
    selective kernel, distinct senders in both tables for the
    concatenated one), the own row and flag of every destination with a
    real slot, and the two logit vectors; each output is written once.
    Returns the byte time, the operation time and the real slot count."""
    import torch

    from bridged_gnn_tpu_torch.ops.blocked_segment import slot_rows

    lay, u1, _u2, _ud, central, _a1, _a2, _slope = inputs
    d, n_out = u1.shape[1], central.shape[0]
    row, valid = slot_rows(lay)
    src = lay.slot_src[valid].long()
    real = int(src.numel())
    if concat:
        rows_read = 2 * int(torch.unique(src).numel())
    else:
        rows_read = int(torch.unique(src * 2 + central[row[valid]]).numel())
    dst_read = int(torch.unique(row[valid]).numel())
    f32 = 4
    read = (real * 4 + lay.dst_ranges.numel() * 4 + rows_read * d * f32
            + dst_read * (d * f32 + 1) + 2 * d * f32)
    written = (n_out * (2 if concat else 1) * d * f32
               + lay.slot_src.numel() * f32 + (0 if concat else n_out * f32))
    # per real slot: add, leaky-relu, logit multiply-add, accumulate
    # multiply-add (twice when both branches are aggregated)
    flops = real * d * (8 if concat else 6)
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOPS_PER_S * 1e3, real)


def record_predict(pred, name: str):
    """One ``predict`` with its kernel launches recorded; returns the
    recorded inputs of each launch (all of kernel ``name``)."""
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    with fk.record_launches(keep_inputs=True) as recs:
        pred.predict()
    if not recs or any(r["name"] != name for r in recs):
        raise RuntimeError(f"a predict launched {[r['name'] for r in recs]}"
                           f", not only {name}")
    return [r["inputs"] for r in recs]


def check_kernel(name, wrapper, plain, calls, layouts):
    """Replay each recorded call through the kernel and its plain version
    on the card; returns per-call records with errors, times and
    bounds."""
    import torch

    records = []
    for i, inputs in enumerate(calls):
        got = wrapper(*inputs)
        torch.cuda.synchronize()
        want = plain(*inputs)
        abs_err = rel_err = 0.0
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: non-finite kernel output")
            diff = (g - w).abs()
            abs_err = max(abs_err, float(diff.max()))
            rel_err = max(rel_err, float(
                (diff / w.abs().clamp(min=ATOL)).max()))
        d = inputs[1].shape[1]
        layout = next(j for j, lay in enumerate(layouts) if lay is inputs[0])
        for g, w in zip(got, want):
            if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
                raise RuntimeError(
                    f"{name} disagrees with its plain version at D={d}, "
                    f"layout {layout}: max abs err {abs_err:.3g}")
        ms = cuda_ms(lambda: wrapper(*inputs), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*inputs), 5, warmup=1)
        t_bytes, t_ops, real = kernel_bound(inputs, concat=len(got) == 2)
        lay = inputs[0]
        records.append(dict(
            call=i, layout=layout, d=d, tile_e=lay.tile_e,
            blocks=lay.num_blocks, slots=int(lay.slot_src.numel()),
            real_slots=real, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=abs_err, max_rel_err=rel_err,
        ))
        del got, want
    return records


# ----------------------------------------------------------- serving phase


HEADS = ("source", "target", "target_hat")


def check_heads(preds: dict, n: int, num_classes: int, what: str) -> None:
    """Finite log-probabilities of the expected shape, rows summing to 1."""
    for head in HEADS:
        lp = preds[head]
        if lp.shape != (n, num_classes) or not np.isfinite(lp).all():
            raise RuntimeError(f"{what}: head {head} has shape {lp.shape} "
                               "or non-finite values")
        if not np.allclose(np.exp(lp).sum(1), 1.0, atol=1e-4):
            raise RuntimeError(f"{what}: head {head} is not a distribution")


def serve_phase(name, pred, data, model, kernel, expect_tiered: bool,
                reps: int) -> dict:
    """Drive ``pred`` on the card (predict ×(1 + 2·reps), predict_live
    full and partial), count its kernel's launches in all and per width,
    time the launches of ``reps`` predicts with CUDA events, and compare
    its heads with the same predictor built on the CPU (plain
    versions)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    tiers = pred.adj.tiered_fn.tiers if pred.adj.tiered_fn else None
    if (tiers is not None) != expect_tiered or (tiers and len(tiers) < 2):
        raise RuntimeError(f"{name}: the skew rule gave "
                           f"{len(tiers) if tiers else 1} layout(s)")
    n_layouts = len(tiers) if tiers else 1
    n, num_classes = pred.graph.num_nodes, int(data["y"].max()) + 1
    # per layout: the conv at HIDDEN, clf_base and clf_target (twice) at
    # the number of classes
    want_by_d = {HIDDEN: n_layouts, num_classes: 3 * n_layouts}

    fk.reset_launch_counts()
    first = pred.predict()
    per_predict = kernel.launches
    by_d = dict(kernel.launches_by_d)
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        pred.predict()
        times.append((time.perf_counter() - t) * 1e3)
    # kernel time inside the serving run: events around every launch
    with fk.record_launches() as recs:
        marks = []
        for _ in range(reps):
            marks.append(len(recs))
            pred.predict()
        marks.append(len(recs))
    torch.cuda.synchronize()
    if any(r["name"] != kernel.__name__ for r in recs):
        raise RuntimeError(f"{name}: launches of another kernel recorded")
    kernel_ms = [sum(r["start"].elapsed_time(r["stop"])
                     for r in recs[a:b]) for a, b in zip(marks, marks[1:])]
    launch_ms_by_d = {
        d: statistics.median(r["start"].elapsed_time(r["stop"])
                             for r in recs if r["d"] == d)
        for d in want_by_d}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, pred.graph.num_features)).astype(np.float32)
    live_full = pred.predict_live(x)
    nodes = rng.choice(n, size=64, replace=False)
    live_rows = pred.predict_live(x[nodes], nodes)
    launches = kernel.launches
    other = sum(fn.launches for fn in fk.KERNEL_WRAPPERS) - launches
    calls = 1 + 2 * reps + 2
    if by_d != want_by_d or launches != calls * per_predict or other:
        raise RuntimeError(
            f"{name}: {kernel.__name__} launched {by_d} (by width) in one "
            f"predict (expected {want_by_d}) and {launches} in {calls} "
            f"calls; other kernels {other}")
    for what, preds in (("predict", first), ("live full", live_full),
                        ("live rows", live_rows)):
        check_heads(preds, n, num_classes, f"{name} {what}")

    t0 = time.perf_counter()
    ref = KTGNNPredictor(copy.deepcopy(model), None, data, device="cpu")
    ref_first = ref.predict()
    ref_s = time.perf_counter() - t0
    err = max(float(np.abs(first[h] - ref_first[h]).max()) for h in HEADS)
    if err > LOGPROB_ATOL:
        raise RuntimeError(f"{name}: card vs CPU log-probs differ by "
                           f"{err:.3g} > {LOGPROB_ATOL}")
    return dict(
        phase=name, layouts=n_layouts,
        tile_e=[t.lay_dst.tile_e for t in tiers] if tiers
        else [pred.adj.fast_fn.lay_dst.tile_e],
        edges=int(pred.graph.num_edges), nodes=n,
        kernel=kernel.__name__, launches=launches,
        launches_per_predict=per_predict,
        launches_per_predict_by_d=by_d,
        predict_ms_median=statistics.median(times),
        predict_ms_min=min(times), predicts_timed=reps,
        kernel_ms_per_predict_median=statistics.median(kernel_ms),
        kernel_ms_per_predict_min=min(kernel_ms),
        launch_ms_median_by_d=launch_ms_by_d,
        predicts_event_timed=reps,
        cpu_reference_s=ref_s, max_abs_logprob_err_vs_cpu=err,
    )


def http_phase(pred) -> dict:
    from bridged_gnn_tpu_torch.cli.serve import ServingApp, make_server

    app = ServingApp(predictor=pred)
    srv = make_server(app)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    try:
        d = pred.graph.num_features
        answers = [
            call("/healthz"),
            call("/v1/predict", {"nodes": [0, 1, 2, 3]}),
            call("/v1/predict", {"nodes": [5, 6], "x_nodes": [5, 6],
                                 "x": np.ones((2, d)).tolist(),
                                 "log_probs": True}),
        ]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    if th.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    (c0, health), (c1, cached), (c2, live) = answers
    if (c0, c1, c2) != (200, 200, 200) or health["status"] != "ok" \
            or cached["computed"] != "cache" or live["computed"] != "live" \
            or len(cached["labels"]) != 4 or len(live["log_probs"]) != 2:
        raise RuntimeError(f"HTTP answers are wrong: {answers}")
    return dict(healthz=health, cached_labels=cached["labels"],
                live_labels=live["labels"], requests=3)


# --------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: "
              "torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from bridged_gnn_tpu_torch.data.synthetic import make_benchmark_graph
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    t_start = time.perf_counter()
    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}"
        f" count {torch.cuda.device_count()}")
    log(f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"(float32 matmul precision {torch.get_float32_matmul_precision()})")

    # 2. build
    lib, build_s = fk.build_kernels()
    log(f"build {lib.name}: {build_s:.3f} s")

    # graphs, model and the card's predictors (layouts built once)
    t0 = time.perf_counter()
    bench = make_benchmark_graph(**BENCH)
    hub = hub_graph(bench, BENCH["seed"])
    model = seeded_model(BENCH["num_classes"], BENCH["dim"], BENCH["seed"])
    log(f"graphs and model ready in {time.perf_counter() - t0:.1f} s")

    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    t0 = time.perf_counter()
    pred = KTGNNPredictor(copy.deepcopy(model), None, bench, device="cuda")
    pred_t = KTGNNPredictor(copy.deepcopy(model), None, hub, device="cuda")
    log(f"card predictors (graph build, slot layouts) ready in "
        f"{time.perf_counter() - t0:.1f} s")
    if pred.adj.fast_fn is None or pred_t.adj.tiered_fn is None:
        raise RuntimeError("bench graph must give one layout, hub graph tiers")

    # 3. kernel phase: each kernel's calls in one predict of the main
    # path, replayed against the plain versions
    with torch.inference_mode():
        sel = check_kernel(
            "attention_sel_fwd", fk.attention_sel_fwd,
            fk.attention_sel_fwd_plain,
            record_predict(pred, "attention_sel_fwd"),
            [pred.adj.fast_fn.lay_dst])
        cat = check_kernel(
            "attention_fwd", fk.attention_fwd, fk.attention_fwd_plain,
            record_predict(pred_t, "attention_fwd"),
            [t.lay_dst for t in pred_t.adj.tiered_fn.tiers])
    for name, recs in (("attention_sel_fwd", sel), ("attention_fwd", cat)):
        for r in recs:
            log(json.dumps(dict(kernel=name, card=card, **r)))

    # 4. serving, single layout (selective kernel)
    single = serve_phase("serve_single", pred, bench, model,
                         fk.attention_sel_fwd, expect_tiered=False,
                         reps=PREDICT_REPS)
    log(json.dumps(dict(card=card, **single)))

    # 5. serving, degree tiers (concatenated kernel on every tier)
    tiered = serve_phase("serve_tiered", pred_t, hub, model,
                         fk.attention_fwd, expect_tiered=True,
                         reps=PREDICT_REPS)
    log(json.dumps(dict(card=card, **tiered)))
    del pred_t

    # 6. HTTP
    fk.reset_launch_counts()
    http = http_phase(pred)
    http["sel_launches"] = fk.attention_sel_fwd.launches
    if http["sel_launches"] == 0:
        raise RuntimeError("HTTP phase launched no kernel")
    log(json.dumps(dict(phase="http", **http)))

    # summary, per kernel: its launches in the serving phase, its time per
    # predict inside that run, and, summed over the calls of one predict
    # replayed in phase 3, the same calls alone, the plain version and the
    # bound
    kernels = []
    for name, recs, phase, replaces in (
            ("attention_sel_fwd", sel, single,
             "bridged_gnn_tpu/ops/pallas_fused.py:501"),
            ("attention_fwd", cat, tiered,
             "bridged_gnn_tpu/ops/pallas_fused.py:168")):
        bytes_ms = sum(r["bytes_ms"] for r in recs)
        ops_ms = sum(r["ops_ms"] for r in recs)
        kernels.append(dict(
            name=name, route="cuda",
            source="bridged_gnn_tpu_torch/csrc/attention_fwd.cu",
            replaces=replaces, launches=phase["launches"],
            launches_per_predict=phase["launches_per_predict"],
            launches_per_predict_by_d=phase["launches_per_predict_by_d"],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=phase["kernel_ms_per_predict_median"],
            ms_replayed=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(r["bound_ms"] for r in recs),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, per="predict", card=card,
        ))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
