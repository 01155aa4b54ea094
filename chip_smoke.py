"""Drive the PyTorch/CUDA port's KT-GNN serving and training paths on one GPU.

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
   and a live /v1/predict;
7. backward kernel phase: one training step on each graph (KT-GNN at
   the Stage2Config defaults: hidden 64, dropout 0.5, Adam) records its
   kernel launches with their inputs; each backward and sender-reduce
   call is replayed through the kernel and its plain version on the card
   (f32, rtol 1e-4 and atol 1e-4 times the output's largest magnitude:
   the gradients are small and each sums up to thousands of terms that
   cancel),
   timed with CUDA events, set beside its bound, and the sender reduce
   beside ``index_add_``; one backward of the whole model run twice must
   give bit-identical gradients;
8. training, single layout: ``train_ktgnn`` on the bench graph for 10
   epochs; per epoch the selective forward launches 8 times (4 in the
   step, 4 in the eval), its backward 4 times and the sender reduce 4
   times (1 at D=64 and 3 at D=8 per pass); finite losses, the last below
   the first;
9. training, degree tiers: the same on the hub graph for 5 epochs, the
   concatenated forward and backward on every tier (>= 2 tiers);
10. card vs CPU: 2 epochs at dropout 0 from the same seeded init on the
   card and on the CPU (plain versions), on each graph; per-epoch losses
   within rtol 1e-4, final weights and BN statistics within rtol 1e-3 and
   atol 1e-5.

In the ``{"kernels": [...]}`` line the forwards' launch counts are those
of the serving phases and their ``ms`` the kernel's time per predict
inside the serving run (``per``: "predict"); the backwards' counts are
those of the training phases and their ``ms`` the kernel's time per
epoch inside the training run (``per``: "epoch"). Each count is set to 0
just before its phase. ``plain_ms``, ``bound_ms`` and ``library_ms`` sum
the replayed calls of one predict or one training step.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero and prints no result.
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
LOSS_RTOL = 1e-4         # card vs CPU training losses
WEIGHT_RTOL, WEIGHT_ATOL = 1e-3, 1e-5   # card vs CPU weights after training
KERNEL_REPS = 25
PLAIN_REPS = 20          # the backward phase's plain versions
PREDICT_REPS = 10
TRAIN_EPOCHS = 10        # phase 8, single layout
TIERED_EPOCHS = 5        # phase 9
PARITY_EPOCHS = 2        # phase 10
PARITY_NODES = BENCH["n"]   # phase 10 graph size
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


def bwd_bound(inputs, concat: bool):
    """Least time for one backward call on these inputs, counted as
    :func:`kernel_bound` counts a forward: the sender index of every real
    slot, the slot ranges, the sender rows the slots reach (distinct
    (sender, branch) pairs: both kernels read the destination's branch
    only), the own row, output cotangent, flag (and, selective, den) of
    every destination with a real slot, the per-slot weight (ex or α) of
    every real slot and the two logit vectors; the outputs dm (every
    slot, D or 2D wide), dud, da and (selective) the slots' branch flags
    are written once. Operations: 13·D per real slot (two
    dot products, leaky-relu and its gate, dz, dm, dud and da)."""
    import torch

    from bridged_gnn_tpu_torch.ops.blocked_segment import slot_rows

    lay, u1, _u2, _ud, central = inputs[:5]
    d, n_out = u1.shape[1], central.shape[0]
    row, valid = slot_rows(lay)
    src = lay.slot_src[valid].long()
    real = int(src.numel())
    rows_read = int(torch.unique(src * 2 + central[row[valid]]).numel())
    dst_read = int(torch.unique(row[valid]).numel())
    n_slots = int(lay.slot_src.numel())
    f32 = 4
    read = (real * 4 + lay.dst_ranges.numel() * 4 + rows_read * d * f32
            + dst_read * (2 * d * f32 + 1 + (0 if concat else f32))
            + real * f32 + 2 * d * f32)
    written = (n_slots * (2 if concat else 1) * d * f32 + n_out * d * f32
               + 2 * d * f32 + (0 if concat else n_slots))
    flops = real * d * 13
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOPS_PER_S * 1e3, real)


def reduce_bound(inputs):
    """Least time for one sender-keyed reduce: the CSR ranges and slot
    ids, one W-wide row (and, split, one branch flag) per real slot read,
    the output written once; one add per element of every row read."""
    lay, vals, n_rows, branch = inputs
    real, w = int(lay.src_slots.numel()), vals.shape[1]
    read = (lay.src_ranges.numel() * 4 + real * 4 + real * w * 4
            + (real if branch is not None else 0))
    written = n_rows * w * (2 if branch is not None else 1) * 4
    return (((read + written) / HBM_BYTES_PER_S * 1e3,
             real * w / F32_FLOPS_PER_S * 1e3, real))


def reduce_library(inputs):
    """The one PyTorch call that computes the sender-keyed reduce on the
    same inputs: ``index_add_`` of every slot row into its sender's row
    (pad and masked slots carry zero rows), the branch split folded into
    the index. Timed as a yardstick only; the port never calls it."""
    import torch

    lay, vals, n_rows, branch = inputs
    sender = lay.slot_src.long().clamp(min=0)
    w = vals.shape[1]
    if branch is None:
        idx, rows = sender, n_rows
    else:
        idx, rows = 2 * sender + (1 - branch.long()), 2 * n_rows

    def call():
        out = torch.zeros(rows, w, device=vals.device).index_add_(
            0, idx, vals)
        return out.view(n_rows, -1)
    return call


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def record_run(fn, names):
    """Run ``fn`` with its kernel launches recorded; returns the
    launch records (``name``, ``d``, ``inputs``), all of kernels in
    ``names``."""
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    with fk.record_launches(keep_inputs=True) as recs:
        fn()
    if not recs or any(r["name"] not in names for r in recs):
        raise RuntimeError(f"the run launched {[r['name'] for r in recs]}"
                           f", not only {names}")
    return recs


def check_kernel(name, wrapper, plain, calls, layouts, bound=None,
                 scaled=False, plain_reps=5, library=None):
    """Replay each recorded call through the kernel and its plain version
    on the card; returns per-call records with errors, times and bounds.

    Integer outputs must be equal. Float outputs must agree within rtol
    ``RTOL`` and atol ``ATOL``, times the output's largest magnitude when
    ``scaled``. ``bound(inputs)`` gives the byte time, the
    operation time and the real slot count (default: the forwards'
    :func:`kernel_bound`); ``library(inputs)``, where given, the one
    PyTorch call computing the same function, which is checked and
    timed beside the kernel."""
    import torch

    records = []
    for i, rec in enumerate(calls):
        inputs = rec["inputs"]
        got = _outs(wrapper(*inputs))
        torch.cuda.synchronize()
        want = _outs(plain(*inputs))
        layout = next(j for j, lay in enumerate(layouts) if lay is inputs[0])
        where = f"{name} at D={rec['d']}, layout {layout}"
        abs_err = rel_err = norm_err = 0.0
        for g, w in zip(got, want):
            if not g.is_floating_point():
                if not torch.equal(g, w):
                    raise RuntimeError(f"{where}: integer output differs "
                                       "from the plain version's")
                continue
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{where}: non-finite kernel output")
            diff = (g - w).abs()
            abs_err = max(abs_err, float(diff.max()))
            rel_err = max(rel_err, float(
                (diff / w.abs().clamp(min=ATOL)).max()))
            w_max = float(w.abs().max())
            norm_err = max(norm_err, float(diff.max()) / max(w_max, 1e-30))
            atol = ATOL * (w_max if scaled else 1.0)
            if not torch.allclose(g, w, rtol=RTOL, atol=atol):
                raise RuntimeError(
                    f"{where} disagrees with its plain version: max abs "
                    f"err {float(diff.max()):.3g} (atol {atol:.3g})")
        ms = cuda_ms(lambda: wrapper(*inputs), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*inputs), plain_reps, warmup=1)
        if bound is None:
            t_bytes, t_ops, real = kernel_bound(inputs,
                                                concat=len(got) == 2)
        else:
            t_bytes, t_ops, real = bound(inputs)
        lay = inputs[0]
        out = dict(
            call=i, layout=layout, d=rec["d"], tile_e=lay.tile_e,
            blocks=lay.num_blocks, slots=int(lay.slot_src.numel()),
            real_slots=real, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            max_abs_err=abs_err, max_rel_err=rel_err,
            max_err_over_max_abs=norm_err, library_ms=None,
        )
        if library is not None:
            lib_call = library(inputs)
            lib = lib_call()
            if not torch.allclose(lib, want[0], rtol=RTOL,
                                  atol=ATOL * float(want[0].abs().max())):
                raise RuntimeError(f"{where}: the library call disagrees "
                                   "with the plain version")
            out["library_ms"] = cuda_ms(lib_call, KERNEL_REPS)
            del lib
        records.append(out)
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


# ---------------------------------------------------------- training phases


def train_setup(data: dict, cfg):
    """The training graph, adjacency, seeded model, optimizer and dropout
    generator of ``train_ktgnn`` on the card."""
    import torch

    from bridged_gnn_tpu_torch.train.optim import make_optimizer
    from bridged_gnn_tpu_torch.train.stage2 import (
        build_model,
        prepare_stage2_graph,
    )

    g, adj = prepare_stage2_graph(data, cfg, "cuda")
    model = build_model(cfg, g.num_classes, g.num_features, "cuda")
    opt, _ = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                            cfg.use_scheduler, cfg.step_size, cfg.gamma)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    return g, adj, model, opt, gen


def layouts_of(adj):
    return ([adj.fast_fn.lay_dst] if adj.fast_fn is not None
            else [t.lay_dst for t in adj.tiered_fn.tiers])


def check_backward(name, data, cfg, tiered: bool):
    """Phase 7 on one graph: record the kernel launches of one training
    step, replay every backward and sender-reduce call against its plain
    version (and the reduce against ``index_add_``), then run one whole
    backward twice from the same dropout state and require bit-identical
    gradients."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train.stage2 import stage2_loss, train_step

    g, adj, model, opt, gen = train_setup(data, cfg)
    if (adj.tiered_fn is not None) != tiered:
        raise RuntimeError(f"{name}: expected tiered={tiered} layouts")
    layouts = layouts_of(adj)
    state = gen.get_state()

    def grads():
        gen.set_state(state)
        model.zero_grad(set_to_none=True)
        loss, _ = stage2_loss(model, g, adj, cfg.Lambda, gen)
        loss.backward()
        return [p.grad.clone() for p in model.parameters()]

    first, second = grads(), grads()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    if not same:
        raise RuntimeError(f"{name}: two backward runs gave different "
                           "gradients")
    del first, second
    fwd, bwd, bwd_plain = (
        (fk.attention_fwd, fk.attention_bwd, fk.attention_bwd_plain)
        if tiered else (fk.attention_sel_fwd, fk.attention_sel_bwd,
                        fk.attention_sel_bwd_plain))
    recs = record_run(
        lambda: train_step(model, g, adj, opt, cfg.Lambda, gen),
        (fwd.__name__, bwd.__name__, "slot_reduce"))
    calls = {n: [r for r in recs if r["name"] == n]
             for n in (bwd.__name__, "slot_reduce")}
    # the recorded inputs are the step's activations: replay without
    # recording autograd
    with torch.no_grad():
        out = {
            bwd.__name__: check_kernel(
                bwd.__name__, bwd, bwd_plain, calls[bwd.__name__], layouts,
                bound=lambda inputs: bwd_bound(inputs, concat=tiered),
                scaled=True, plain_reps=PLAIN_REPS),
            "slot_reduce": check_kernel(
                "slot_reduce", fk.slot_reduce, fk.slot_reduce_plain,
                calls["slot_reduce"], layouts, bound=reduce_bound,
                scaled=True, plain_reps=PLAIN_REPS,
                library=reduce_library),
        }
    del recs, calls
    return out, dict(graph=name, layouts=len(layouts),
                     bit_identical_grads=same,
                     params=len(list(model.parameters())))


def train_phase(name, data, cfg, tiered: bool, n_layouts: int,
                num_classes: int):
    """Phases 8 and 9: ``train_ktgnn`` on the card with CUDA events around
    every kernel launch; asserts each kernel's launches per epoch by
    width, finite losses and a last-epoch loss below the first."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if tiered
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    e, lays = cfg.num_epoch, n_layouts
    # per epoch and layout: the conv at HIDDEN and the three heads at the
    # number of classes, in the train step's forward and backward and in
    # the eval forward
    want = {fwd: {HIDDEN: 2 * e * lays, num_classes: 6 * e * lays},
            bwd: {HIDDEN: e * lays, num_classes: 3 * e * lays},
            fk.slot_reduce: {HIDDEN: e * lays, num_classes: 3 * e * lays}}
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    with fk.record_launches() as recs:
        res = train_ktgnn(data, cfg, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    for fn in fk.KERNEL_WRAPPERS:
        if fn.launches_by_d != want.get(fn, {}):
            raise RuntimeError(
                f"{name}: {fn.__name__} launched {fn.launches_by_d} by width"
                f" in {e} epochs on {lays} layout(s); expected "
                f"{want.get(fn, {})}")
    kernel_ms = {fn.__name__: sum(r["start"].elapsed_time(r["stop"])
                                  for r in recs if r["name"] == fn.__name__)
                 / e for fn in want}
    losses = [h["loss"] for h in res["history"]]
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{name}: losses {losses}")
    return dict(
        phase=name, epochs=e, layouts=lays, edges=int(res["num_edges"]),
        launches={fn.__name__: fn.launches for fn in want},
        launches_per_epoch_by_d={fn.__name__: {
            d: n // e for d, n in fn.launches_by_d.items()} for fn in want},
        epoch_s_median=res["throughput"]["p50_s"],
        epoch_s_mean=res["mean_epoch_time"], run_s=wall_s,
        kernel_ms_per_epoch=kernel_ms, losses=losses,
        best={k: v for k, v in res["best"].items() if k != "per_head"},
        per_head_test=res["best"].get("per_head"),
    )


def parity_phase(name, data, cfg):
    """Phase 10: the same seeded run on the card and on the CPU."""
    import torch

    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    card = train_ktgnn(data, cfg, device="cuda")
    t0 = time.perf_counter()
    cpu = train_ktgnn(data, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(card["history"], cpu["history"])
                   for k in ("loss", "loss_t2"))
    if loss_err > LOSS_RTOL:
        raise RuntimeError(f"{name}: card vs CPU losses differ by "
                           f"{loss_err:.3g} (relative) > {LOSS_RTOL}")
    w_err = 0.0
    for k, want in cpu["state_dict"].items():
        got = card["state_dict"][k]
        w_err = max(w_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL):
            raise RuntimeError(f"{name}: card vs CPU weights differ at {k}")
    return dict(phase=name, epochs=cfg.num_epoch,
                nodes=int(data["x"].shape[0]), max_rel_loss_err=loss_err,
                max_abs_weight_err=w_err, cpu_run_s=cpu_s,
                cpu_epoch_s=cpu["mean_epoch_time"],
                card_epoch_s=card["mean_epoch_time"],
                losses_card=[h["loss"] for h in card["history"]],
                losses_cpu=[h["loss"] for h in cpu["history"]])


def summary_row(name, source, replaces, recs, launches, ms, per, card):
    """One entry of the kernels line: ``ms`` from the main path's run,
    ``plain_ms``, ``bound_ms`` and ``library_ms`` summed over the replayed
    calls of one predict or training step."""
    bytes_ms = sum(r["bytes_ms"] for r in recs)
    ops_ms = sum(r["ops_ms"] for r in recs)
    lib = [r["library_ms"] for r in recs]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in recs),
        ms=ms, ms_replayed=sum(r["ms"] for r in recs),
        plain_ms=sum(r["plain_ms"] for r in recs),
        bound_ms=sum(r["bound_ms"] for r in recs),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None if None in lib else sum(lib), per=per, card=card,
    )


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
            record_run(pred.predict, ("attention_sel_fwd",)),
            [pred.adj.fast_fn.lay_dst])
        cat = check_kernel(
            "attention_fwd", fk.attention_fwd, fk.attention_fwd_plain,
            record_run(pred_t.predict, ("attention_fwd",)),
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
    n_tiers = len(pred_t.adj.tiered_fn.tiers)
    del pred_t

    # 6. HTTP
    fk.reset_launch_counts()
    http = http_phase(pred)
    http["sel_launches"] = fk.attention_sel_fwd.launches
    if http["sel_launches"] == 0:
        raise RuntimeError("HTTP phase launched no kernel")
    log(json.dumps(dict(phase="http", **http)))
    del pred

    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    # 7. backward kernels: each call of one training step on each graph,
    # replayed against the plain versions; bit-identical gradients
    cfg = Stage2Config(to_undirected=True)
    replay = {}
    for name, data, is_tiered in (("bench", bench, False),
                                  ("hub", hub, True)):
        t0 = time.perf_counter()
        recs, det = check_backward(name, data, cfg, is_tiered)
        for kname, rows in recs.items():
            replay[(kname, name)] = rows
            for r in rows:
                log(json.dumps(dict(kernel=kname, graph=name, card=card,
                                    **r)))
        log(json.dumps(dict(phase="backward_kernels", card=card,
                            s=time.perf_counter() - t0, **det)))
        torch.cuda.empty_cache()

    # 8. training, single layout
    c = BENCH["num_classes"]
    train_single = train_phase(
        "train_single", bench, Stage2Config(num_epoch=TRAIN_EPOCHS,
                                            to_undirected=True),
        tiered=False, n_layouts=1, num_classes=c)
    log(json.dumps(dict(card=card, **train_single)))

    # 9. training, degree tiers
    if n_tiers < 2:
        raise RuntimeError(f"hub graph gave {n_tiers} tier(s)")
    train_tiered = train_phase(
        "train_tiered", hub, Stage2Config(num_epoch=TIERED_EPOCHS,
                                          to_undirected=True),
        tiered=True, n_layouts=n_tiers, num_classes=c)
    log(json.dumps(dict(card=card, **train_tiered)))
    torch.cuda.empty_cache()

    # 10. card vs CPU, dropout 0, same seeded init
    small = (bench if PARITY_NODES == BENCH["n"]
             else make_benchmark_graph(**dict(BENCH, n=PARITY_NODES)))
    pcfg = Stage2Config(num_epoch=PARITY_EPOCHS, dropout=0.0,
                        to_undirected=True)
    for name, data in (("parity_single", small),
                       ("parity_tiered", hub_graph(small, BENCH["seed"]))):
        log(json.dumps(dict(card=card, **parity_phase(name, data, pcfg))))

    # summary, per kernel: its launches in its main-path phase and its
    # time inside that run (per predict for the forwards, per epoch for
    # the backwards), and, summed over the replayed calls of one predict
    # (phase 3) or one training step (phase 7), the plain version, the
    # bound and the library call
    fwd_src = "bridged_gnn_tpu_torch/csrc/attention_fwd.cu"
    bwd_src = "bridged_gnn_tpu_torch/csrc/attention_bwd.cu"
    kernels = [
        summary_row("attention_sel_fwd", fwd_src,
                    "bridged_gnn_tpu/ops/pallas_fused.py:501", sel,
                    single["launches"],
                    single["kernel_ms_per_predict_median"], "predict", card),
        summary_row("attention_fwd", fwd_src,
                    "bridged_gnn_tpu/ops/pallas_fused.py:168", cat,
                    tiered["launches"],
                    tiered["kernel_ms_per_predict_median"], "predict", card),
        summary_row("attention_sel_bwd", bwd_src,
                    "bridged_gnn_tpu/ops/pallas_fused.py:614",
                    replay[("attention_sel_bwd", "bench")],
                    train_single["launches"]["attention_sel_bwd"],
                    train_single["kernel_ms_per_epoch"]["attention_sel_bwd"],
                    "epoch", card),
        summary_row("attention_bwd", bwd_src,
                    "bridged_gnn_tpu/ops/pallas_fused.py:281",
                    replay[("attention_bwd", "hub")],
                    train_tiered["launches"]["attention_bwd"],
                    train_tiered["kernel_ms_per_epoch"]["attention_bwd"],
                    "epoch", card),
        summary_row("slot_reduce",
                    "bridged_gnn_tpu_torch/csrc/slot_reduce.cu",
                    "bridged_gnn_tpu/ops/pallas_padded.py:33",
                    replay[("slot_reduce", "bench")],
                    train_single["launches"]["slot_reduce"]
                    + train_tiered["launches"]["slot_reduce"],
                    train_single["kernel_ms_per_epoch"]["slot_reduce"],
                    "epoch", card),
    ]
    for row, phase in ((kernels[0], single), (kernels[1], tiered)):
        row["launches_per_predict_by_d"] = phase["launches_per_predict_by_d"]
    for row, phase, kname in ((kernels[0], train_single, "attention_sel_fwd"),
                              (kernels[1], train_tiered, "attention_fwd"),
                              (kernels[2], train_single, "attention_sel_bwd"),
                              (kernels[3], train_tiered, "attention_bwd"),
                              (kernels[4], train_single, "slot_reduce")):
        row["launches_per_epoch_by_d"] = \
            phase["launches_per_epoch_by_d"][kname]
    # the reduce on the tiered graph, beside the single layout's numbers
    hub_rows = replay[("slot_reduce", "hub")]
    kernels[4].update(
        ms_tiered=train_tiered["kernel_ms_per_epoch"]["slot_reduce"],
        plain_ms_tiered=sum(r["plain_ms"] for r in hub_rows),
        bound_ms_tiered=sum(r["bound_ms"] for r in hub_rows),
        library_ms_tiered=sum(r["library_ms"] for r in hub_rows))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
