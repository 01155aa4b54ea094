"""Drive the PyTorch/CUDA port's KT-GNN serving and training paths and its
stage-2 model zoo on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and torch's device name;
2. build the CUDA kernels from ``bridged_gnn_tpu_torch/csrc`` (nvcc);
3. kernel phase: one predict on each graph records its kernel launches
   with their inputs (the main path's real layouts and tensors, D=64 and
   D=8); each recorded call is replayed through the kernel and its plain
   PyTorch version on the card (f32, rtol and atol 1e-4), launched twice
   to give bit-identical outputs, timed with CUDA events, and set beside
   its bound counted from its own inputs;
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
   cancel), twice to give bit-identical outputs,
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
10. one traced run per graph: ``train_ktgnn`` for 2 epochs under
   ``torch.profiler`` (CPU and CUDA activities), each epoch marked from
   the epoch timer's opening synchronize to the work's end; for the last
   epoch one line with the top 15 device operations by device time, the
   hand-written kernels' share of the epoch and the device's busy share
   (the union of device-op intervals over the epoch's wall time);
11. card vs CPU: 1 epoch at dropout 0 from the same seeded init on the
   card and on the CPU (plain versions), on each graph; per-epoch losses
   within rtol 1e-4, final weights and BN statistics within rtol 1e-3 and
   atol 1e-5;
12. heavy rows on a single layout: the "lead graph" (the bench graph with
   every 10th edge's destination redrawn from the 1,024 block-leading ids
   0, 128, ..., 131072 − 128), where the skew rule keeps one layout but
   1,024 rows exceed the heavy bound; the selective forward calls of one
   predict replayed as in phase 3, their count of heavy rows printed;
13. wide widths: each of the five kernels at D = 257, 512 and 1030 (past
   the 256 columns a lane group holds) on the bench graph's layout with
   seeded random tables, one call each against its plain version on the
   card (forwards at rtol and atol 1e-4; backwards and reduce at rtol
   1e-4, atol 1e-4 × the output's largest magnitude), launched twice to
   give bit-identical outputs, compared in row chunks (a 1030-wide ``dm``
   is 19 GB), and timed;
14. scan mode, on each graph: ``train_ktgnn`` with ``scan_epochs=5`` for
   12 epochs (chunks of 5, 5 and 2; StepLR every 4 epochs, so the rate
   falls inside a chunk; ``check_numerics`` on): two eager epochs, one
   CUDA graph capture, 10 replays. Against the same run as a per-epoch
   loop (whose Adam takes a float rate and is not capturable): losses
   within rtol 1e-4, the best epoch equal, and each score equal or, where
   it differs, the loop's with one or two named nodes of its split, each
   at an argmax tie (its two largest log-probabilities in the loop within
   TIE_MARGIN), moved to their second class; each replay
   launches per layout 8 forwards, 4 backwards and 4 reduces (1×D=64,
   3×D=8 per pass), and the wrappers count only the eager epochs and the
   capture; the epoch medians of both modes on the host clock and the
   scan run's peak device memory. The scan run once more under
   ``torch.profiler``: per epoch of its second chunk (five replays), the
   device busy share as phase 10 computes it, the top 15 device
   operations and the hand-written kernels' share;
15. bf16 messages (``message_dtype="bfloat16"``), on each graph: the
   seeded model with bf16 and with f32 messages behind two predictors;
   one bf16 predict's kernel calls replayed against their plain versions
   (bf16 tables) as in phase 3, then, counts at 0, a bf16 serving run
   whose every launch is the kernel's bf16 instantiation, and predict
   ×10 of each predictor in turns on the host clock (medians; the bf16
   heads within 0.15 of the f32 heads, argmax agreement over 0.98); on
   the bench layout the five kernels at D = 257 and 512 in bf16 as in
   phase 13; phase 7 on a bf16 model under precision "default" (bf16
   backward and reduce calls replayed, bit-identical gradients, plain and
   lean peaks); then the production setting, ``Stage2Config(
   message_dtype="bfloat16", matmul_precision="default",
   scan_epochs=5)`` for 12 epochs with ``check_numerics``, counts at 0:
   each replay launches the bf16 instantiations only (8 forwards, 4
   backwards, 4 reduces per layout), every loss finite, the first within
   two bf16 ulps (2·2^-7, relative) of the same run in f32
   (``message_dtype`` and ``matmul_precision`` None), which runs beside
   it; and one bf16 loop epoch with CUDA events around every launch,
   whose losses equal the scan run's first epoch's (rtol 1e-4). A bf16
   output (the backwards' ``dm``) is held to its plain version at rtol
   1e-4 + 2^-7: kernel and plain version each round an f32 value once,
   and two values within 1e-4 may round one bf16 ulp apart;
16. the model zoo: the reference's ``--no_dtc`` recipe (GraphSAGE, 2
   layers, hidden 64, no scheduler; the bench graph without self loops,
   one 256-row-block layout) runs every aggregation through the padded
   SpMM kernel (``gather_reduce``): the kernel calls of one epoch (two
   forwards at D=128 and D=64 in the step, the D=64 transposed SpMM of
   its backward, two in the eval) replayed against the plain version at
   the reduce's tolerance, launched twice for bit-identical outputs,
   timed beside their bound, ``torch.sparse.mm`` on a CSR tensor of the
   same weights and ``index_add_`` of the gathered rows, each with the
   column panels the kernel walks on this card's L2, the bytes of rows it
   gathers and their rate (GCN's calls at the classes' width, D=8, the
   same way), and the first D=128 call launched again at
   forced panel widths 4, 32, 64 and 128 (4 and, on lane groups of 4 to
   16, 8 entries in flight), each bit-identical to the wrapper's; counts
   at 0, 10 loop epochs on the bench graph (2 launches at D=128 and 3 at
   D=64 per epoch, no other kernel) with CUDA events around every launch, 2
   traced, 12 in scan mode (losses within rtol 1e-4 of the loop's, each
   replay launching as a loop epoch) and 5 on the hub graph (once per
   tier); the kernel at D = 257, 512 and 1030, weighted and unweighted,
   forward and transposed, as in phase 13; card against CPU for
   GraphSAGE and GCN (2 epochs, dropout 0: losses within rtol 1e-4,
   weights as phase 11 or, where they part, explained by a ReLU input
   within 1e-6 of 0 whose sign differs between the two, listed in
   ``ties``: only the first conv's parameters of the tied output columns
   may then part, each element by at most Adam's 2·lr per epoch, and
   every other weight holds phase 11's tolerances); every other CLI model and KTGNN_noDTC (once with
   ``root_weight``) for 2 epochs at hidden 64, each launching exactly the
   kernels its aggregations imply (APPNP 10 SpMMs per pass, GAT, GATv2,
   DeeperGCN and MLP none); and the training CLI with ``--no_dtc`` on a
   ``.dat`` the phase writes, which must train GraphSAGE without the
   scheduler and save ``model_GraphSAGE_bench_best.pkl``.

Phase 7 also runs one ``memory_policy="lean"`` step per graph (the
embedding conv recomputed in the backward) against the plain step: loss
at rtol 1e-4, gradients at the backward tolerance, the forward launched
once more per layout, and both steps' peak device memory.

In the ``{"kernels": [...]}`` line the forwards' launch counts are those
of the serving phases and their ``ms`` the kernel's time per predict
inside the serving run (``per``: "predict"); the backwards' counts are
those of the training phases and their ``ms`` the kernel's time per
epoch inside the training run (``per``: "epoch"). Each count is set to 0
just before its phase. ``plain_ms``, ``bound_ms`` and ``library_ms`` sum
the replayed calls of one predict or one training step; a replayed call's
time counts the wrapper's host work (``ms_replayed``) and, apart, only the
card's (``ms_replayed_device``, ``library_device_ms``). Each row also
lists its wide-width calls (``wide``, phase 13), and the selective
forward's row its calls on the lead graph (``lead_layout``, phase 12).
Phase 15 adds one row per kernel's bf16 instantiation, named after its C
entry point (``attention_sel_fwd_bf16``, ...; ``dtype`` "bfloat16", the
f32 rows "float32"): the forwards' launches and in-run ms per predict
from the bf16 serving runs, the backwards' and the reduce's launches from
the production training runs and their in-run ms per epoch from the bf16
loop epoch, plain, bound (bf16 row bytes) and library from the replayed
calls, and the bf16 wide calls. Phase 16 adds ``gather_reduce``: its
launches and in-run ms per epoch of the ``--no_dtc`` bench loop, plain,
bound and library (``torch.sparse.mm``; ``index_add_`` beside it) summed
over one epoch's replayed calls, the hub loop's ms and the wide calls.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from unittest import mock

import numpy as np

BENCH = dict(n=131072, avg_degree=16, dim=128, num_classes=8, seed=0)
HIDDEN = 64              # Stage2Config().hidden: the conv's width
HUB_NODES = 256          # hub destinations of the tiered graph
LEAD_BLOCK = 128         # the serving layout's node_block: the lead graph's
                         # hubs are the first rows of its blocks
WIDE_DS = (257, 512, 1030)   # phase 13: past the lane groups' 256 columns
WIDE_REPS = 5            # phase 13: timed calls (a 1030-wide backward moves
                         # ~60 GB)
WIDE_CHUNK = 1 << 26     # phase 13: elements compared at a time
RTOL = ATOL = 1e-4       # kernel vs plain version, f32
BF16_ULP = 2.0 ** -7     # one bf16 ulp, relative (8 significant bits): a
                         # bf16 dm, which kernel and plain version each
                         # round once from f32 values within RTOL, may land
                         # one ulp apart, so it is compared at rtol
                         # RTOL + BF16_ULP
LOGPROB_ATOL = 1e-4      # card vs CPU log-probabilities
LOSS_RTOL = 1e-4         # card vs CPU training losses
WEIGHT_RTOL, WEIGHT_ATOL = 1e-3, 1e-5   # card vs CPU weights after training
KERNEL_REPS = 25
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock: holds the card while
                           # the host enqueues KERNEL_REPS calls (up to
                           # ~0.4 ms of host work each; 2 ms let the host's
                           # gaps into short calls' device times)
PLAIN_REPS = 20          # the backward phase's plain versions
PREDICT_REPS = 10
TRAIN_EPOCHS = 10        # phase 8, single layout
TIERED_EPOCHS = 5        # phase 9
TRACE_EPOCHS = 2         # phase 10
TRACE_TOP = 15           # device operations listed per traced epoch
PARITY_EPOCHS = 2        # phase 11 (the CPU side takes ~30 s an epoch)
SCAN_EPOCHS = 12         # phase 14: chunks of 5, 5 and 2 epochs
SCAN_CHUNK = 5
SCAN_STEP_SIZE = 4       # StepLR: the rate falls at epochs 5 and 9
TIE_MARGIN = 1e-4        # phase 14: an argmax tie, in log-probability
TIE_NODES = 40           # phase 14: the closest calls searched for a tie
PARITY_NODES = BENCH["n"]   # phase 11 graph size
BF16_WIDE_DS = (257, 512)   # phase 15: the wide path in bf16
BF16_EPOCHS = 12         # phase 15: the production setting's run per graph
BF16_CHUNK = 5           # phase 15: scan_epochs of the production setting
ZOO_EPOCHS = 10          # phase 16: the --no_dtc recipe, bench graph, loop
ZOO_SCAN_EPOCHS = 12     # phase 16: the same in scan mode, chunks of 5
ZOO_SCAN_CHUNK = 5
ZOO_HUB_EPOCHS = 5       # phase 16: hub graph
ZOO_OTHER_EPOCHS = 2     # phase 16: every other model
ZOO_CLI_EPOCHS = 3       # phase 16: the CLI on a .dat
PANEL_CHECK_D = 128      # phase 16: the replayed call held bit-identical at
PANEL_CHECK_WIDTHS = (4, 32, 64, 128)   # these forced panel widths
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


def lead_graph(data: dict, seed: int) -> dict:
    """The bench graph with the destination of every 10th edge (before
    to_undirected) replaced by one of the block-leading ids 0, LEAD_BLOCK,
    2·LEAD_BLOCK, ...: every block of the serving layout gets one heavy
    row, too few slots per block for the skew rule to pick tiers."""
    rng = np.random.default_rng(seed)
    ei = data["edge_index"].copy()
    n_lead = data["x"].shape[0] // LEAD_BLOCK
    ei[1, ::10] = rng.integers(0, n_lead, size=ei[1, ::10].shape[0]) \
        * LEAD_BLOCK
    return dict(data, edge_index=ei)


def seeded_model(num_classes: int, in_channels: int, seed: int,
                 msg_dtype=None):
    """KT-GNN at the serving defaults (Stage2Config: 2 layers, hidden 64,
    batch norm, no root weight) with weights and BN statistics drawn from
    one seeded generator, so batch norm is not the identity; its messages
    in ``msg_dtype`` (the same weights for every dtype)."""
    import torch

    from bridged_gnn_tpu_torch.nn.common import MaskedBatchNorm
    from bridged_gnn_tpu_torch.nn.ktgnn import KTGNN
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    cfg = Stage2Config()
    if cfg.hidden != HIDDEN:
        raise RuntimeError(f"Stage2Config().hidden is {cfg.hidden}, "
                           f"not {HIDDEN}")
    gen = torch.Generator().manual_seed(seed)
    # no msg_dtype argument for f32: tools/torch_kernel_replay.py builds
    # this model in checkouts older than bf16 messages
    extra = {} if msg_dtype is None else dict(msg_dtype=msg_dtype)
    model = KTGNN(num_classes, in_channels, layer_num=cfg.num_layer,
                  hidden=cfg.hidden, dropout=cfg.dropout, use_bn=cfg.use_bn,
                  generator=gen, **extra)
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


def cuda_device_ms(fn, reps: int) -> float:
    """Device time per call: ``reps`` calls enqueued behind a sleep kernel
    that keeps the card busy while the host enqueues them, then run back
    to back between two events, so the wrapper's host work (which
    :func:`cuda_ms` counts, the card idling meanwhile) is left out."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_bound(inputs, concat: bool):
    """Least time for one call on these inputs: the bytes it must move
    over the HBM rate and its f32 operations over the f32 rate.

    Bytes count each input once, as far as this call's data needs it: the
    sender index of every real slot, the slot range of every row, the
    sender rows the slots reach (distinct (sender, branch) pairs for the
    selective kernel, distinct senders in both tables for the
    concatenated one), the own row and flag of every destination with a
    real slot, and the two logit vectors; each output is written once.
    Table and own rows count in the tables' dtype (f32 or bf16), the
    rest in f32. Returns the byte time, the operation time and the real
    slot count."""
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
    f32, msg = 4, u1.element_size()
    read = (real * 4 + lay.dst_ranges.numel() * 4 + rows_read * d * msg
            + dst_read * (d * msg + 1) + 2 * d * f32)
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
    only), the own row, output cotangent, forward output, flag (and,
    selective, den) of every destination with a real slot, the per-slot
    weight (ex or α) of every real slot and the two logit vectors; the
    outputs dm (every slot, D wide), the slots' branch flags (one byte
    each), dud and da are written once. Table rows, own rows and dm count
    in the tables' dtype (f32 or bf16), the rest in f32. Operations: 13·D
    per real slot (dα, leaky-relu and its gate, dz, dm, dud and da) and
    2·D per destination with a real slot (S_v = dout · out)."""
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
    f32, msg = 4, u1.element_size()
    read = (real * 4 + lay.dst_ranges.numel() * 4 + rows_read * d * msg
            + dst_read * (d * msg + 2 * d * f32 + 1 + (0 if concat else f32))
            + real * f32 + 2 * d * f32)
    written = (n_slots * (d * msg + 1) + n_out * d * f32 + 2 * d * f32)
    flops = real * d * 13 + dst_read * d * 2
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOPS_PER_S * 1e3, real)


def reduce_bound(inputs):
    """Least time for one sender-keyed reduce: the CSR ranges and slot
    ids, one W-wide row (in vals' dtype) and one branch flag per real
    slot read, the f32 [n_rows, 2W] output written once; one add per
    element of every row read."""
    lay, vals, n_rows, _ = inputs
    real, w = int(lay.src_slots.numel()), vals.shape[1]
    read = (lay.src_ranges.numel() * 4 + real * 4
            + real * w * vals.element_size() + real)
    written = n_rows * w * 2 * 4
    return (((read + written) / HBM_BYTES_PER_S * 1e3,
             real * w / F32_FLOPS_PER_S * 1e3, real))


def reduce_library(inputs):
    """The one PyTorch call that computes the sender-keyed reduce on the
    same inputs: ``index_add_`` of every slot row into its sender's row
    (pad and masked slots carry zero rows), the branch split folded into
    the index. Timed as a yardstick only; the port never calls it. bf16
    rows are widened to f32 first, outside the timed call: the f32
    accumulator of ``index_add_`` takes only f32 rows."""
    import torch

    lay, vals, n_rows, branch = inputs
    vals = vals.float()
    sender = lay.slot_src.long().clamp(min=0)
    w = vals.shape[1]
    if branch is None:  # older checkouts' branch-less reduce (replay tool)
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
    ``ms`` is :func:`cuda_ms` (the wrapper's host work included) and
    ``device_ms`` :func:`cuda_device_ms`; the library call, where given,
    gets both.

    Integer outputs must be equal. Float outputs must agree within rtol
    ``RTOL`` (``RTOL + BF16_ULP`` for a bf16 output) and atol ``ATOL``,
    times the output's largest magnitude when ``scaled``. ``bound(inputs)`` gives the byte time, the
    operation time and the real slot count (default: the forwards'
    :func:`kernel_bound`); ``library(inputs)``, where given, the one
    PyTorch call computing the same function, which is checked and
    timed beside the kernel."""
    import torch

    records = []
    for i, rec in enumerate(calls):
        inputs = rec["inputs"]
        got = _outs(wrapper(*inputs))
        again = _outs(wrapper(*inputs))
        torch.cuda.synchronize()
        want = _outs(plain(*inputs))
        layout = next(j for j, lay in enumerate(layouts) if lay is inputs[0])
        where = f"{name} at D={rec['d']}, layout {layout}"
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise RuntimeError(f"{where}: two launches on the same inputs "
                               "differ")
        del again
        abs_err = rel_err = norm_err = 0.0
        for g, w in zip(got, want):
            if not g.is_floating_point():
                if not torch.equal(g, w):
                    raise RuntimeError(f"{where}: integer output differs "
                                       "from the plain version's")
                continue
            rtol = RTOL + (BF16_ULP if g.dtype == torch.bfloat16 else 0.0)
            g, w = g.float(), w.float()
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{where}: non-finite kernel output")
            diff = (g - w).abs()
            abs_err = max(abs_err, float(diff.max()))
            rel_err = max(rel_err, float(
                (diff / w.abs().clamp(min=ATOL)).max()))
            w_max = float(w.abs().max())
            norm_err = max(norm_err, float(diff.max()) / max(w_max, 1e-30))
            atol = ATOL * (w_max if scaled else 1.0)
            if not torch.allclose(g, w, rtol=rtol, atol=atol):
                raise RuntimeError(
                    f"{where} disagrees with its plain version: max abs "
                    f"err {float(diff.max()):.3g} (atol {atol:.3g})")
        ms = cuda_ms(lambda: wrapper(*inputs), KERNEL_REPS)
        device_ms = cuda_device_ms(lambda: wrapper(*inputs), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*inputs), plain_reps, warmup=1)
        if bound is None:
            t_bytes, t_ops, real = kernel_bound(inputs,
                                                concat=len(got) == 2)
        else:
            t_bytes, t_ops, real = bound(inputs)
        lay = inputs[0]
        out = dict(
            call=i, layout=layout, d=rec["d"],
            dtype=str(rec["dtype"]).replace("torch.", ""), tile_e=lay.tile_e,
            blocks=lay.num_blocks, slots=int(lay.slot_src.numel()),
            real_slots=real, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
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
            out["library_device_ms"] = cuda_device_ms(lib_call, KERNEL_REPS)
            del lib
        records.append(out)
        del got, want
    return records


def _row_chunks(t):
    """Row slices of ``t`` holding about WIDE_CHUNK elements each."""
    per = max(1, WIDE_CHUNK // max(1, t[0].numel()))
    return [slice(i, i + per) for i in range(0, t.shape[0], per)]


def _compare_chunked(where, got, again, want, scaled):
    """Phase 13's comparison, in row chunks: ``got`` and ``again`` (two
    launches) equal, ``got`` finite and within rtol ``RTOL`` (``RTOL +
    BF16_ULP`` for bf16) and atol ``ATOL`` (times ``want``'s largest
    magnitude when ``scaled``) of the plain ``want``, integers equal.
    Returns (max abs err, that over the largest magnitude)."""
    import torch

    parts = _row_chunks(got)
    if not all(torch.equal(got[p], again[p]) for p in parts):
        raise RuntimeError(f"{where}: two launches on the same inputs differ")
    if not got.is_floating_point():
        if not all(torch.equal(got[p], want[p]) for p in parts):
            raise RuntimeError(f"{where}: integer output differs from the "
                               "plain version's")
        return 0.0, 0.0
    w_max = max(float(want[p].abs().max()) for p in parts)
    atol = ATOL * (w_max if scaled else 1.0)
    rtol = RTOL + (BF16_ULP if got.dtype == torch.bfloat16 else 0.0)
    err = 0.0
    for p in parts:
        g, w = got[p].float(), want[p].float()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"{where}: non-finite kernel output")
        err = max(err, float((g - w).abs().max()))
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            raise RuntimeError(f"{where} disagrees with its plain version: "
                               f"max abs err {err:.3g} (atol {atol:.3g})")
    return err, err / max(w_max, 1e-30)


def check_wide(name, wrapper, plain, inputs, scaled, bound, library=None):
    """Phase 13, one call: the kernel launched twice and its plain version
    on the same inputs, compared by :func:`_compare_chunked`, then timed
    (``WIDE_REPS`` calls; the plain version twice). Returns the kernel's
    outputs and the call's record."""
    import torch

    got = _outs(wrapper(*inputs))
    again = _outs(wrapper(*inputs))
    torch.cuda.synchronize()
    want = _outs(plain(*inputs))
    d = inputs[1].shape[1]
    where = f"{name} at D={d}"
    errs = [_compare_chunked(f"{where}, output {i}", g, a, w, scaled)
            for i, (g, a, w) in enumerate(zip(got, again, want))]
    del again, want
    torch.cuda.empty_cache()
    lib_ms = lib_device_ms = None
    if library is not None:
        call = library(inputs)
        if not torch.allclose(call(), got[0].float(), rtol=RTOL,
                              atol=ATOL * float(got[0].abs().max())):
            raise RuntimeError(f"{where}: the library call disagrees with "
                               "the kernel")
        lib_ms = cuda_ms(call, WIDE_REPS, warmup=1)
        lib_device_ms = cuda_device_ms(call, WIDE_REPS)
    t_bytes, t_ops, real = bound(inputs)
    rec = dict(
        kernel=name, d=d, dtype=str(inputs[1].dtype).replace("torch.", ""),
        real_slots=real,
        ms=cuda_ms(lambda: wrapper(*inputs), WIDE_REPS, warmup=1),
        device_ms=cuda_device_ms(lambda: wrapper(*inputs), WIDE_REPS),
        plain_ms=cuda_ms(lambda: plain(*inputs), 2, warmup=1),
        bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        max_abs_err=max(e for e, _ in errs),
        max_err_over_max_abs=max(e for _, e in errs),
        library_ms=lib_ms, library_device_ms=lib_device_ms)
    torch.cuda.empty_cache()
    return got, rec


def wide_phase(lay, central, seed, ds=WIDE_DS, dtype=None):
    """Phase 13 (and 15 in bf16): the five kernels at each of ``ds`` on
    one layout, with seeded random tables (in ``dtype``, f32 by default);
    each backward takes the residuals of its forward's kernel call, the
    reduce the selective backward's dm and branch. Returns the records by
    kernel name."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    n = central.shape[0]
    recs = {}

    def check(name, *args):
        got, rec = check_wide(name, getattr(fk, name),
                              getattr(fk, name + "_plain"), *args)
        recs.setdefault(name, []).append(rec)
        log(json.dumps(dict(phase="wide", **rec)))
        return got

    for d in ds:
        gen = torch.Generator(device=central.device).manual_seed(seed + d)

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=central.device)

        def table(*shape):
            t = rnd(*shape)
            return t if dtype is None else t.to(dtype)

        base = (table(n, d), table(n, d), table(n, d), central, rnd(d),
                rnd(d))
        dout = rnd(n, d)
        out, ex, den = check("attention_sel_fwd", (lay, *base, 0.1), False,
                             lambda i: kernel_bound(i, concat=False))
        dm, _, _, slot_c = check(
            "attention_sel_bwd", (lay, *base, ex, den, out, dout, 0.1), True,
            lambda i: bwd_bound(i, concat=False))
        del out, ex, den
        check("slot_reduce", (lay, dm, n, slot_c), True, reduce_bound,
              reduce_library)
        del dm, slot_c
        torch.cuda.empty_cache()
        out2, alpha = check("attention_fwd", (lay, *base, 0.1), False,
                            lambda i: kernel_bound(i, concat=True))
        out = torch.where(central[:, None], out2[:, :d], out2[:, d:])
        del out2
        check("attention_bwd", (lay, *base, alpha, out, dout, 0.1), True,
              lambda i: bwd_bound(i, concat=True))
        del base, dout, out, alpha
        torch.cuda.empty_cache()
    return recs


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
    lays = [t.lay_dst for t in tiers] if tiers else [pred.adj.fast_fn.lay_dst]
    return dict(
        phase=name, layouts=n_layouts,
        tile_e=[lay.tile_e for lay in lays],
        heavy_rows=[int(lay.dst_heavy.numel()) for lay in lays],
        heavy_senders=[int(lay.src_heavy.numel()) for lay in lays],
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
    memory = lean_step(name, g, adj, model, cfg, gen, state)
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
                     params=len(list(model.parameters())), **memory)


def lean_step(name, g, adj, model, cfg, gen, state) -> dict:
    """Phase 7's ``memory_policy="lean"`` step: the same step with the
    embedding conv recomputed in the backward, from the same weights and
    dropout state, against the plain step (loss at rtol 1e-4, gradients
    at the backward tolerance); each step's peak device memory, and the
    sizes that set it."""
    import torch

    from bridged_gnn_tpu_torch.train.stage2 import stage2_loss

    def step(m):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen.set_state(state)
        m.zero_grad(set_to_none=True)
        loss, _ = stage2_loss(m, g, adj, cfg.Lambda, gen)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out = (loss.detach(), [p.grad.clone() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return out, resident, peak

    lean = copy.deepcopy(model)
    lean.remat = True
    fwd = [_forward_launches()]
    (loss_p, grads_p), resident, peak_plain = step(model)
    fwd.append(_forward_launches())
    (loss_l, grads_l), _, peak_lean = step(lean)
    fwd.append(_forward_launches())
    del lean
    lays = layouts_of(adj)
    plain_fwd, lean_fwd = fwd[1] - fwd[0], fwd[2] - fwd[1]
    if lean_fwd != plain_fwd + len(lays):
        raise RuntimeError(f"{name}: the lean step launched {lean_fwd} "
                           f"forwards, the plain {plain_fwd}: the conv "
                           "did not run again in the backward")
    if abs(float(loss_l) - float(loss_p)) > LOSS_RTOL * abs(float(loss_p)):
        raise RuntimeError(f"{name}: lean loss {float(loss_l)} against "
                           f"plain {float(loss_p)}")
    grad_err = 0.0
    for a, b in zip(grads_l, grads_p):
        scale = float(b.abs().max())
        grad_err = max(grad_err, float((a - b).abs().max()) / max(scale,
                                                                  1e-30))
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL * scale):
            raise RuntimeError(f"{name}: lean gradients differ from plain")
    return dict(
        resident_bytes=resident, plain_peak_bytes=peak_plain,
        lean_peak_bytes=peak_lean,
        plain_step_bytes=peak_plain - resident,
        lean_step_bytes=peak_lean - resident,
        plain_forward_launches=plain_fwd, lean_forward_launches=lean_fwd,
        lean_max_grad_err_over_max_abs=grad_err,
        slots=sum(int(lay.slot_src.shape[0]) for lay in lays),
        nodes_padded=g.num_nodes_padded, features=g.num_features,
        hidden=cfg.hidden)


def _forward_launches() -> int:
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    return fk.attention_sel_fwd.launches + fk.attention_fwd.launches


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


_HAND_KERNEL = re.compile(
    r"attention_\w*_kernel|slot_reduce_kernel|gather_reduce_kernel")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_phase(name, data, cfg, window=-1, epochs=1) -> dict:
    """Phase 10 (and 14): ``train_ktgnn`` under ``torch.profiler`` with
    each epoch timer window marked (an epoch, or a scan chunk); reads the
    device operations of window ``window`` (the last by default), which
    holds ``epochs`` epochs, from the Chrome trace. Times and counts are
    per epoch. The mark opens after the timer's first synchronize and
    closes after a synchronize at the window's end, so the window's
    device work lies inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.utils.profiling import EpochTimer

    mark = "chip_smoke.epoch"
    timers = []

    class MarkedTimer(EpochTimer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            timers.append(self)

        def __enter__(self):
            super().__enter__()
            self._mark = record_function(mark)
            self._mark.__enter__()
            return self

        def __exit__(self, *exc):
            self._sync()
            self._mark.__exit__(*exc)
            return super().__exit__(*exc)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with mock.patch.object(stage2, "EpochTimer", MarkedTimer), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            stage2.train_ktgnn(data, cfg, device="cuda")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in (trace["traceEvents"] if isinstance(trace, dict)
                          else trace) if e.get("ph") == "X"]
    windows = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("name") == mark
                     and e.get("cat") != "gpu_user_annotation")
    want = (cfg.num_epoch if not cfg.scan_epochs
            else -(-cfg.num_epoch // cfg.scan_epochs))
    if len(windows) != want:
        raise RuntimeError(f"{name}: the trace marks {len(windows)} timer "
                           f"windows, not {want}")
    t0, t1 = windows[window]
    ops = []   # (name, start, end) of device ops inside the last epoch, µs
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if b > t0 and a < t1:
            ops.append((e["name"], max(a, t0), min(b, t1)))
    if not ops:
        raise RuntimeError(f"{name}: the traced epoch ran no device op")
    by_name = {}
    for op, a, b in ops:
        ms, n = by_name.get(op, (0.0, 0))
        by_name[op] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, t0
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall_ms = (t1 - t0) / 1e3
    hand = {op: v for op, v in by_name.items() if _HAND_KERNEL.search(op)}
    hand_ms = sum(ms for ms, _ in hand.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP]
    return dict(
        phase=name, epochs=cfg.num_epoch, epochs_in_window=epochs,
        epoch_ms_traced=wall_ms / epochs,
        epoch_ms_timer=[t * 1e3 for t in timers[0].times],
        device_ops=len(ops) / epochs,
        device_ms=sum(b - a for _, a, b in ops) / 1e3 / epochs,
        busy_ms=busy / 1e3 / epochs, busy_share=busy / 1e3 / wall_ms,
        hand_kernels_ms=hand_ms / epochs,
        hand_kernels_share=hand_ms / wall_ms,
        hand_kernel_launches=sum(n for _, n in hand.values()) / epochs,
        top=[dict(name=op[:120], ms=ms / epochs, count=n / epochs)
             for op, (ms, n) in top],
    )


def scan_phase(name, data, tiered: bool, n_layouts: int,
               num_classes: int) -> dict:
    """Phase 14 on one graph: ``train_ktgnn`` in scan mode (SCAN_EPOCHS
    epochs in chunks of SCAN_CHUNK, StepLR every SCAN_STEP_SIZE epochs so
    the rate falls inside a chunk, ``check_numerics`` on), the same run
    as a per-epoch loop, and the scan run once more under
    ``torch.profiler``, all on one prepared graph. Holds the scan run to
    the loop's losses (rtol LOSS_RTOL), best epoch and scores, and each
    replay to the per-epoch launches of phases 8-9."""
    import dataclasses

    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2

    cfg = stage2.Stage2Config(
        num_epoch=SCAN_EPOCHS, scan_epochs=SCAN_CHUNK,
        step_size=SCAN_STEP_SIZE, check_numerics=True, to_undirected=True)
    t0 = time.perf_counter()
    prepared = stage2.prepare_stage2_graph(data, cfg, "cuda")
    setup_s = time.perf_counter() - t0
    if len(layouts_of(prepared[1])) != n_layouts:
        raise RuntimeError(f"{name}: expected {n_layouts} layout(s)")
    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if tiered
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    lays = n_layouts
    want = {fwd.__name__: {HIDDEN: 2 * lays, num_classes: 6 * lays},
            bwd.__name__: {HIDDEN: lays, num_classes: 3 * lays},
            "slot_reduce": {HIDDEN: lays, num_classes: 3 * lays}}
    with mock.patch.object(stage2, "prepare_stage2_graph",
                           lambda *a, **k: prepared):
        fk.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scan = stage2.train_ktgnn(data, cfg, device="cuda")
        scan_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counted = fk.launch_counts()
        t0 = time.perf_counter()
        loop = stage2.train_ktgnn(data, dataclasses.replace(cfg,
                                                            scan_epochs=0),
                                  device="cuda")
        loop_s = time.perf_counter() - t0
        # the second chunk: five replays, after the capture
        traced = trace_phase(f"{name}_trace", data, cfg, window=1,
                             epochs=SCAN_CHUNK)
    loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(scan["history"], loop["history"],
                                   strict=True)
                   for k in ("loss", "loss_t2"))
    if not loss_err <= LOSS_RTOL:
        raise RuntimeError(f"{name}: scan vs loop losses differ by "
                           f"{loss_err:.3g} (relative) > {LOSS_RTOL}")
    if scan["best"]["epoch"] != loop["best"]["epoch"]:
        raise RuntimeError(f"{name}: best epoch {scan['best']['epoch']} "
                           f"(scan) against {loop['best']['epoch']} (loop)")
    score_diffs = [
        (a["epoch"], k, a[k], b[k])
        for a, b in zip(scan["history"], loop["history"])
        for k in ("train", "val", "test") if a[k] != b[k]]
    best_epoch = loop["best"]["epoch"]
    sb, lb = scan["best"], loop["best"]
    score_diffs += [(best_epoch, f"best_{k}", sb[k], lb[k])
                    for k in ("train", "val", "test") if sb[k] != lb[k]]
    score_diffs += [(best_epoch, k, sb["per_head"][k], lb["per_head"][k])
                    for k in ("source", "target", "target_hat")
                    if sb["per_head"][k] != lb["per_head"][k]]
    ties = []
    if score_diffs:
        with mock.patch.object(stage2, "prepare_stage2_graph",
                               lambda *a, **k: prepared):
            ties = name_ties(name, data, dataclasses.replace(
                cfg, scan_epochs=0), loop, score_diffs)
    info = scan["scan"]
    if (info["captures"], info["eager_epochs"], info["replays"]) != (
            1, stage2.WARMUP_EPOCHS, SCAN_EPOCHS - stage2.WARMUP_EPOCHS):
        raise RuntimeError(f"{name}: scan ran {info}")
    if info["launches_per_replay"] != want:
        raise RuntimeError(f"{name}: a replay launches "
                           f"{info['launches_per_replay']}, not {want}")
    counted_want = {n: {d: (info["eager_epochs"] + 1) * k
                        for d, k in by_d.items()} for n, by_d in want.items()}
    if {n: c for n, c in counted.items() if c} != counted_want:
        raise RuntimeError(f"{name}: the wrappers counted {counted}, not "
                           f"the eager epochs and the capture "
                           f"{counted_want}")
    if not traced["hand_kernel_launches"] == sum(
            sum(by_d.values()) for by_d in want.values()):
        raise RuntimeError(f"{name}: the traced chunk shows "
                           f"{traced['hand_kernel_launches']} hand-written "
                           "kernel launches per epoch")
    return dict(
        phase=name, epochs=SCAN_EPOCHS, chunk=SCAN_CHUNK,
        step_size=SCAN_STEP_SIZE, layouts=lays, setup_s=setup_s,
        **info, max_rel_loss_err=loss_err, scores_equal=not score_diffs,
        score_ties=ties,
        best_epoch=scan["best"]["epoch"],
        scan_epoch_s_median=scan["throughput"]["p50_s"],
        scan_epoch_s_mean=scan["mean_epoch_time"],
        scan_steady_epochs=scan["throughput"]["steady_steps"],
        scan_run_s=scan_s,
        loop_epoch_s_median=loop["throughput"]["p50_s"],
        loop_epoch_s_mean=loop["mean_epoch_time"], loop_run_s=loop_s,
        scan_max_memory_allocated=peak,
        losses_scan=[h["loss"] for h in scan["history"]],
        losses_loop=[h["loss"] for h in loop["history"]],
        trace=traced)


# ------------------------------------------------ phase 15: bf16 messages


def bf16_serve_phase(name, data, kernel, tiered: bool, n_layouts: int,
                     num_classes: int, reps: int):
    """Phase 15, serving on one graph: the seeded model with bf16 and with
    f32 messages (the same weights), each behind its own predictor on the
    card. One bf16 predict is recorded and its kernel calls replayed
    against their plain versions (as phase 3, bf16 tables). Then, the
    counts set to 0, the bf16 serving run: ``predict`` ×(1 + reps) and
    ×reps more with CUDA events around every launch, each launch of the
    kernel's bf16 instantiation (1 at HIDDEN and 3 at the classes per
    predict and layout). Last, ``predict`` of each predictor in turns,
    reps each, on the host clock; the bf16 heads against the f32 heads.
    Returns the replay records, the phase's record and the predictor's
    layout and destination flags (for the wide calls)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor

    t0 = time.perf_counter()
    preds = {dt: KTGNNPredictor(
        seeded_model(BENCH["num_classes"], BENCH["dim"], BENCH["seed"],
                     msg_dtype=dt), None, data, device="cuda")
        for dt in ("bfloat16", None)}
    setup_s = time.perf_counter() - t0
    p16, p32 = preds["bfloat16"], preds[None]
    if (p16.adj.tiered_fn is not None) != tiered:
        raise RuntimeError(f"{name}: expected tiered={tiered} layouts")
    lays = layouts_of(p16.adj)
    with torch.inference_mode():
        recs = check_kernel(kernel.__name__, kernel,
                            getattr(fk, kernel.__name__ + "_plain"),
                            record_run(p16.predict, (kernel.__name__,)),
                            lays)
    if any(r["dtype"] != "bfloat16" for r in recs):
        raise RuntimeError(f"{name}: a bf16 predict launched f32 kernels")

    bf16 = torch.bfloat16
    want_by_d = {fk.launch_key(HIDDEN, bf16): n_layouts,
                 fk.launch_key(num_classes, bf16): 3 * n_layouts}
    fk.reset_launch_counts()
    first = p16.predict()
    by_d = dict(kernel.launches_by_d)
    for _ in range(reps):
        p16.predict()
    with fk.record_launches() as events:
        marks = []
        for _ in range(reps):
            marks.append(len(events))
            p16.predict()
        marks.append(len(events))
    torch.cuda.synchronize()
    launches = kernel.launches
    other = sum(fn.launches for fn in fk.KERNEL_WRAPPERS) - launches
    if (by_d != want_by_d or launches != (1 + 2 * reps) * sum(
            want_by_d.values()) or other):
        raise RuntimeError(f"{name}: {kernel.__name__} launched {by_d} in "
                           f"one bf16 predict (expected {want_by_d}), "
                           f"{launches} in all; other kernels {other}")
    kernel_ms = [sum(r["start"].elapsed_time(r["stop"])
                     for r in events[a:b]) for a, b in zip(marks, marks[1:])]
    n = p16.graph.num_nodes
    check_heads(first, n, num_classes, f"{name} bf16 predict")
    times = {"bfloat16": [], None: []}
    for _ in range(reps):
        for dt in (None, "bfloat16"):
            t = time.perf_counter()
            out = preds[dt].predict()
            times[dt].append((time.perf_counter() - t) * 1e3)
    ref = p32.predict()
    check_heads(ref, n, num_classes, f"{name} f32 predict")
    diff = max(float(np.abs(out[h] - ref[h]).max()) for h in HEADS)
    agree = {h: float((out[h].argmax(1) == ref[h].argmax(1)).mean())
             for h in HEADS}
    if not diff < 0.15 or min(agree.values()) <= 0.98:
        raise RuntimeError(f"{name}: bf16 predict drifts {diff:.3g} from "
                           f"f32, argmax agreement {agree}")
    record = dict(
        phase=name, layouts=n_layouts, setup_s=setup_s,
        kernel=kernel.__name__ + "_bf16", launches=launches,
        launches_per_predict_by_d=by_d,
        kernel_ms_per_predict_median=statistics.median(kernel_ms),
        kernel_ms_per_predict_min=min(kernel_ms),
        predict_ms_median_bf16=statistics.median(times["bfloat16"]),
        predict_ms_median_f32=statistics.median(times[None]),
        predict_ms_min_bf16=min(times["bfloat16"]),
        predict_ms_min_f32=min(times[None]), predicts_timed=reps,
        max_abs_logprob_diff_vs_f32=diff, argmax_agreement_vs_f32=agree)
    lay = lays[0]
    central = p16.graph.central_mask
    del preds, p16, p32
    return recs, record, lay, central


def bf16_train_phase(name, data, tiered: bool, n_layouts: int,
                     num_classes: int, epochs: int):
    """Phase 15, training on one graph. (1) Phase 7 on a bf16 model under
    precision "default": one step's backward and reduce calls replayed
    against their plain versions and ``index_add_``, the whole backward
    twice bit-identical, the plain and lean steps' peak device memory.
    (2) The production setting, ``Stage2Config(message_dtype="bfloat16",
    matmul_precision="default", scan_epochs=BF16_CHUNK)``, for ``epochs``
    epochs with ``check_numerics`` on, the counts set to 0 before it: each
    replay launches per layout 8 forwards, 4 backwards and 4 reduces, all
    bf16; every loss finite. (3) The same run in f32 (message_dtype and
    matmul_precision None). (4) One bf16 loop epoch with CUDA events
    around every launch: its losses equal the scan run's first epoch's
    (rtol LOSS_RTOL). Returns the replay records, the phase's record and
    the loop epoch's kernel ms by wrapper. Garbage is collected first, so
    that the step's resident bytes hold the training state alone; the
    bytes that collection freed are in the record."""
    import dataclasses
    import gc

    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.utils.platform import matmul_precision

    allocated = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    freed_by_gc = allocated - torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg16 = stage2.Stage2Config(
        num_epoch=epochs, scan_epochs=BF16_CHUNK, to_undirected=True,
        check_numerics=True, message_dtype="bfloat16",
        matmul_precision="default")
    with matmul_precision(cfg16.matmul_precision):
        replay, det = check_backward(name, data, cfg16, tiered)
    torch.cuda.empty_cache()
    replay_s = time.perf_counter() - t0
    fwd, bwd = ((fk.attention_fwd, fk.attention_bwd) if tiered
                else (fk.attention_sel_fwd, fk.attention_sel_bwd))
    bf16 = torch.bfloat16
    hid, cls = (fk.launch_key(HIDDEN, bf16),
                fk.launch_key(num_classes, bf16))
    want = {fwd.__name__: {hid: 2 * n_layouts, cls: 6 * n_layouts},
            bwd.__name__: {hid: n_layouts, cls: 3 * n_layouts},
            "slot_reduce": {hid: n_layouts, cls: 3 * n_layouts}}
    prepared = stage2.prepare_stage2_graph(data, cfg16, "cuda")
    runs = {}
    with mock.patch.object(stage2, "prepare_stage2_graph",
                           lambda *a, **k: prepared):
        for key, cfg in (("bf16", cfg16),
                         ("f32", dataclasses.replace(
                             cfg16, message_dtype=None,
                             matmul_precision=None))):
            fk.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = stage2.train_ktgnn(data, cfg, device="cuda")
            runs[key] = dict(res=res, s=time.perf_counter() - t0,
                             peak=torch.cuda.max_memory_allocated(),
                             counted=fk.launch_counts())
        fk.reset_launch_counts()
        with fk.record_launches() as events:
            loop = stage2.train_ktgnn(data, dataclasses.replace(
                cfg16, num_epoch=1, scan_epochs=0), device="cuda")
        torch.cuda.synchronize()
        loop_by_d = fk.launch_counts()
    scan = runs["bf16"]["res"]
    info = scan["scan"]
    if info["launches_per_replay"] != want:
        raise RuntimeError(f"{name}: a bf16 replay launches "
                           f"{info['launches_per_replay']}, not {want}")
    counted = {n: c for n, c in runs["bf16"]["counted"].items() if c}
    counted_want = {n: {d: (info["eager_epochs"] + 1) * k
                        for d, k in by_d.items()} for n, by_d in want.items()}
    if counted != counted_want:
        raise RuntimeError(f"{name}: the wrappers counted {counted} in the "
                           f"bf16 run, not {counted_want}")
    if {n: c for n, c in loop_by_d.items() if c} != want:
        raise RuntimeError(f"{name}: a bf16 loop epoch launched "
                           f"{loop_by_d}, not {want}")
    losses = {k: [h["loss"] for h in r["res"]["history"]]
              for k, r in runs.items()}
    for k, ls in losses.items():
        if len(ls) != epochs or not np.all(np.isfinite(ls)):
            raise RuntimeError(f"{name}: {k} losses {ls}")
    first16, first32 = losses["bf16"][0], losses["f32"][0]
    if not abs(first16 - first32) <= 2 * BF16_ULP * abs(first32):
        raise RuntimeError(f"{name}: first bf16 loss {first16} against f32 "
                           f"{first32}")
    loop_err = max(abs(loop["history"][0][k] - scan["history"][0][k])
                   / abs(scan["history"][0][k]) for k in ("loss", "loss_t2"))
    if not loop_err <= LOSS_RTOL:
        raise RuntimeError(f"{name}: the bf16 loop epoch's losses differ "
                           f"from the scan run's by {loop_err:.3g}")
    kernel_ms = {fn.__name__: sum(r["start"].elapsed_time(r["stop"])
                                  for r in events if r["name"] == fn.__name__)
                 for fn in (fwd, bwd, fk.slot_reduce)}

    def scores(res):
        last = res["history"][-1]
        return dict(last={k: last[k] for k in ("epoch", "train", "val",
                                                 "test")},
                    best={k: v for k, v in res["best"].items()
                          if k != "per_head"})

    record = dict(
        phase=name, epochs=epochs, chunk=BF16_CHUNK, layouts=n_layouts,
        replay_s=replay_s, **info,
        launches_bf16={n: sum(c.values()) for n, c in counted.items()},
        epoch_s_median_bf16=scan["throughput"]["p50_s"],
        epoch_s_median_f32=runs["f32"]["res"]["throughput"]["p50_s"],
        run_s_bf16=runs["bf16"]["s"], run_s_f32=runs["f32"]["s"],
        scan_max_memory_allocated_bf16=runs["bf16"]["peak"],
        scan_max_memory_allocated_f32=runs["f32"]["peak"],
        step_peak_bytes_bf16=det["plain_peak_bytes"],
        lean_step_peak_bytes_bf16=det["lean_peak_bytes"],
        step_resident_bytes_bf16=det["resident_bytes"],
        step_bytes_bf16=det["plain_step_bytes"],
        lean_step_bytes_bf16=det["lean_step_bytes"],
        bytes_freed_by_gc=freed_by_gc,
        bit_identical_grads=det["bit_identical_grads"],
        losses_bf16=losses["bf16"], losses_f32=losses["f32"],
        loop_epoch_max_rel_loss_err=loop_err,
        loop_epoch_kernel_ms=kernel_ms,
        scores_bf16=scores(scan), scores_f32=scores(runs["f32"]["res"]))
    del runs, prepared
    return replay, record


# a score of phase 14: the head and the split mask it counts
_SCORE_OF = {"train": (0, "train_mask"), "val": (2, "val_mask"),
             "test": (2, "test_mask"), "best_train": (0, "train_mask"),
             "best_val": (2, "val_mask"), "best_test": (2, "test_mask"),
             "source": (0, "test_mask"), "target": (1, "test_mask"),
             "target_hat": (2, "test_mask")}


def name_ties(name, data, cfg, loop, diffs) -> list:
    """Phase 14, where a scan score differs from the loop's: the loop once
    more, each epoch's eval recorded (per head and node the two likeliest
    classes and the gap between their log-probabilities). The rerun must
    repeat the loop's history (the kernels are deterministic). Each
    differing score must be the loop's with one or two nodes of its split
    moved to their second class, nodes among the TIE_NODES of smallest
    gap and each gap below TIE_MARGIN: an argmax tie, which the two
    modes' Adam roundings may break either way. Returns each difference
    with the nodes that explain it."""
    import itertools

    import torch

    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.train.metrics import eval_metric

    evals, graph = [], {}
    eval_arrays = stage2._eval_arrays

    def recording(model, g, adj, need_probs):
        model.eval()
        with torch.no_grad():
            val, idx = torch.stack(model(g, adj)).topk(2, dim=-1)
        evals.append(((val[..., 0] - val[..., 1]).cpu().numpy(),
                      idx[..., 0].cpu().numpy(), idx[..., 1].cpu().numpy()))
        if not graph:
            graph.update({m: getattr(g, m).cpu().numpy() for m in
                          ("y", "train_mask", "val_mask", "test_mask")})
        return eval_arrays(model, g, adj, need_probs)

    with mock.patch.object(stage2, "_eval_arrays", recording):
        again = stage2.train_ktgnn(data, cfg, device="cuda")
    if again["history"] != loop["history"]:
        raise RuntimeError(f"{name}: the loop did not repeat its history")
    ties = []
    for epoch, key, got, want in diffs:
        head, mask = _SCORE_OF[key]
        margin, first, second = (a[head] for a in evals[epoch - 1])
        rows = np.flatnonzero(graph[mask])
        near = rows[np.argsort(margin[rows], kind="stable")[:TIE_NODES]]
        near = [int(i) for i in near if margin[i] < TIE_MARGIN]

        def score(flip):
            pred = first.copy()
            pred[list(flip)] = second[list(flip)]
            return eval_metric(graph["y"][rows], pred[rows], cfg.metric,
                               cfg.f1_average)

        if score(()) != want:
            raise RuntimeError(f"{name}: epoch {epoch} {key}: the rerun "
                               f"scores {score(())}, not {want}")
        flips = next((f for f in itertools.chain(
            itertools.combinations(near, 1), itertools.combinations(near, 2))
            if score(f) == got), None)
        if flips is None:
            raise RuntimeError(
                f"{name}: epoch {epoch} {key} is {got} (scan) against "
                f"{want} (loop), and no one or two of the {len(near)} "
                f"nodes of its split within {TIE_MARGIN} of a tie explain "
                "it")
        ties.append(dict(epoch=epoch, score=key, scan=got, loop=want,
                         nodes=list(flips),
                         margins=[float(margin[i]) for i in flips]))
    return ties


def parity_phase(name, data, cfg, explain=None):
    """Phase 11 (and 16): the same seeded run on the card and on the CPU.
    Losses within LOSS_RTOL; weights within WEIGHT_RTOL and WEIGHT_ATOL,
    or, where ``explain`` is given, explained by it: ``explain(apart)``
    gets ``{key: (card, cpu, mask of the elements apart)}``, returns the
    ties (inputs of a discontinuity within float rounding of it) that let
    the two runs' gradients part, and raises if there are none or if they
    cannot reach every element apart."""
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
    w_err, apart, far_at = 0.0, {}, {}
    for k, want in cpu["state_dict"].items():
        got = card["state_dict"][k]
        w_err = max(w_err, float((got - want).abs().max()))
        far = ~torch.isclose(got, want, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL)
        if far.any():
            apart[k] = int(far.sum())
            far_at[k] = (got, want, far)
    if apart and explain is None:
        raise RuntimeError(f"{name}: card vs CPU weights differ at {apart}")
    ties = explain(far_at) if apart else []
    return dict(phase=name, epochs=cfg.num_epoch, weights_apart=apart,
                ties=ties,
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
        ms_replayed_device=sum(r["device_ms"] for r in recs),
        plain_ms=sum(r["plain_ms"] for r in recs),
        bound_ms=sum(r["bound_ms"] for r in recs),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None if None in lib else sum(lib),
        library_device_ms=None if None in lib
        else sum(r["library_device_ms"] for r in recs), per=per, card=card,
    )


def bf16_phase(bench, hub, n_tiers: int, c: int, card: str):
    """Phase 15 on both graphs: :func:`bf16_serve_phase`, the five kernels
    at BF16_WIDE_DS in bf16 on the bench layout, and
    :func:`bf16_train_phase`. Returns the replay records by (kernel,
    graph), the serving and training records by graph and the wide
    records by kernel."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    serve, replay, train = {}, {}, {}
    for name, data, kernel, is_tiered, lays in (
            ("bench", bench, fk.attention_sel_fwd, False, 1),
            ("hub", hub, fk.attention_fwd, True, n_tiers)):
        recs, rec, lay, central = bf16_serve_phase(
            f"bf16_serve_{name}", data, kernel, is_tiered, lays, c,
            PREDICT_REPS)
        replay[(kernel.__name__, name)] = recs
        serve[name] = rec
        for r in recs:
            log(json.dumps(dict(kernel=kernel.__name__, graph=name,
                                card=card, **r)))
        log(json.dumps(dict(card=card, **rec)))
        if name == "bench":
            t0 = time.perf_counter()
            wide = wide_phase(lay, central, BENCH["seed"], BF16_WIDE_DS,
                              torch.bfloat16)
            log(f"bf16 wide widths {BF16_WIDE_DS}: "
                f"{time.perf_counter() - t0:.1f} s")
        del lay, central
        torch.cuda.empty_cache()
    for name, data, is_tiered, lays in (("bench", bench, False, 1),
                                        ("hub", hub, True, n_tiers)):
        recs, rec = bf16_train_phase(f"bf16_train_{name}", data, is_tiered,
                                     lays, c, BF16_EPOCHS)
        for kname, rows in recs.items():
            replay[(kname, name)] = rows
            for r in rows:
                log(json.dumps(dict(kernel=kname, graph=name, card=card,
                                    **r)))
        train[name] = rec
        log(json.dumps(dict(card=card, **rec)))
        torch.cuda.empty_cache()
    return replay, serve, train, wide


def bf16_rows(f32_rows, replay, serve, train, wide, card) -> list:
    """Phase 15's entries of the kernels line, one per kernel's bf16
    instantiation (named after its C entry point, ``<name>_bf16``): the
    forwards' launches and in-run ms per predict from the bf16 serving
    runs, the backwards' and the reduce's launches from the production
    training runs and their in-run ms per epoch from the bf16 loop epoch;
    plain, bound and library summed over the replayed calls of one bf16
    predict or training step, as the f32 rows."""
    graph_of = {"attention_sel_fwd": "bench", "attention_fwd": "hub",
                "attention_sel_bwd": "bench", "attention_bwd": "hub",
                "slot_reduce": "bench"}
    rows = []
    for base in f32_rows:
        name, graph = base["name"], graph_of[base["name"]]
        if name.endswith("fwd"):
            ms = serve[graph]["kernel_ms_per_predict_median"]
            launches, per = serve[graph]["launches"], "predict"
        else:
            ms = train[graph]["loop_epoch_kernel_ms"][name]
            launches = sum(train[g]["launches_bf16"].get(name, 0)
                           for g in train)
            per = "epoch"
        row = summary_row(f"{name}_bf16", base["source"], base["replaces"],
                          replay[(name, graph)], launches, ms, per, card)
        row["dtype"] = "bfloat16"
        row["wide"] = [{k: r[k] for k in (
            "d", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} for r in wide[name]]
        rows.append(row)
    hub_rows = replay[("slot_reduce", "hub")]
    rows[4].update(
        ms_tiered=train["hub"]["loop_epoch_kernel_ms"]["slot_reduce"],
        plain_ms_tiered=sum(r["plain_ms"] for r in hub_rows),
        bound_ms_tiered=sum(r["bound_ms"] for r in hub_rows),
        library_ms_tiered=sum(r["library_ms"] for r in hub_rows))
    return rows


# ------------------------------------------------- phase 16: the model zoo


def no_dtc_cfg(**kw):
    """The reference's --no_dtc recipe as the CLI builds it (GraphSAGE, 2
    layers, hidden 64, no scheduler), on the undirected graph."""
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    return Stage2Config(**{**dict(model_name="GraphSAGE", use_scheduler=False,
                                  to_undirected=True), **kw})


def cached_prepare(real):
    """``prepare_stage2_graph`` on the card built once per graph, self-loop
    choice and layout: the zoo's runs share three prepared bench graphs
    (set-up, printed apart, is no part of an epoch). CPU runs build
    theirs."""
    from bridged_gnn_tpu_torch.train import stage2

    import torch

    cache = {}

    def prepare(data, cfg, device="cuda"):
        if torch.device(device).type != "cuda":
            return real(data, cfg, device)
        key = (id(data), cfg.model_name in stage2.SELF_LOOP_MODELS,
               stage2._ktgnn_family(cfg), cfg.to_undirected,
               cfg.adjacency_method)
        if key not in cache:
            cache[key] = real(data, cfg, device)
        return cache[key]
    return prepare


def gather_bound(inputs):
    """Least time for one padded SpMM call on these inputs: the index of
    every real slot (entry), its weight (and, transposed, its slot id for
    the weight) when weighted, the range of every row written, each
    distinct row of ``x`` the entries reach, D wide, and the output
    written once, all 4-byte; one multiply-add (weighted) or add per
    element of every row read."""
    import torch

    lay, x, n_rows, w_slot, transpose = inputs
    d = x.shape[1]
    if transpose:
        idx = lay.src_dst
        per_entry = 4 + (8 if w_slot is not None else 0)
    else:
        idx = lay.slot_src[lay.slot_src >= 0]
        per_entry = 4 + (4 if w_slot is not None else 0)
    real = int(idx.numel())
    rows_read = int(torch.unique(idx).numel())
    ranges = min(n_rows, (lay.src_ranges if transpose
                          else lay.dst_ranges).shape[0])
    read = real * per_entry + ranges * 8 + rows_read * d * 4
    written = n_rows * d * 4
    flops = real * d * (2 if w_slot is not None else 1)
    return ((read + written) / HBM_BYTES_PER_S * 1e3,
            flops / F32_FLOPS_PER_S * 1e3, real)


def _gather_csr(inputs):
    """The call's matrix as torch CSR ``[n_rows, N_x]`` (the same weights,
    1 where unweighted; columns sorted within each row), its entries'
    rows, gathered rows of x and weights."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    lay, x, n_rows, w_slot, transpose = inputs
    key, src, slot = fk.gather_index(lay, transpose)
    vals = (w_slot[slot] if w_slot is not None
            else torch.ones(key.shape[0], device=x.device))
    order = torch.argsort(key * x.shape[0] + src, stable=True)
    crow = torch.zeros(n_rows + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(torch.bincount(key, minlength=n_rows), 0)
    with warnings.catch_warnings():   # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, src[order], vals[order],
                                    size=(n_rows, x.shape[0]),
                                    check_invariants=False)
    return a, key, src, vals


def gather_library(inputs):
    """``torch.sparse.mm`` of the call's CSR matrix (built outside the timed
    call) and ``x``: the one PyTorch call computing the same function.
    Timed as a yardstick only; the port never calls it."""
    import torch

    a = _gather_csr(inputs)[0]
    x = inputs[1]
    return lambda: torch.sparse.mm(a, x)


def gather_index_add(inputs):
    """``index_add_`` of the call's gathered, weighted rows (gathered
    outside the timed call) into the output rows."""
    import torch

    _, key, src, vals = _gather_csr(inputs)
    x, n_rows, w_slot = inputs[1], inputs[2], inputs[3]
    rows = x[src] if w_slot is None else vals[:, None] * x[src]
    return lambda: torch.zeros(n_rows, x.shape[1],
                               device=x.device).index_add_(0, key, rows)


def zoo_replay(data, cfg, layouts_want: int, panel_check: bool = False,
               width=None):
    """Phase 16's kernel replay: the gather_reduce calls of one epoch of
    ``cfg`` (a train step, forward and x-gradients, and the eval forward;
    with ``width``, those at that width only),
    each replayed against its plain version (the reduce's tolerance:
    rtol 1e-4, atol 1e-4 × the output's largest magnitude), launched twice
    for bit-identical outputs, timed beside its bound, torch.sparse.mm
    and index_add_, with its panels, gathered bytes and rate; with
    ``panel_check`` the first call at D = PANEL_CHECK_D also at forced
    panel widths (check_panel_widths)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2

    g, adj, model, opt, gen = train_setup(data, cfg)
    layouts = layouts_of(adj)
    if len(layouts) != layouts_want:
        raise RuntimeError(f"zoo replay: {len(layouts)} layout(s), not "
                           f"{layouts_want}")

    def epoch():
        stage2.train_step(model, g, adj, opt, cfg.Lambda, gen)
        stage2._heads(model, g, adj)

    recs = [r for r in record_run(epoch, ("gather_reduce",))
            if width is None or r["d"] == width]
    with torch.no_grad():
        out = check_kernel("gather_reduce", fk.gather_reduce,
                           fk.gather_reduce_plain, recs, layouts,
                           bound=gather_bound, scaled=True,
                           library=gather_library)
        for r, rec in zip(out, recs):
            call = gather_index_add(rec["inputs"])
            r.update(transpose=bool(rec["inputs"][4]),
                     weighted=rec["inputs"][3] is not None,
                     index_add_ms=cuda_ms(call, KERNEL_REPS),
                     index_add_device_ms=cuda_device_ms(call, KERNEL_REPS),
                     **gather_panels_of(rec["inputs"], r))
            del call
        if panel_check:
            i = next(i for i, r in enumerate(recs) if r["d"] == PANEL_CHECK_D)
            out[i]["panel_widths_bit_identical"] = check_panel_widths(
                recs[i]["inputs"])
    del recs, model, opt
    torch.cuda.empty_cache()
    return out


def gather_panels_of(inputs, rec) -> dict:
    """The panels a gather_reduce call walks (the wrapper's rule on this
    card's L2), the bytes of x it gathers (each entry's row once per
    panel, as wide as the panel: entries × D × 4) and the rate of its
    device time."""
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    x = inputs[1]
    panel = fk.gather_panel(x.shape[0], x.shape[1], fk._l2_size(x.device))
    gathered = rec["real_slots"] * x.shape[1] * 4
    return dict(panel=panel,
                panels=fk.gather_panel_count(x.shape[1], panel),
                gathered_bytes=gathered,
                gather_tb_s=gathered / rec["device_ms"] / 1e9)


def check_panel_widths(inputs) -> list:
    """One call at forced panel widths PANEL_CHECK_WIDTHS (lane groups of
    1, 8, 16 and 32 lanes, so 4 and 8 entries in flight): each launch
    bit-identical to the wrapper's. Returns the widths checked."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    want = fk.gather_reduce(*inputs)
    d = inputs[1].shape[1]
    for panel in PANEL_CHECK_WIDTHS:
        got = fk._gather_reduce_launch(*inputs, panel)
        if not torch.equal(got, want):
            raise RuntimeError(f"gather_reduce at D={d}: panel {panel} "
                               "differs from the wrapper's launch")
    return list(PANEL_CHECK_WIDTHS)


def zoo_train(name, data, cfg, per_epoch: dict, layouts: int,
              record: bool = True) -> dict:
    """``train_ktgnn`` of ``cfg`` on the card, counts at 0 just before:
    every kernel launched as ``per_epoch`` ({kernel: {width: launches}}
    per epoch and layout) says and no other, every loss finite; the
    kernels' time per epoch from CUDA events around every launch (not in
    scan mode, whose capture takes no events)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    e = cfg.num_epoch
    want = {k: {d: n * e * layouts for d, n in by_d.items()}
            for k, by_d in per_epoch.items()}
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    with (fk.record_launches() if record
          else contextlib.nullcontext([])) as recs:
        res = train_ktgnn(data, cfg, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counted = {n: c for n, c in fk.launch_counts().items() if c}
    scan = res["scan"]
    if scan is None and counted != want:
        raise RuntimeError(f"{name}: launched {counted} in {e} epochs on "
                           f"{layouts} layout(s); expected {want}")
    losses = [h["loss"] for h in res["history"]]
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: losses {losses}")
    kernel_ms = {k: sum(r["start"].elapsed_time(r["stop"]) for r in recs
                        if r["name"] == k) / e for k in per_epoch}
    return dict(
        phase=name, model=cfg.model_name, epochs=e, layouts=layouts,
        edges=int(res["num_edges"]), launches=counted,
        launches_per_epoch_by_d=None if scan else {
            k: {d: n // e for d, n in by_d.items()}
            for k, by_d in counted.items()},
        epoch_s_median=res["throughput"]["p50_s"],
        epoch_s_mean=res["mean_epoch_time"], run_s=wall_s,
        kernel_ms_per_epoch=kernel_ms if record else None, losses=losses,
        best={k: v for k, v in res["best"].items() if k != "per_head"},
        scan=scan)


def zoo_per_epoch(name: str, f: int, h: int, c: int) -> dict:
    """Each model's kernel launches per epoch and layout by width (f
    features, h hidden, c classes): the train step's forwards and
    x-gradients and the eval forward. GraphSAGE and GIN aggregate the
    features, which need no gradient; GCN, JKNet and GCN2 aggregate after
    a linear; APPNP propagates 10 times at the classes; GAT, GATv2,
    DeeperGCN (segment softmax and sum) and MLP launch nothing;
    KTGNN_noDTC (2 layers: one conv to the classes) the attention
    kernels."""
    return {
        "GraphSAGE": {"gather_reduce": {f: 2, h: 3}},
        "GIN": {"gather_reduce": {f: 2, h: 3}},
        "GCN": {"gather_reduce": {h: 3, c: 3}},
        "JKNet": {"gather_reduce": {h: 6}},
        "GCN2": {"gather_reduce": {h: 6}},
        "APPNP": {"gather_reduce": {c: 30}},
        "GAT": {}, "GATv2": {}, "DeeperGCN": {}, "MLP": {},
        "KTGNN_noDTC": {"attention_sel_fwd": {c: 2},
                        "attention_sel_bwd": {c: 1}, "slot_reduce": {c: 1}},
    }[name]


def zoo_wide(lay, n: int, seed: int) -> list:
    """The SpMM kernel at WIDE_DS on the bench layout with seeded random
    rows and weights: unweighted and weighted forwards and the weighted
    transpose, each against its plain version (in row chunks), twice for
    bit-identical outputs, timed beside its bound and torch.sparse.mm."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    recs = []
    for d in WIDE_DS:
        gen = torch.Generator(device="cuda").manual_seed(seed + d)
        x = torch.randn(n, d, generator=gen, device="cuda")
        w = torch.randn(lay.slot_src.shape[0], generator=gen, device="cuda")
        for weighted, transpose in ((False, False), (True, False),
                                    (True, True)):
            got, rec = check_wide(
                "gather_reduce", fk.gather_reduce, fk.gather_reduce_plain,
                (lay, x, n, w if weighted else None, transpose), True,
                gather_bound, gather_library)
            del got
            rec.update(weighted=weighted, transpose=transpose,
                       **gather_panels_of((lay, x), rec))
            log(json.dumps(dict(phase="zoo_wide", **rec)))
            recs.append(rec)
        del x, w
        torch.cuda.empty_cache()
    return recs


def write_dat(path: str, data: dict) -> None:
    """``data`` as the reference's torch.save of a PyG ``Data`` (PyG >= 2.0
    layout: the tensors in ``_store._mapping``), written without PyG:
    stand-in classes under PyG's module paths while saving."""
    import types

    import torch

    mod_d = types.ModuleType("torch_geometric.data.data")
    mod_s = types.ModuleType("torch_geometric.data.storage")
    mod_d.Data = type("Data", (), {"__module__": mod_d.__name__})
    mod_s.GlobalStorage = type("GlobalStorage", (),
                               {"__module__": mod_s.__name__})
    obj, store = mod_d.Data(), mod_s.GlobalStorage()
    store._mapping = {k: torch.from_numpy(np.asarray(v))
                      for k, v in data.items()}
    obj._store = store
    names = ("torch_geometric", "torch_geometric.data", mod_d.__name__,
             mod_s.__name__)
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update(dict(zip(names, (
        types.ModuleType(names[0]), types.ModuleType(names[1]), mod_d,
        mod_s))))
    try:
        torch.save(obj, path)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


TIE_ATOL = 1e-6          # phase 16: a ReLU input this close to 0 is a tie


def relu_ties(name, data, cfg, apart):
    """Why a zoo model's card and CPU runs may part: the first conv's
    outputs (the first ReLU's inputs) of one train-mode forward at the
    seeded init, on both devices; every element whose sign differs is
    listed (node, column, both values) and must lie within TIE_ATOL of 0.
    A flipped ReLU at output column c changes the gradient of the first
    conv's parameters of that column only (row c of each weight, element
    c of the bias), which Adam turns into steps of at most lr each epoch.
    So every element of ``apart`` ({key: (card, cpu, mask)}) must lie in
    ``convs_0``'s row of a tied column and differ by at most 2·lr per
    epoch. Raises when no tie explains a difference."""
    import torch

    from bridged_gnn_tpu_torch.train import stage2

    outs = {}
    for dev in ("cuda", "cpu"):
        g, adj = stage2.prepare_stage2_graph(data, cfg, dev)
        model = stage2.build_model(cfg, g.num_classes, g.num_features, dev)
        seen = []
        hook = model.convs_0.register_forward_hook(
            lambda m, i, o: seen.append(o.detach().cpu()))
        with torch.no_grad():
            model.train()(g, adj, None)
        hook.remove()
        outs[dev] = seen[0][: g.num_nodes]
    a, b = outs["cuda"], outs["cpu"]
    flips = torch.nonzero((a > 0) != (b > 0))
    ties = [dict(node=int(n), column=int(c), card=float(a[n, c]),
                 cpu=float(b[n, c])) for n, c in flips.tolist()]
    if not ties or any(max(abs(t["card"]), abs(t["cpu"])) > TIE_ATOL
                       for t in ties):
        raise RuntimeError(f"{name}: card vs CPU weights differ, and the "
                           f"first ReLU's inputs explain it by no tie: "
                           f"{ties[:10]}")
    by_column = {t["column"]: [] for t in ties}
    step = 2.0 * cfg.lr * cfg.num_epoch
    for key, (got, want, far) in apart.items():
        for idx in torch.nonzero(far).tolist():
            d = float((got - want)[tuple(idx)].abs())
            if not key.startswith("convs_0.") or not idx \
                    or idx[0] not in by_column or d > step:
                raise RuntimeError(
                    f"{name}: card vs CPU weight {key}{idx} differs by "
                    f"{d:.3g}, which the ties at columns {sorted(by_column)}"
                    f" (at most {step:.3g} in convs_0's rows of them) do "
                    "not explain")
            by_column[idx[0]].append(dict(
                key=key, index=idx, card=float(got[tuple(idx)]),
                cpu=float(want[tuple(idx)])))
    for t in ties:
        t["weights_apart"] = by_column[t["column"]]
    return ties


def zoo_cli(data, per_epoch: dict) -> dict:
    """The port's CLI with --no_dtc on a .dat this phase writes: it must
    build GraphSAGE without the scheduler (as the JAX CLI does), train
    ZOO_CLI_EPOCHS epochs through the SpMM kernel alone and save
    model_GraphSAGE_<dataset>_best.pkl."""
    import contextlib as cl
    import io

    from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as cli
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.dat")
        t0 = time.perf_counter()
        write_dat(path, data)
        write_s = time.perf_counter() - t0
        argv = ["--path_data", path, "--no_dtc", "--num_epoch",
                str(ZOO_CLI_EPOCHS), "--to_undirected", "--save",
                "--ckpt_dir", tmp, "--dataset_name", "bench", "--log_every",
                "1"]
        seen = []
        real = cli.train_ktgnn

        def recording(d, cfg, device):
            seen.append(cfg)
            return real(d, cfg, device=device)

        out = io.StringIO()
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(cli, "train_ktgnn", recording), \
                cl.redirect_stdout(out):
            res = cli.main(cli.build_argparser().parse_args(argv))
        run_s = time.perf_counter() - t0
        saved = os.path.isfile(os.path.join(
            tmp, "model_GraphSAGE_bench_best.pkl"))
    (cfg,) = seen
    want = {k: {d: n * ZOO_CLI_EPOCHS for d, n in by_d.items()}
            for k, by_d in per_epoch.items()}
    counted = {n: c for n, c in fk.launch_counts().items() if c}
    text = out.getvalue()
    if (cfg.model_name, cfg.use_scheduler, cfg.no_dtc) != (
            "GraphSAGE", False, False) or not saved or counted != want \
            or "[stage-2 best]" not in text \
            or not np.all(np.isfinite([h["loss"] for h in res["history"]])):
        raise RuntimeError(
            f"zoo CLI: model {cfg.model_name}, scheduler "
            f"{cfg.use_scheduler}, saved {saved}, launches {counted} (want "
            f"{want}), output tail {text[-300:]!r}")
    return dict(phase="zoo_cli", model=cfg.model_name,
                use_scheduler=cfg.use_scheduler, epochs=ZOO_CLI_EPOCHS,
                launches=counted, saved=saved, write_dat_s=write_s,
                run_s=run_s, losses=[h["loss"] for h in res["history"]])


def zoo_phase(bench, hub, c: int, card: str) -> dict:
    """Phase 16: the stage-2 model zoo. The --no_dtc recipe (GraphSAGE,
    hidden 64, 2 layers, no scheduler): one epoch's SpMM calls replayed
    on each graph (zoo_replay), and GCN's at the classes' width on the
    bench graph; on the bench graph 10 loop epochs with
    CUDA events around every launch, 2 loop epochs traced, 12 epochs in
    scan mode (losses within rtol 1e-4 of the loop's first 10, each
    replay launching the SpMM as a loop epoch does); on the hub graph
    (degree tiers, one launch per tier) 5 epochs; the kernel at D = 257,
    512, 1030; card
    against CPU for GraphSAGE and GCN (2 epochs, dropout 0); every other
    CLI model and KTGNN_noDTC (once with root_weight) for 2 epochs at
    hidden 64; the CLI with --no_dtc on a .dat."""
    import torch

    from bridged_gnn_tpu_torch.train import stage2

    f, h = BENCH["dim"], HIDDEN
    out = {}
    t_phase = time.perf_counter()
    with mock.patch.object(stage2, "prepare_stage2_graph",
                           cached_prepare(stage2.prepare_stage2_graph)):
        t0 = time.perf_counter()
        g, adj = stage2.prepare_stage2_graph(bench, no_dtc_cfg(), "cuda")
        gh, adj_h = stage2.prepare_stage2_graph(hub, no_dtc_cfg(), "cuda")
        n_tiers = len(layouts_of(adj_h))
        if adj.fast_fn is None or n_tiers < 2:
            raise RuntimeError("zoo: the bench graph must keep one layout, "
                               "the hub graph tiers")
        log(json.dumps(dict(phase="zoo_setup", card=card,
                            s=time.perf_counter() - t0,
                            bench_edges=g.num_edges, hub_edges=gh.num_edges,
                            hub_tiers=n_tiers,
                            bench_tile_e=adj.fast_fn.lay_dst.tile_e)))
        sage = zoo_per_epoch("GraphSAGE", f, h, c)

        # the kernel's calls of one epoch on each graph, replayed
        out["replay"] = zoo_replay(bench, no_dtc_cfg(), 1, panel_check=True)
        out["replay_hub"] = zoo_replay(hub, no_dtc_cfg(), n_tiers)
        # the classes' width, where GCN (3 calls an epoch) and APPNP (30)
        # aggregate: GCN's calls, on its self-loop layout
        out["replay_classes"] = zoo_replay(
            bench, no_dtc_cfg(model_name="GCN"), 1, width=c)
        for graph, recs in (("bench", out["replay"]),
                            ("hub", out["replay_hub"]),
                            ("bench_gcn", out["replay_classes"])):
            for r in recs:
                log(json.dumps(dict(kernel="gather_reduce", graph=graph,
                                    card=card, **r)))
        # the main path: the --no_dtc recipe's loop on the bench graph
        out["bench"] = zoo_train("zoo_bench", bench,
                                 no_dtc_cfg(num_epoch=ZOO_EPOCHS), sage, 1)
        log(json.dumps(dict(card=card, **out["bench"])))
        out["trace"] = trace_phase("zoo_trace", bench, no_dtc_cfg(
            num_epoch=TRACE_EPOCHS))
        log(json.dumps(dict(card=card, **out["trace"])))
        scan = zoo_train("zoo_scan_bench", bench, no_dtc_cfg(
            num_epoch=ZOO_SCAN_EPOCHS, scan_epochs=ZOO_SCAN_CHUNK,
            check_numerics=True), sage, 1, record=False)
        info = scan["scan"]
        if (info["captures"], info["eager_epochs"], info["replays"]) != (
                1, stage2.WARMUP_EPOCHS,
                ZOO_SCAN_EPOCHS - stage2.WARMUP_EPOCHS) \
                or info["launches_per_replay"] != sage:
            raise RuntimeError(f"zoo scan: {info}")
        err = max(abs(a - b) / abs(b) for a, b in zip(
            scan["losses"], out["bench"]["losses"]))
        if not err <= LOSS_RTOL:
            raise RuntimeError(f"zoo scan vs loop losses differ by {err:.3g}")
        scan["max_rel_loss_err_vs_loop"] = err
        out["scan"] = scan
        log(json.dumps(dict(card=card, **scan)))
        out["hub"] = zoo_train("zoo_hub", hub,
                               no_dtc_cfg(num_epoch=ZOO_HUB_EPOCHS), sage,
                               n_tiers)
        log(json.dumps(dict(card=card, **out["hub"])))
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        out["wide"] = zoo_wide(adj.fast_fn.lay_dst, g.num_nodes_padded,
                               BENCH["seed"])
        log(f"zoo wide widths {WIDE_DS}: {time.perf_counter() - t0:.1f} s")
        del g, adj, gh, adj_h
        torch.cuda.empty_cache()

        # card against CPU, dropout 0, the same seeded init
        out["parity"] = []
        for name in ("GraphSAGE", "GCN"):
            cfg = no_dtc_cfg(model_name=name, num_epoch=PARITY_EPOCHS,
                             dropout=0.0)
            rec = parity_phase(
                f"zoo_parity_{name}", bench, cfg,
                explain=lambda far: relu_ties(f"zoo_parity_{name}", bench,
                                              cfg, far))
            out["parity"].append(rec)
            log(json.dumps(dict(card=card, **rec)))

        # every other model for 2 epochs at hidden 64
        out["others"] = []
        for name, extra in [(m, {}) for m in (
                "MLP", "GCN", "GAT", "GATv2", "GIN", "JKNet", "APPNP",
                "GCN2", "DeeperGCN", "KTGNN_noDTC")] + [
                ("KTGNN_noDTC", dict(root_weight=True))]:
            cfg = stage2.Stage2Config(model_name=name, to_undirected=True,
                                      num_epoch=ZOO_OTHER_EPOCHS, **extra)
            rec = zoo_train(f"zoo_{name}" + ("_root" if extra else ""),
                            bench, cfg, zoo_per_epoch(name, f, h, c), 1)
            out["others"].append(rec)
            log(json.dumps(dict(card=card, **rec)))
            torch.cuda.empty_cache()

        out["cli"] = zoo_cli(bench, sage)
        log(json.dumps(dict(card=card, **out["cli"])))
    out["s"] = time.perf_counter() - t_phase
    return out


def zoo_row(zoo, card) -> dict:
    """The kernels line's entry for the SpMM kernel: launches and in-run
    ms per epoch of the --no_dtc bench loop; plain, bound, torch.sparse.mm
    (library_ms) and index_add_ summed over one epoch's replayed calls;
    the hub loop's in-run ms and its replayed sums (``*_tiered``) beside;
    the wide calls and GCN's calls at the classes' width (``classes``)."""
    recs = zoo["replay"]
    row = summary_row(
        "gather_reduce", "bridged_gnn_tpu_torch/csrc/gather_reduce.cu",
        "bridged_gnn_tpu/ops/pallas_padded.py:33",
        recs, sum(zoo["bench"]["launches"]["gather_reduce"].values()),
        zoo["bench"]["kernel_ms_per_epoch"]["gather_reduce"], "epoch", card)
    row.update(
        dtype="float32", library="torch.sparse.mm (CSR, same weights)",
        launches_by_d=zoo["bench"]["launches"]["gather_reduce"],
        index_add_ms=sum(r["index_add_ms"] for r in recs),
        index_add_device_ms=sum(r["index_add_device_ms"] for r in recs),
        launches_per_epoch_by_d=zoo["bench"]["launches_per_epoch_by_d"][
            "gather_reduce"],
        ms_tiered=zoo["hub"]["kernel_ms_per_epoch"]["gather_reduce"],
        **{f"{name}_tiered": sum(r[k] for r in zoo["replay_hub"])
           for name, k in (("ms_replayed", "ms"),
                           ("ms_replayed_device", "device_ms"),
                           ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                           ("library_ms", "library_ms"),
                           ("index_add_ms", "index_add_ms"))},
        wide=[{k: r[k] for k in (
            "d", "weighted", "transpose", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "max_abs_err", "panels",
            "gather_tb_s")}
            for r in zoo["wide"]],
        classes=[{k: r[k] for k in (
            "d", "weighted", "transpose", "ms", "device_ms", "plain_ms",
            "bound_ms", "library_ms", "library_device_ms",
            "index_add_device_ms", "max_abs_err", "panels", "gather_tb_s")}
            for r in zoo["replay_classes"]])
    return row


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
    # phase 13 runs the kernels at wide widths on the bench layout
    bench_lay = pred.adj.fast_fn.lay_dst
    bench_central = pred.graph.central_mask
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

    # 10. one traced run per graph
    for name, data in (("trace_single", bench), ("trace_tiered", hub)):
        log(json.dumps(dict(card=card, **trace_phase(
            name, data, Stage2Config(num_epoch=TRACE_EPOCHS,
                                     to_undirected=True)))))
        torch.cuda.empty_cache()

    # 11. card vs CPU, dropout 0, same seeded init
    small = (bench if PARITY_NODES == BENCH["n"]
             else make_benchmark_graph(**dict(BENCH, n=PARITY_NODES)))
    pcfg = Stage2Config(num_epoch=PARITY_EPOCHS, dropout=0.0,
                        to_undirected=True)
    for name, data in (("parity_single", small),
                       ("parity_tiered", hub_graph(small, BENCH["seed"]))):
        log(json.dumps(dict(card=card, **parity_phase(name, data, pcfg))))

    # 12. heavy rows below the skew rule: one layout, 1,024 heavy rows
    t0 = time.perf_counter()
    lead = lead_graph(bench, BENCH["seed"])
    pred_l = KTGNNPredictor(copy.deepcopy(model), None, lead, device="cuda")
    if pred_l.adj.fast_fn is None:
        raise RuntimeError("the lead graph must keep one layout")
    lay_l = pred_l.adj.fast_fn.lay_dst
    runs = lay_l.dst_ranges[:, 1] - lay_l.dst_ranges[:, 0]
    heavy_runs = runs[lay_l.dst_heavy.long()]
    lead_info = dict(
        phase="lead_layout", edges=int(pred_l.graph.num_edges),
        tile_e=lay_l.tile_e, heavy_rows=int(lay_l.dst_heavy.numel()),
        heavy_slots_min=int(heavy_runs.min()) if len(heavy_runs) else 0,
        heavy_slots_max=int(heavy_runs.max()) if len(heavy_runs) else 0,
        heavy_slots_mean=float(heavy_runs.float().mean())
        if len(heavy_runs) else 0.0,
        setup_s=time.perf_counter() - t0)
    log(json.dumps(dict(card=card, **lead_info)))
    if lead_info["heavy_rows"] == 0:
        raise RuntimeError("the lead graph's layout has no heavy row")
    with torch.inference_mode():
        lead_recs = check_kernel(
            "attention_sel_fwd", fk.attention_sel_fwd,
            fk.attention_sel_fwd_plain,
            record_run(pred_l.predict, ("attention_sel_fwd",)), [lay_l])
    for r in lead_recs:
        log(json.dumps(dict(kernel="attention_sel_fwd", graph="lead",
                            card=card, **r)))
    del pred_l, lay_l, runs, heavy_runs
    torch.cuda.empty_cache()

    # 13. every kernel at the wide widths on the bench layout
    t0 = time.perf_counter()
    wide = wide_phase(bench_lay, bench_central, BENCH["seed"])
    log(f"wide widths {WIDE_DS}: {time.perf_counter() - t0:.1f} s")
    del bench_lay, bench_central
    torch.cuda.empty_cache()

    # 14. scan mode: epochs replayed from one CUDA graph, against the loop
    for name, data, is_tiered, lays in (("scan_single", bench, False, 1),
                                        ("scan_tiered", hub, True, n_tiers)):
        t0 = time.perf_counter()
        rec = scan_phase(name, data, is_tiered, lays, c)
        log(json.dumps(dict(card=card, s=time.perf_counter() - t0, **rec)))
        torch.cuda.empty_cache()

    # 15. bf16 messages: serving and the kernels' bf16 calls on each graph,
    # the wide path in bf16, and the production training setting
    t0 = time.perf_counter()
    bf16 = bf16_phase(bench, hub, n_tiers, c, card)
    log(f"phase 15 (bf16 messages): {time.perf_counter() - t0:.1f} s")

    # 16. the model zoo: the --no_dtc recipe through the padded SpMM
    # kernel, every other model, the CLI on a .dat
    zoo = zoo_phase(bench, hub, c, card)
    log(f"phase 16 (the model zoo): {zoo['s']:.1f} s")

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
    for row in kernels:
        row["dtype"] = "float32"
    for row, phase in ((kernels[0], single), (kernels[1], tiered)):
        row["launches_per_predict_by_d"] = phase["launches_per_predict_by_d"]
    for row in kernels:
        row["wide"] = [{k: r[k] for k in (
            "d", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} for r in wide[row["name"]]]
    kernels[0]["lead_layout"] = dict(
        heavy_rows=lead_info["heavy_rows"],
        calls=[{k: r[k] for k in ("d", "ms", "device_ms", "plain_ms",
                                  "bound_ms", "max_abs_err")}
               for r in lead_recs])
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
    kernels += bf16_rows(kernels, *bf16, card)
    kernels.append(zoo_row(zoo, card))
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
