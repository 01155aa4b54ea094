"""Drive the PyTorch/CUDA port's KT-GNN serving and training paths, its
stage-2 model zoo, the rest of stage 2, stage 1 (loop and scan mode),
the one-call pipeline, similarity serving and multi-device stages 1 and
2, the sharded bridge and elastic retries on one GPU.

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
3b. the conv prologue (``ops/conv_prologue.py``) at the benchmark's
   shapes: an AdaptedConv 256 → 64 and one 64 → 31 over 131,072 seeded
   rows, f32 and bf16 message tables, forward and backward recorded; each
   of the six kernels' calls replayed against its plain version on the
   card (rtol 1e-4, atol 1e-4 times the output's largest magnitude, one
   bf16 ulp more for bf16 tables; the per-block partial rows by their
   sums), launched twice to give bit-identical outputs, timed, and set
   beside its byte bound. Every later launch count includes the
   prologue's: a pass, a finish and an epilogue a conv call, a backward
   pass and finish a conv, ``dx`` where the conv's input takes a
   gradient (``prologue_want``);
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
11. card vs CPU: 2 train steps at dropout 0 from the same seeded init on
   each graph, one at a time, the CPU (plain versions) taking the card's
   weights and Adam state before each: losses within rtol 1e-4, every
   parameter's gradient within rtol 1e-3 and 1e-3 of the tensor's
   largest (a gradient zero but for rounding, below 1e-6 of the model's
   largest on both devices, apart), BN statistics within rtol 1e-3 and
   atol 1e-5; a first ReLU input (the first batch norm's output) whose
   sign the devices part must lie within 1e-6 of 0 (a tie, listed);
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
   scheduler and save ``model_GraphSAGE_bench_best.pkl``;
17. serving zoo checkpoints: the training CLI with ``--no_dtc`` trains
   GraphSAGE for 2 epochs on a ``.dat`` of the bench graph and saves it,
   ``train_ktgnn`` saves a KTGNNNoDTC checkpoint; the serving CLI's
   ``_load_predictor`` serves each (``--model_name GraphSAGE``,
   ``--no_dtc``) on the card: one predict's kernel calls replayed
   against their plain versions, its launches (2 SpMMs at D=128 and 64;
   1 selective forward at the classes), predict ×10 (median), card
   against CPU log-probs within 1e-4, and /healthz, a cached and a live
   /v1/predict over HTTP;
18. ConvNet on the bench graph with seeded pseudo-coordinates in [0, 1]
   as ``edge_attr``: the weighted SpMM calls of one epoch replayed as in
   phase 16, 2 loop epochs (6 launches at D=16 and 6 at the classes per
   epoch), card against CPU at dropout 0 (losses rtol 1e-4, weights
   phase 11's tolerances);
19. KT-GNN with the feature complementor (``dim_share`` 64, two
   frontiers, ``use_dist_loss``) on the bench graph: card against CPU at
   dropout 0 for 2 epochs (losses with ``loss_dist`` within rtol 1e-4),
   7 epochs in scan mode (chunks of 3) against the loop under phase 14's
   rule with phase 8's launches per epoch, one traced loop epoch, and
   the complementor's device time per epoch (measured alone under the
   profiler) over the traced epoch's;
20. the dense and gather adjacencies against blocked: KT-GNN and
   GraphSAGE under each method on ``make_sync_dataset`` at its defaults
   (3,500 nodes) and ``make_benchmark_graph(n=8192)``: 8 loop and 12
   scan epochs (medians), predict ×10 (median) and each run's peak
   device memory; the methods' loop losses within rtol 1e-4 of
   blocked's; the dense-node threshold these times support (the largest
   measured size where KT-GNN's loop and scan epochs and predict are no
   slower on dense) printed beside ``ops/spmm.py::DENSE_MAX_NODES``;
21. stage 1, the stage-1 CLI's default model (``--version v1``: SAGE
   encoder, cosine head; hidden 128, 2 layers, 40,000-pair samples, 8
   classes) on the JAX package's production-scale stage-1 graph
   (``make_sync_dataset("relational-intra", n_src=20000, n_tar=15000,
   dim=128, num_classes=8, avg_degree=10, seed=0)``, its
   ``dataset_conversion(seed=0)``): the padded SpMM calls of one
   training step (4 forwards and 3 transposed at D=128) replayed as in
   phase 16; 30 loop epochs evaluating at 20, 25 and 30 (7 launches a
   step, 8 an evaluation, no other kernel; epoch and evaluation medians
   on the host clock); one epoch traced as phase 10's; card against CPU
   for 2 epochs at dropout 0 from the same init and pairs: the sim, d
   and AE losses within rtol 1e-4, weights within phase 11's tolerances
   or, where they part, elements whose gradient (with the L2 term) lay
   within 1e-6 of 0 at a step of the CPU run, each within 2·lr a step
   (Adam's step there is set by rounding: the similarity head's biases
   that a batch norm removes are such), and lin_self_2's running mean
   within what those biases move it;
22. the bridge from phase 21's model (k_cross 20, k_within 3, both
   filters, row block 1000): the encode, the cross top-k, each within
   top-k and the filters and merge timed, the top-ks beside their
   matmul's bound (2·R·C·H f32 operations), edges, homophily and peak
   device memory; the same build on the CPU with the same weights,
   whose edges must equal the card's but for named near-ties (a top-k
   pair within 1e-5 of its row's k-th, a filter's quantile cut within
   1e-5, a classifier argmax within 1e-5 of a tie); a v2 model (MLP
   backbone, mlp head, 4 epochs) through the mlp head's bridge, with and
   without the bf16-screened rerank of 200 candidates, each with its
   peak memory;
23. ``run.sh`` recipe 0 through the port's two CLIs in this process:
   the stage-1 CLI with the recipe's flags (``--version v2``), the same
   with ``--version v1`` (its SpMM launches counted: 7 a step, 8 an
   evaluation and the bridge's encodes, by width), and the stage-2 CLI
   on the v2 run's npz, which must print ``[stage-2 best]``;
24. stage 1 in scan mode on phase 21's graph and model: (a) 30 epochs in
   segments of 10 ending on the evaluations at 20, 25 and 30, pairs
   sampled on the host, against phase 21's loop on the same pairs: losses
   within rtol 1e-4 (capturable against foreach Adam, phase 14's rule),
   the same best epoch, 7 SpMM launches at D=128 a replay and no other
   kernel, 2 eager epochs and one capture counted; (b) the same with
   ``device_sampling`` (its epoch median, and the device evaluator's 4
   launches an evaluation), a 20-epoch run without evaluations traced as
   phase 10's on its second segment (10 replays: busy share, top ops,
   the kernel's ms per replayed epoch), and one epoch of the device
   samplers' pairs checked on the host (train rows, m classes of
   per_class ids a side, pair_enumeration order, (per_class·m)² pairs,
   targets from the labels); (c) ``DeviceStage1Evaluator.both`` against
   the host evaluator on phase 21's model (medians of 5 calls each),
   ``both(e)`` equal to the per-split calls, each score ``eval_metric``'s
   over the pairs it drew, 4 launches a call; (d) a device-sampled run
   resumed from its first segment's checkpoint, bit-identical to the
   straight run;
25. ``run_pipeline`` on ``RECIPES["office_amazon2dslr_tpu"]``'s settings
   with ``dataset_name="sync_unrelational"``, cut to 40 stage-1 epochs
   (evaluating from 30) and 60 stage-2 epochs: the npz, each stage's
   seconds, the bf16 attention and reduce kernels launched in stage 2;
   then ``python -m bridged_gnn_tpu_torch.pipeline --config`` on its
   JSON in a process of its own, which must print the three result
   lines;
26. similarity serving: a ``SimilarityScorer`` of phase 22's v2 model
   (mlp head, exact), its top-20 of all 15,000 target rows against the
   bridge's cross proposals, 256 rows against the same scorer on the CPU
   (equal but for named near-ties within 1e-5), and ``/healthz``,
   ``/meta`` and ``/v1/topk`` over HTTP (medians of 10 requests of 1 and
   256 rows);
27. multi-device stage 2: (a) the native library's coalesce and dst-sort
   of 5M seeded edges against numpy (equal; seconds of each); (b) two
   ranks sharing the card under gloo (``parallel.multihost.spawn``), on
   the bench graph at dropout 0, for the halo partition, its overlap
   form, the edge shards and KTGNN_noDTC on the halo: one sharded step's
   kernel calls replayed against their plain versions on each rank in
   turn, then 5 loop epochs with the counts at 0 just before, the
   launches per rank per epoch asserted, every epoch's losses within
   rtol 1e-4 of the single-device run's; per rank the epoch ms, the
   exchange ms with its pinned-memory staging apart and the wire bytes
   per layer; rank 0 traced for 2 epochs of the first two cases; (c) a
   1-rank NCCL group in this process drives ``HaloStage2Backend`` on a
   1-shard partition for 2 epochs, against the single-device run;
28. the rest of multi-device, on the bench graph (dropout 0) and phase
   21's stage-1 graph: (a) two gloo ranks sharing the card (spawned once
   for (a), (c) and (d)) train KT-GNN on the halo layout, in its overlap
   form and on the edge shards in scan mode, 10 epochs in chunks of 5,
   every epoch eager: each epoch's losses within rtol 1e-4 of the
   single-device loop's, the same best epoch, both ranks equal, the
   launches per rank per epoch asserted; (b) a 1-rank NCCL group in this
   process trains the halo layout and its overlap form in scan mode for
   12 epochs each through ``train_ktgnn(group=...)``: the epoch, its
   collectives included (the overlap's exchange in flight while its
   local partials run), captured once after the 2 warm-up epochs and
   replayed 10 times, a replay's launches asserted, losses within rtol
   1e-4 of the single-device scan run and the same best epoch, one chunk
   of replays traced (busy share, what the collectives became on the
   device); the overlap form's step, its ``gather_reduce`` calls
   replayed against their plain version (the one rank's halo set has no
   real edge: those calls give zeros); (c) stage 1 v1 row-sharded over
   the two ranks for 6 epochs, evaluating at 4 and 6: one step's
   ``gather_reduce`` calls replayed against their plain versions on each
   rank, the all-gather of a 128-wide layer input timed per domain, the
   launches asserted, losses within rtol 1e-4 of the single device's
   from the same pairs; then over the NCCL group in scan mode, captured,
   against the single-device scan run; (d) phase 22's bridge (v1 cosine;
   v2 mlp, exact and reranked) with ``mesh=`` the two ranks: the exact
   builds equal to the single device's but for named near-ties within
   1e-5, the rerank keeping only columns at least as good as the single
   device's screen finds (its screen sees each shard's top candidates),
   seconds per part; (e) ``run_pipeline(elastic=True)`` on phase 25's
   settings cut to 10 epochs a stage, stage 2's first attempt meeting a
   real CUDA out-of-memory error (a wrapper here asks for twice the
   card's memory): one retry, the straight run's best, the memory
   allocated at the retry's start what it was at the first attempt's.

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
over one epoch's replayed calls, the hub loop's ms and the wide calls,
and its launches on phase 17's served GraphSAGE predict and phase 18's
ConvNet epoch; phase 21's training run adds its launches to the count
(``launches_stage1_by_d``, ``ms_stage1`` per epoch, one step's replayed
calls in ``stage1_replay``), and so do phase 24's scan runs
(``launches_stage1_scan_by_d``; ``ms_stage1_scan_per_replayed_epoch``
from the traced segment); phase 25's bf16 launches join the bf16 rows'
counts (``launches_pipeline``); phase 27's launches (both ranks of every
case and the NCCL rank) join the f32 rows' counts
(``launches_sharded_by_d``), beside their replayed calls
(``sharded_replay``); phase 28's sharded scan runs (both ranks of each
case, the NCCL rank's eager epochs and captures) join them as
``launches_sharded_scan_by_d``, its NCCL overlap step's replayed calls
join ``gather_reduce``'s row as ``sharded_nccl_overlap_replay``, and its
row-sharded stage-1 runs join
``gather_reduce``'s count as ``launches_stage1_sharded_by_d``. The last
line is ``{"ok": true, "device":
{...}}``. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
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
# phases 3-16 hold the kernels against their plain versions: they ask for
# the slot layouts ("blocked": one layout, or tiers where the skew rule
# fires), whatever "auto" would pick
KERNEL_METHOD = "blocked"
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


# ------------------------------------------------ the conv prologue

PROLOGUE_ROWS = 131072     # the benchmark's KT-GNN cells' nodes
PROLOGUE_CONVS = ((256, 64), (64, 31))   # their first conv and heads
PROLOGUE_PADDING = 1000    # rows in neither domain
# the prologue wrappers that add into an argument: its index
_PROLOGUE_INPLACE = {"conv_prologue_bwd_finish": 2, "conv_prologue_dx": 0}


def _prologue_args(name, inputs):
    """A wrapper's recorded arguments, the one it adds into cloned."""
    i = _PROLOGUE_INPLACE.get(name)
    if i is None:
        return tuple(inputs)
    args = list(inputs)
    args[i] = args[i].clone()
    return tuple(args)


def _prologue_outs(name, args, result):
    """A wrapper's outputs, the argument it added into last."""
    outs = _outs(result)
    i = _PROLOGUE_INPLACE.get(name)
    return outs if i is None or outs[0] is args[i] else outs + (args[i],)


def prologue_bound(inputs, outs):
    """Least time of one prologue call: every tensor argument read once
    and every output written once (an argument added into: read and
    written), over HBM_BYTES_PER_S. The per-row work is a few operations
    an element, far below the bytes' time."""
    import torch

    total = sum(t.numel() * t.element_size()
                for t in list(inputs) + list(outs)
                if isinstance(t, torch.Tensor))
    return total / HBM_BYTES_PER_S * 1e3


def check_prologue_calls(recs, plain_reps=PLAIN_REPS):
    """Replay each recorded conv prologue call through its kernel (twice,
    bit-identical) and its plain version on the card, the argument a
    wrapper adds into cloned for each call. Floats within rtol ``RTOL``
    (``RTOL + BF16_ULP`` for a bf16 output) and atol ``ATOL`` times the
    output's largest magnitude; the per-block partial rows are compared
    by their sums over the blocks, in float64. Returns per-call records
    with errors, times (``ms`` the wrapper's host work included,
    ``device_ms`` the card's alone) and the byte bound."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    out = []
    for i, rec in enumerate(recs):
        name, inputs = rec["name"], rec["inputs"]
        wrapper, plain = getattr(fk, name), getattr(fk, name + "_plain")
        where = f"{name} at D={rec['d']} ({rec['dtype']}), call {i}"
        args = _prologue_args(name, inputs)
        got = _prologue_outs(name, args, wrapper(*args))
        again_args = _prologue_args(name, inputs)
        again = _prologue_outs(name, again_args, wrapper(*again_args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{where}: two launches on the same inputs "
                               "differ")
        del again, again_args
        plain_args = _prologue_args(name, inputs)
        want = _prologue_outs(name, plain_args, plain(*plain_args))
        abs_err = norm_err = 0.0
        for g, w in zip(got, want, strict=True):
            rtol = RTOL + (BF16_ULP if g.dtype == torch.bfloat16 else 0.0)
            if g.shape != w.shape:     # partial rows: per block, or one
                g, w = (g.double().sum(0, keepdim=True),
                        w.double().sum(0, keepdim=True))
            g, w = g.double(), w.double()
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{where}: non-finite kernel output")
            diff = (g - w).abs()
            w_max = float(w.abs().max()) if w.numel() else 0.0
            err = float(diff.max()) if diff.numel() else 0.0
            abs_err = max(abs_err, err)
            norm_err = max(norm_err, err / max(w_max, 1e-30))
            if not torch.allclose(g, w, rtol=rtol, atol=ATOL * w_max):
                raise RuntimeError(f"{where} disagrees with its plain "
                                   f"version: max abs err {err:.3g} (atol "
                                   f"{ATOL * w_max:.3g})")
        timed = _prologue_args(name, inputs)
        t_bytes = prologue_bound(inputs, got)
        out.append(dict(
            name=name, call=i, d=rec["d"],
            dtype=str(rec["dtype"]).replace("torch.", ""),
            rows=int(next(t for t in inputs
                          if isinstance(t, torch.Tensor)).shape[0]),
            ms=cuda_ms(lambda: wrapper(*timed), KERNEL_REPS),
            device_ms=cuda_device_ms(lambda: wrapper(*timed), KERNEL_REPS),
            plain_ms=cuda_ms(lambda: plain(*timed), plain_reps, warmup=1),
            bound_ms=t_bytes, bytes_ms=t_bytes, ops_ms=0.0,
            bound_by="bytes", max_abs_err=abs_err,
            max_err_over_max_abs=norm_err, library_ms=None))
        del got, want, timed, args, plain_args
    return out


def prologue_phase(card: str) -> dict:
    """Phase 3 (b): AdaptedConv's prologue at the benchmark's shapes, in
    f32 and bf16 message tables: for each of PROLOGUE_CONVS an AdaptedConv
    over PROLOGUE_ROWS seeded rows (PROLOGUE_PADDING of them in neither
    domain), its prologue's forward and backward recorded (the first
    conv's input takes no gradient, the heads' does, as on the main
    path), every call replayed against its plain version
    (:func:`check_prologue_calls`). Returns the records by message
    dtype."""
    import torch

    from bridged_gnn_tpu_torch.nn.ktgnn import AdaptedConv
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    t0 = time.perf_counter()
    out = {}
    n = PROLOGUE_ROWS
    for tables in (None, "bfloat16"):
        recs = []
        for i, (d, h) in enumerate(PROLOGUE_CONVS):
            seed = BENCH["seed"] + d + h
            conv = AdaptedConv(d, h, msg_dtype=tables,
                               generator=torch.Generator().manual_seed(seed))
            conv = conv.cuda()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randn(n, d, generator=gen, device="cuda") + 0.5
            x.requires_grad_(i > 0)
            node = torch.arange(n, device="cuda") < n - PROLOGUE_PADDING
            cm = torch.rand(n, generator=gen, device="cuda") < 0.5
            central, target = cm & node, ~cm & node
            with fk.record_launches(keep_inputs=True) as calls:
                u_t2s, u_s2t, _ = conv._branch(x, None, central, target)
                w1 = torch.randn(u_t2s.shape, generator=gen,
                                 device="cuda").to(u_t2s.dtype)
                w2 = torch.randn(u_s2t.shape, generator=gen,
                                 device="cuda").to(u_s2t.dtype)
                ((u_t2s * w1).float().sum()
                 + (u_s2t * w2).float().sum()).backward()
            torch.cuda.synchronize()
            names = [r["name"] for r in calls]
            want = list(PROLOGUE) if i > 0 else list(PROLOGUE[:-1])
            if names != want:
                raise RuntimeError(f"prologue {d}->{h}: launched {names}, "
                                   f"not {want}")
            recs += calls
            del conv, x, u_t2s, u_s2t, w1, w2
        with torch.no_grad():
            out[tables or "float32"] = check_prologue_calls(recs)
        del recs, calls
        torch.cuda.empty_cache()
    for dtype, recs in out.items():
        for r in recs:
            log(json.dumps(dict(phase="prologue", tables=dtype, card=card,
                                **r)))
    log(f"phase 3b (the conv prologue at {n} rows, D = "
        f"{PROLOGUE_CONVS}): {time.perf_counter() - t0:.1f} s [{card}]")
    return out


def prologue_rows(prologue, train, card) -> list:
    """The kernels line's rows of the conv prologue: one per wrapper (its
    f32 calls), and one more for the epilogue's and the backward pass's
    bf16 instantiations (``<name>_bf16``). ``ms``, ``plain_ms``,
    ``bound_ms`` and ``max_abs_err`` sum or take the largest over the
    replayed calls of phase 3 (b), one forward and backward of each of
    PROLOGUE_CONVS at PROLOGUE_ROWS rows (``per``); the launches and the
    in-run ms per epoch are phase 8's, on the bench graph."""
    src = "bridged_gnn_tpu_torch/csrc/conv_prologue.cu"
    replaces = ("bridged_gnn_tpu/nn/ktgnn.py AdaptedConv's prologue "
                "(XLA-fused on the TPU)")
    per = (f"forward and backward of convs {PROLOGUE_CONVS} at "
           f"{PROLOGUE_ROWS} rows")
    rows = []
    for dtype, suffix, names in (("float32", "", PROLOGUE),
                                 ("bfloat16", "_bf16",
                                  ("conv_prologue_epilogue",
                                   "conv_prologue_bwd"))):
        for name in names:
            recs = [r for r in prologue[dtype] if r["name"] == name]
            row = summary_row(f"{name}{suffix}", src, replaces, recs,
                              train["launches"][name],
                              sum(r["ms"] for r in recs), per, card)
            row.update(dtype=dtype, calls=[{k: r[k] for k in (
                "d", "rows", "ms", "device_ms", "plain_ms", "bound_ms",
                "max_abs_err")} for r in recs],
                ms_per_epoch_bench=train["kernel_ms_per_epoch"][name],
                launches_per_epoch_by_d=train["launches_per_epoch_by_d"][
                    name])
            rows.append(row)
    return rows


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
    if any(r["name"] not in (kernel.__name__,) + PROLOGUE for r in recs):
        raise RuntimeError(f"{name}: launches of another kernel recorded")
    kernel_ms = [sum(r["start"].elapsed_time(r["stop"])
                     for r in of(recs[a:b], kernel.__name__))
                 for a, b in zip(marks, marks[1:])]
    launch_ms_by_d = {
        d: statistics.median(r["start"].elapsed_time(r["stop"])
                             for r in of(recs, kernel.__name__)
                             if r["d"] == d)
        for d in want_by_d}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, pred.graph.num_features)).astype(np.float32)
    live_full = pred.predict_live(x)
    nodes = rng.choice(n, size=64, replace=False)
    live_rows = pred.predict_live(x[nodes], nodes)
    launches = kernel.launches
    calls = 1 + 2 * reps + 2
    # every predict runs the four convs' prologues besides
    prologue = prologue_want(pred.graph.num_features, HIDDEN,
                             forwards=calls)
    other = {k: c for k, c in fk.launch_counts().items()
             if c and k != kernel.__name__}
    if by_d != want_by_d or launches != calls * per_predict \
            or other != prologue:
        raise RuntimeError(
            f"{name}: {kernel.__name__} launched {by_d} (by width) in one "
            f"predict (expected {want_by_d}) and {launches} in {calls} "
            f"calls; other kernels {other}, expected {prologue}")
    for what, preds in (("predict", first), ("live full", live_full),
                        ("live rows", live_rows)):
        check_heads(preds, n, num_classes, f"{name} {what}")

    t0 = time.perf_counter()
    ref = KTGNNPredictor(copy.deepcopy(model), None, data,
                         adjacency_method=KERNEL_METHOD, device="cpu")
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


def http_phase(pred, app=None) -> dict:
    """/healthz, a cached and a live /v1/predict through ``make_server``
    on an ephemeral port, for ``app`` (by default a ServingApp of
    ``pred``)."""
    from bridged_gnn_tpu_torch.cli.serve import ServingApp, make_server

    app = app or ServingApp(predictor=pred)
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
        (fwd.__name__, bwd.__name__, "slot_reduce") + PROLOGUE)
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
            fk.slot_reduce: {HIDDEN: e * lays, num_classes: 3 * e * lays},
            **{getattr(fk, k): v for k, v in prologue_want(
                data["x"].shape[1], HIDDEN, forwards=2 * e,
                backwards=e).items()}}
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
    r"attention_\w*_kernel|slot_reduce_kernel|gather_reduce_kernel"
    r"|conv_prologue_\w+_kernel")
# AdaptedConv's prologue (ops/conv_prologue.py): its wrappers in launch
# order, forward then backward
PROLOGUE = ("conv_prologue_pass", "conv_prologue_finish",
            "conv_prologue_epilogue", "conv_prologue_bwd",
            "conv_prologue_bwd_finish", "conv_prologue_dx")


def prologue_want(d: int, hidden=None, forwards: int = 0,
                  backwards: int = 0, tables=None, calls: int = 1,
                  x_grad: bool = False, recompute: int = 0) -> dict:
    """The conv prologue's launches by wrapper name and launch key in
    ``forwards`` model forwards and ``backwards`` backwards: KT-GNN's conv
    from ``d`` features and its three head calls at ``hidden``, or, with
    ``hidden`` None, KTGNN_noDTC's one conv. A conv call launches a pass,
    a finish and an epilogue forward, a backward pass and finish
    backward, and ``dx`` where its input takes a gradient (the heads',
    the first conv's with ``x_grad``). ``calls`` prologues a conv call
    (2 in the overlap form: own rows, halo rows); ``recompute`` forwards
    of the first conv more (``memory_policy="lean"``); ``tables`` the
    message dtype, which keys the epilogue and the backward pass."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    tables = tables or torch.float32

    def by(n_first, n_heads, dtype=torch.float32):
        out = {fk.launch_key(d, dtype): n_first * calls}
        if hidden is not None:
            key = fk.launch_key(hidden, dtype)
            out[key] = out.get(key, 0) + 3 * n_heads * calls
        return {k: v for k, v in out.items() if v}

    fwd = forwards + recompute
    want = dict(conv_prologue_pass=by(fwd, forwards),
                conv_prologue_finish=by(fwd, forwards),
                conv_prologue_epilogue=by(fwd, forwards, tables),
                conv_prologue_bwd=by(backwards, backwards, tables),
                conv_prologue_bwd_finish=by(backwards, backwards),
                conv_prologue_dx=by(backwards if x_grad else 0, backwards))
    return {k: v for k, v in want.items() if v}


def of(recs: list, *names) -> list:
    """The launch records of the kernels ``names``."""
    return [r for r in recs if r["name"] in names]


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def collective_work(events) -> dict:
    """The collectives' own work in a Chrome trace, by kind: the port
    puts a ``collective:<kind>`` range around each collective call
    (``utils/profiling.py::collective_span``). For each kind, the ranges,
    the CUDA API calls made inside them on their thread, and
    the device operations those calls launched, matched by correlation
    id. A call made inside a CUDA graph capture launches nothing then:
    the graph's replays run its work, and replays carry no ranges, so
    the operations counted here are those of the eager epochs."""
    import bisect

    spans = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("collective:")]
    calls = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            calls.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for v in calls.values():
        v.sort(key=lambda e: float(e["ts"]))
    starts = {k: [float(e["ts"]) for e in v] for k, v in calls.items()}
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in _DEVICE_CATS and corr is not None:
            launched.setdefault(corr, []).append(e)
    out = {}
    for sp in spans:
        rec = out.setdefault(sp["name"].split(":", 1)[1],
                             dict(ranges=0, calls={}, device_ops={}))
        rec["ranges"] += 1
        key = (sp.get("pid"), sp.get("tid"))
        a = float(sp["ts"])
        b = a + float(sp["dur"])
        ts = starts.get(key, [])
        for c in calls.get(key, [])[bisect.bisect_left(ts, a):
                                    bisect.bisect_right(ts, b)]:
            rec["calls"][c["name"]] = rec["calls"].get(c["name"], 0) + 1
            for d in launched.get((c.get("args") or {}).get("correlation"),
                                  []):
                n, ms = rec["device_ops"].get(d["name"], (0, 0.0))
                rec["device_ops"][d["name"]] = (
                    n + 1, ms + float(d["dur"]) / 1e3)
    return out


def trace_phase(name, data, cfg, window=-1, epochs=1, trainer=None) -> dict:
    """Phase 10 (and 14, 21): ``train_ktgnn`` (or ``trainer``, a (module,
    run) pair whose ``run()`` trains with the module's ``EpochTimer``)
    under ``torch.profiler`` with each epoch timer window marked (an
    epoch, or a scan chunk); reads the device operations of window
    ``window`` (the last by default), which holds ``epochs`` epochs, from
    the Chrome trace. Times and counts are per epoch. The mark opens
    after the timer's first synchronize and closes after a synchronize at
    the window's end, so the window's device work lies inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.utils.profiling import EpochTimer

    module, run = trainer or (
        stage2, lambda: stage2.train_ktgnn(data, cfg, device="cuda"))

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
        with mock.patch.object(module, "EpochTimer", MarkedTimer), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            run()
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
    comm = {op: v for op, v in by_name.items()
            if re.search("nccl|gloo|memcpy", op, re.IGNORECASE)}
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
        # every copy and communication op of the window, whatever
        # launched it; the collectives' own are in collective_work
        copies_and_comm=[dict(name=op[:120], ms=ms / epochs,
                              count=n / epochs)
                         for op, (ms, n) in sorted(comm.items())],
        collective_work=collective_work(events),
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
    from bridged_gnn_tpu_torch.train.scan import WARMUP_EPOCHS

    cfg = stage2.Stage2Config(
        adjacency_method=KERNEL_METHOD,
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
            "slot_reduce": {HIDDEN: lays, num_classes: 3 * lays},
            **prologue_want(data["x"].shape[1], HIDDEN, forwards=2,
                            backwards=1)}
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
            1, WARMUP_EPOCHS, SCAN_EPOCHS - WARMUP_EPOCHS):
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
                     msg_dtype=dt), None, data,
        adjacency_method=KERNEL_METHOD, device="cuda")
        for dt in ("bfloat16", None)}
    setup_s = time.perf_counter() - t0
    p16, p32 = preds["bfloat16"], preds[None]
    if (p16.adj.tiered_fn is not None) != tiered:
        raise RuntimeError(f"{name}: expected tiered={tiered} layouts")
    lays = layouts_of(p16.adj)
    with torch.inference_mode():
        recs = check_kernel(kernel.__name__, kernel,
                            getattr(fk, kernel.__name__ + "_plain"),
                            of(record_run(p16.predict,
                                          (kernel.__name__,) + PROLOGUE),
                               kernel.__name__),
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
    # every predict runs the four convs' prologues besides, bf16 tables
    prologue = prologue_want(p16.graph.num_features, HIDDEN,
                             forwards=1 + 2 * reps, tables=bf16)
    other = {k: c for k, c in fk.launch_counts().items()
             if c and k != kernel.__name__}
    if (by_d != want_by_d or launches != (1 + 2 * reps) * sum(
            want_by_d.values()) or other != prologue):
        raise RuntimeError(f"{name}: {kernel.__name__} launched {by_d} in "
                           f"one bf16 predict (expected {want_by_d}), "
                           f"{launches} in all; other kernels {other}, "
                           f"expected {prologue}")
    kernel_ms = [sum(r["start"].elapsed_time(r["stop"])
                     for r in of(events[a:b], kernel.__name__))
                 for a, b in zip(marks, marks[1:])]
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
        adjacency_method=KERNEL_METHOD,
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
            "slot_reduce": {hid: n_layouts, cls: 3 * n_layouts},
            **prologue_want(data["x"].shape[1], HIDDEN, forwards=2,
                            backwards=1, tables=bf16)}
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

    def recording(backend, need_probs):
        # Stage2Backend._eval_arrays on the same forward whose margins it
        # keeps: the predictions are the argmax, whose first class wins an
        # exact tie (topk's order there is unspecified)
        g = backend.g
        with torch.no_grad():
            heads = backend.eval_heads()
            lp = torch.stack(heads)
            first = lp.argmax(-1)
            val, idx = lp.topk(2, dim=-1)
            second = torch.where(idx[..., 0] == first, idx[..., 1],
                                 idx[..., 0])
            preds = first.cpu().numpy()
            evals.append(((val[..., 0] - val[..., 1]).cpu().numpy(),
                          preds.copy(), second.cpu().numpy()))
            probs = (torch.stack([h[:, 1].exp() for h in heads]).cpu()
                     .numpy() if need_probs else None)
        if not graph:
            graph.update({m: getattr(g, m).cpu().numpy() for m in
                          ("y", "train_mask", "val_mask", "test_mask")})
        return preds, probs

    with mock.patch.object(stage2.Stage2Backend, "_eval_arrays",
                           recording):
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


GRAD_TOL = 1e-3          # phase 11: gradients, relative and of the
                         # tensor's largest (a ReLU tie moves its column's
                         # by up to ~5e-4 of the largest)
ZERO_GRAD = 1e-6         # phase 11: a tensor whose gradient stays below
                         # this share of the model's largest on both
                         # devices is zero but for rounding


def parity_steps(name, data, cfg) -> dict:
    """Phase 11: KT-GNN's train step on the card against the CPU's, one
    step at a time: before each of ``cfg.num_epoch`` steps the CPU model
    and its Adam take the card's state, so that each comparison holds one
    step's arithmetic. The losses within LOSS_RTOL; every parameter's
    gradient within GRAD_TOL relative and GRAD_TOL of the tensor's
    largest magnitude (a tensor below ZERO_GRAD of the model's largest on
    both devices, a linear's bias before a batch norm, is zero but for
    rounding); the batch norms' statistics after the step within
    WEIGHT_RTOL and WEIGHT_ATOL. Every first ReLU input (the first batch
    norm's output) whose sign the devices part must lie within TIE_ATOL
    of 0: a tie, listed with its column c. A tie passes or stops one
    node's gradient in column c, so the gradient elements apart must lie
    in rows c of the first conv's linears, biases and attention vectors
    or at c of the first batch norm's. Adam's step itself is torch's on
    both devices and is not compared: it divides each gradient by its own
    size, so where weight decay or the momentum cancels a gradient a
    rounding apart moves the weight by a share of a step. Returns the
    steps' errors and ties."""
    import torch

    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.train.optim import make_optimizer

    n = data["x"].shape[0]
    side = []
    for dev in ("cuda", "cpu"):
        g, adj = stage2.prepare_stage2_graph(data, cfg, dev)
        model = stage2.build_model(cfg, g.num_classes, g.num_features, dev)
        opt, _ = make_optimizer(model.parameters(), cfg.lr,
                                cfg.weight_decay, False, cfg.step_size,
                                cfg.gamma)
        seen = []
        model.bns[0].register_forward_hook(
            lambda m, i, o, seen=seen: seen.append(o.detach().cpu()[:n])
            if m.training else None)
        side.append(dict(g=g, adj=adj, model=model, opt=opt, seen=seen))
    card, cpu = side
    steps, cpu_s = [], 0.0
    for step in range(cfg.num_epoch):
        cpu["model"].load_state_dict(card["model"].state_dict())
        cpu["opt"].load_state_dict(card["opt"].state_dict())
        got = []
        for s_ in (card, cpu):
            t0 = time.perf_counter()
            s_["seen"].clear()
            s_["opt"].zero_grad(set_to_none=True)
            loss, aux = stage2.stage2_loss(s_["model"], s_["g"], s_["adj"],
                                           cfg.Lambda, None)
            loss.backward()
            grads = {k: p.grad.detach().cpu().clone()
                     for k, p in s_["model"].named_parameters()
                     if p.grad is not None}
            s_["opt"].step()
            if s_ is cpu:
                cpu_s += time.perf_counter() - t0
            stats = {k: v.detach().cpu().clone()
                     for k, v in s_["model"].named_buffers()}
            got.append(dict(loss=float(loss.detach()),
                            loss_t2=float(aux["loss_t2"]), grads=grads,
                            stats=stats, relu=s_["seen"][0]))
        a, b = got
        where = f"{name} step {step}"
        loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                       for k in ("loss", "loss_t2"))
        if loss_err > LOSS_RTOL:
            raise RuntimeError(f"{where}: card vs CPU losses differ by "
                               f"{loss_err:.3g} > {LOSS_RTOL}")
        flips = torch.nonzero((a["relu"] > 0) != (b["relu"] > 0)).tolist()
        ties = [dict(node=int(v), column=int(c),
                     card=float(a["relu"][v, c]), cpu=float(b["relu"][v, c]))
                for v, c in flips]
        if any(max(abs(t["card"]), abs(t["cpu"])) > TIE_ATOL for t in ties):
            raise RuntimeError(f"{where}: a first ReLU input parts beyond a "
                               f"tie: {ties[:10]}")
        if a["grads"].keys() != b["grads"].keys():
            raise RuntimeError(f"{where}: gradients of {set(a['grads'])} "
                               f"against {set(b['grads'])}")
        columns = {t["column"] for t in ties}
        largest = max(float(t.abs().max()) for t in b["grads"].values())
        grad_err, zero, apart = {}, [], {}
        for k, want in b["grads"].items():
            have = a["grads"][k]
            top = max(float(have.abs().max()), float(want.abs().max()))
            if top <= ZERO_GRAD * largest:
                zero.append(k)
                continue
            err = float((have - want).abs().max())
            grad_err[k] = err / float(want.abs().max())
            far = ~torch.isclose(have, want, rtol=GRAD_TOL,
                                 atol=GRAD_TOL * float(want.abs().max()))
            tied = (k.startswith("convs.0.") and ".a_g_" not in k
                    or k.startswith("bns.0."))
            for idx in torch.nonzero(far).tolist():
                if not (tied and idx and idx[0] in columns):
                    raise RuntimeError(
                        f"{where}: card vs CPU gradient {k}{idx} "
                        f"{float(have[tuple(idx)])!r} against "
                        f"{float(want[tuple(idx)])!r} ({grad_err[k]:.3g} of "
                        f"its largest at most), which no ReLU tie explains "
                        f"(ties {ties[:10]})")
                apart.setdefault(k, []).append(idx)
        stat_err = 0.0
        for k, want in b["stats"].items():
            have = a["stats"][k]
            if not want.is_floating_point():
                if not torch.equal(have, want):
                    raise RuntimeError(f"{where}: {k} {have} against {want}")
                continue
            stat_err = max(stat_err, float((have - want).abs().max()))
            if not torch.allclose(have, want, rtol=WEIGHT_RTOL,
                                  atol=WEIGHT_ATOL):
                raise RuntimeError(f"{where}: card vs CPU {k} parts")
        steps.append(dict(step=step, loss_card=a["loss"], loss_cpu=b["loss"],
                          max_rel_loss_err=loss_err,
                          max_grad_err_over_largest=max(grad_err.values()),
                          grad_err_over_largest=grad_err,
                          zero_grads=zero, max_abs_stat_err=stat_err,
                          relu_ties=ties,
                          grads_apart_in_tied_columns=apart))
    return dict(phase=name, steps=steps, nodes=n, cpu_s=cpu_s)


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
                                  to_undirected=True,
                                  adjacency_method=KERNEL_METHOD), **kw})


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
    inputs = stage2.model_inputs(data, cfg, g)
    layouts = layouts_of(adj)
    if len(layouts) != layouts_want:
        raise RuntimeError(f"zoo replay: {len(layouts)} layout(s), not "
                           f"{layouts_want}")

    backend = stage2.Stage2Backend(model, g, adj, inputs, cfg,
                                   g.num_classes)

    def epoch():
        backend.train_step(opt, gen)
        backend.eval_heads()

    recs = [r for r in record_run(epoch, ("gather_reduce",))
            if width is None or r["d"] == width]
    out = check_gather_calls(recs, layouts)
    if panel_check:
        with torch.no_grad():
            i = next(i for i, r in enumerate(recs) if r["d"] == PANEL_CHECK_D)
            out[i]["panel_widths_bit_identical"] = check_panel_widths(
                recs[i]["inputs"])
    del recs, model, opt, inputs
    torch.cuda.empty_cache()
    return out


def check_gather_calls(recs, layouts) -> list:
    """Recorded gather_reduce calls replayed against the plain version
    (the reduce's tolerance: rtol 1e-4, atol 1e-4 × the output's largest
    magnitude), launched twice for bit-identical outputs, timed beside
    their bound, torch.sparse.mm and index_add_, with their panels,
    gathered bytes and rate."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

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
    kernels and its conv's prologue (one layout)."""
    return {
        "GraphSAGE": {"gather_reduce": {f: 2, h: 3}},
        "GIN": {"gather_reduce": {f: 2, h: 3}},
        "GCN": {"gather_reduce": {h: 3, c: 3}},
        "JKNet": {"gather_reduce": {h: 6}},
        "GCN2": {"gather_reduce": {h: 6}},
        "APPNP": {"gather_reduce": {c: 30}},
        "GAT": {}, "GATv2": {}, "DeeperGCN": {}, "MLP": {},
        "KTGNN_noDTC": {"attention_sel_fwd": {c: 2},
                        "attention_sel_bwd": {c: 1}, "slot_reduce": {c: 1},
                        **prologue_want(f, forwards=2, backwards=1)},
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
    from bridged_gnn_tpu_torch.train.scan import WARMUP_EPOCHS

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
                1, WARMUP_EPOCHS,
                ZOO_SCAN_EPOCHS - WARMUP_EPOCHS) \
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
                                      num_epoch=ZOO_OTHER_EPOCHS,
                                      adjacency_method=KERNEL_METHOD, **extra)
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


# ----------------------------------- phases 17-20: the rest of stage 2

SERVE_ZOO_EPOCHS = 2     # phase 17: each checkpoint's training run
CONVNET_EPOCHS = 2       # phase 18: loop epochs on the bench graph
# phase 19: KT-GNN with the complementor (half the features observed, two
# frontiers, the distribution loss); loop and scan epochs on the bench
# graph (scan: 2 eager epochs, one capture, 5 replays)
COMPLEMENT = dict(need_complement=True, dim_share=64, use_dist_loss=True,
                  complement_step=2)
COMPLEMENT_EPOCHS = 7
COMPLEMENT_CHUNK = 3
PATH_METHODS = ("dense", "gather", "blocked")   # phase 20
PATH_LOOP_EPOCHS = 8     # phase 20: medians of epochs 3-8
PATH_SCAN_EPOCHS = 12    # phase 20: chunks of 5, 5 and 2
PATH_SCAN_CHUNK = 5


def serve_zoo_phase(name, path, ckpt, flags, data, reps: int) -> dict:
    """Phase 17 for one checkpoint: the port's serving CLI loads it
    (``_load_predictor``, ``flags`` naming the model) on the card and on
    the CPU; the card's kernel calls of one predict are replayed against
    their plain versions; counts at 0, one predict's launches; predict
    ×``reps`` on the host clock (median); card against CPU log-probs
    within LOGPROB_ATOL; the app over HTTP (healthz, a cached and a live
    predict)."""
    import torch

    from bridged_gnn_tpu_torch.cli import serve as tcli
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    argv = ["--mode", "predictor", "--ckpt", ckpt, "--path_data", path,
            "--to_undirected"] + flags
    t0 = time.perf_counter()
    app = tcli._load_predictor(tcli.build_argparser().parse_args(
        argv + ["--device", "cuda"]))
    setup_s = time.perf_counter() - t0
    pred = app.predictor
    lays = layouts_of(pred.adj)
    kernels = {fk.gather_reduce.__name__: (fk.gather_reduce,
                                           fk.gather_reduce_plain),
               fk.attention_sel_fwd.__name__: (fk.attention_sel_fwd,
                                               fk.attention_sel_fwd_plain)}
    recs = record_run(pred.predict, tuple(kernels) + PROLOGUE)
    kname = next(r["name"] for r in recs if r["name"] in kernels)
    recs = of(recs, kname)
    wrapper, plain = kernels[kname]
    with torch.inference_mode():
        replay = check_kernel(
            kname, wrapper, plain, recs, lays, scaled=True,
            **(dict(bound=gather_bound) if wrapper is fk.gather_reduce
               else {}))
    del recs
    fk.reset_launch_counts()
    first = pred.predict()
    launches = {n: c for n, c in fk.launch_counts().items() if c}
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.predict()
        times.append(time.perf_counter() - t0)
    n, c = data["x"].shape[0], int(np.asarray(data["y"]).max()) + 1
    check_heads(first, n, c, name)
    t0 = time.perf_counter()
    cpu = tcli._load_predictor(tcli.build_argparser().parse_args(
        argv + ["--device", "cpu"])).predictor.predict()
    cpu_s = time.perf_counter() - t0
    err = max(float(np.abs(first[h] - cpu[h]).max()) for h in HEADS)
    if err > LOGPROB_ATOL:
        raise RuntimeError(f"{name}: card vs CPU log-probs differ by "
                           f"{err:.3g} > {LOGPROB_ATOL}")
    http = http_phase(pred, app)
    return dict(
        phase=name, model=app.meta["model_name"], setup_s=setup_s,
        layouts=len(lays), node_block=lays[0].node_block,
        edges=int(pred.graph.num_edges), launches_per_predict=launches,
        predict_ms_median=statistics.median(times) * 1e3,
        predict_ms=[t * 1e3 for t in times], max_abs_logprob_err_vs_cpu=err,
        cpu_predict_s=cpu_s, http=http, replay=replay)


def serve_zoo(bench, card: str) -> list:
    """Phase 17: a GraphSAGE checkpoint trained by the port's training CLI
    (``--no_dtc``, SERVE_ZOO_EPOCHS epochs, ``--save``) on a ``.dat`` of
    the bench graph, served with ``--model_name GraphSAGE``; a KTGNNNoDTC
    checkpoint of ``train_ktgnn`` (``save_best_path``) served with
    ``--no_dtc``."""
    import contextlib as cl
    import io

    from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as cli
    from bridged_gnn_tpu_torch.train import stage2

    out = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.dat")
        write_dat(path, bench)
        args = cli.build_argparser().parse_args([
            "--path_data", path, "--no_dtc", "--num_epoch",
            str(SERVE_ZOO_EPOCHS), "--to_undirected", "--save",
            "--ckpt_dir", tmp, "--dataset_name", "bench", "--log_every",
            "0"])
        with cl.redirect_stdout(io.StringIO()):
            cli.main(args)
        sage = os.path.join(tmp, "model_GraphSAGE_bench_best.pkl")
        no_dtc = os.path.join(tmp, "model_KTGNN_noDTC_bench_best.pkl")
        stage2.train_ktgnn(bench, stage2.Stage2Config(
            model_name="KTGNN_noDTC", num_epoch=SERVE_ZOO_EPOCHS,
            to_undirected=True, save_best_path=no_dtc), device="cuda")
        # KTGNN_noDTC's one conv runs the prologue once a predict
        for name, ckpt, flags, kernel, prologue in (
                ("serve_zoo_graphsage", sage, ["--model_name", "GraphSAGE"],
                 "gather_reduce", {}),
                ("serve_zoo_no_dtc", no_dtc, ["--no_dtc"],
                 "attention_sel_fwd",
                 prologue_want(bench["x"].shape[1], forwards=1))):
            rec = serve_zoo_phase(name, path, ckpt, flags, bench,
                                  PREDICT_REPS)
            got = rec["launches_per_predict"]
            if set(got) != {kernel, *prologue} or \
                    {k: got[k] for k in prologue} != prologue:
                raise RuntimeError(f"{name}: a predict launched {got}")
            log(json.dumps(dict(card=card, **rec)))
            out.append(rec)
    return out


def convnet_phase(bench, c: int, card: str) -> dict:
    """Phase 18: ConvNet (two SplineConvs, dim 1, kernel size 2: K = 2
    weighted SpMMs per conv, at D = 16 and at the classes) on the bench
    graph with seeded pseudo-coordinates in [0, 1] as its ``edge_attr``:
    the gather_reduce calls of one epoch replayed against their plain
    version (phase 16's tolerance), CONVNET_EPOCHS loop epochs with their
    launches asserted, and card against CPU at dropout 0 (phase 16's rule;
    ConvNet's ELU has no kink, so no tie can part the weights)."""
    from bridged_gnn_tpu_torch.train import stage2

    rng = np.random.default_rng(BENCH["seed"])
    data = dict(bench, edge_attr=rng.random(
        (bench["edge_index"].shape[1], 1)).astype(np.float32))
    cfg = stage2.Stage2Config(model_name="ConvNet", num_epoch=CONVNET_EPOCHS,
                              adjacency_method=KERNEL_METHOD)
    replay = zoo_replay(data, cfg, 1)
    if not all(r["weighted"] for r in replay):
        raise RuntimeError("convnet: an unweighted SpMM call")
    for r in replay:
        log(json.dumps(dict(kernel="gather_reduce", graph="bench_convnet",
                            card=card, **r)))
    # per epoch: the K = 2 forwards of each conv in the step and in the
    # eval, and the two transposed SpMMs of each conv's x-gradient
    rec = zoo_train("convnet_bench", data, cfg,
                    {"gather_reduce": {16: 6, c: 6}}, 1)
    log(json.dumps(dict(card=card, **rec)))
    parity = parity_phase("convnet_parity", data, dataclasses.replace(
        cfg, dropout=0.0))
    log(json.dumps(dict(card=card, **parity)))
    return dict(replay=replay, train=rec, parity=parity)


def complementor_device_ms(data, cfg, prepared, reps: int = 3) -> dict:
    """The complementor's device time in one epoch, measured alone on the
    epoch's inputs under ``torch.profiler`` (the sum of its device ops,
    as ``trace_phase`` sums an epoch's): its train-mode forward with the
    backward of its output (a random cotangent) and ``loss_dist``, and its
    eval-mode forward; the mean of ``reps`` after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bridged_gnn_tpu_torch.train import stage2

    g = prepared[0]
    inputs = stage2.model_inputs(data, cfg, g)
    model = stage2.build_model(cfg, g.num_classes, g.num_features, "cuda")
    comp = model.complementor
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    args = (g.x, inputs["frontiers"], g.central_mask, g.node_mask, gen)
    ct = torch.randn(g.num_nodes_padded, comp.input_layer_o.weight.shape[0]
                     + comp.input_layer_u.weight.shape[0], device="cuda")

    def train():
        comp.train()
        out, ld = comp(*args)
        ((out * ct).sum() + ld).backward()

    def evaluate():
        comp.eval()
        with torch.no_grad():
            comp(*args)

    out = dict(frontier_edges=[int(m.sum()) for _, _, m in
                               inputs["frontiers"]])
    for name, fn in (("train_fwd_bwd", train), ("eval_fwd", evaluate)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        out[name] = sum(float(e["dur"]) for e in events
                        if e.get("ph") == "X"
                        and e.get("cat") in _DEVICE_CATS) / 1e3 / reps
        out[name + "_host_ms"] = cuda_ms(fn, KERNEL_REPS)
    return out


def complementor_phase(bench, c: int, card: str) -> dict:
    """Phase 19: KT-GNN with the feature complementor (COMPLEMENT) on the
    bench graph. Card against CPU: 2 epochs at dropout 0 (the
    complementor's coefficients too), the losses (``loss_dist``
    included) within LOSS_RTOL. Loop and scan mode (chunks of
    COMPLEMENT_CHUNK) at the defaults (dropout 0.5): phase 14's agreement
    rule, the kernels launched as phase 8's per epoch (the complementor
    launches none), epoch medians; one loop epoch traced and the
    complementor's device time per epoch over it."""
    import torch

    from bridged_gnn_tpu_torch.nn import complementor
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2

    out = {}
    pcfg = stage2.Stage2Config(num_epoch=PARITY_EPOCHS, dropout=0.0,
                               to_undirected=True,
                               adjacency_method=KERNEL_METHOD, **COMPLEMENT)
    with mock.patch.object(complementor, "ALPHA_DROPOUT", 0.0):
        card_run = stage2.train_ktgnn(bench, pcfg, device="cuda")
        t0 = time.perf_counter()
        cpu_run = stage2.train_ktgnn(bench, pcfg, device="cpu")
        cpu_s = time.perf_counter() - t0
    err = max(abs(a[k] - b[k]) / abs(b[k])
              for a, b in zip(card_run["history"], cpu_run["history"],
                              strict=True) for k in ("loss", "loss_t2"))
    if not err <= LOSS_RTOL:
        raise RuntimeError(f"complementor: card vs CPU losses differ by "
                           f"{err:.3g} (relative) > {LOSS_RTOL}")
    w_err = max(float((card_run["state_dict"][k] - w).abs().max())
                for k, w in cpu_run["state_dict"].items())
    out["parity"] = dict(
        phase="complementor_parity", epochs=PARITY_EPOCHS,
        max_rel_loss_err=err, max_abs_weight_err=w_err, cpu_run_s=cpu_s,
        losses_card=[h["loss"] for h in card_run["history"]],
        losses_cpu=[h["loss"] for h in cpu_run["history"]])
    log(json.dumps(dict(card=card, **out["parity"])))
    del card_run, cpu_run

    cfg = stage2.Stage2Config(num_epoch=COMPLEMENT_EPOCHS,
                              scan_epochs=COMPLEMENT_CHUNK, to_undirected=True,
                              adjacency_method=KERNEL_METHOD, **COMPLEMENT)
    prepared = stage2.prepare_stage2_graph(bench, cfg, "cuda")
    # the first conv takes the complementor's rows, which need a gradient
    d0 = stage2.build_model(cfg, c, bench["x"].shape[1],
                            "cpu").convs[0].lin_t.weight.shape[1]
    want = {"attention_sel_fwd": {HIDDEN: 2, c: 6},
            "attention_sel_bwd": {HIDDEN: 1, c: 3},
            "slot_reduce": {HIDDEN: 1, c: 3},
            **prologue_want(d0, HIDDEN, forwards=2, backwards=1,
                            x_grad=True)}
    with mock.patch.object(stage2, "prepare_stage2_graph",
                           lambda *a, **k: prepared):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scan = stage2.train_ktgnn(bench, cfg, device="cuda")
        peak = torch.cuda.max_memory_allocated()
        fk.reset_launch_counts()
        loop = stage2.train_ktgnn(bench, dataclasses.replace(
            cfg, scan_epochs=0), device="cuda")
        counted = {n: c_ for n, c_ in fk.launch_counts().items() if c_}
        per_epoch = {k: {d: n * COMPLEMENT_EPOCHS for d, n in by_d.items()}
                     for k, by_d in want.items()}
        if counted != per_epoch or \
                scan["scan"]["launches_per_replay"] != want:
            raise RuntimeError(f"complementor: the loop launched {counted},"
                               f" a replay {scan['scan']}; expected "
                               f"{want} per epoch")
        loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                       for a, b in zip(scan["history"], loop["history"],
                                       strict=True)
                       for k in ("loss", "loss_t2"))
        if not loss_err <= LOSS_RTOL:
            raise RuntimeError(f"complementor: scan vs loop losses differ "
                               f"by {loss_err:.3g}")
        if scan["best"]["epoch"] != loop["best"]["epoch"]:
            raise RuntimeError("complementor: scan and loop best epochs "
                               "differ")
        diffs = [(a["epoch"], k, a[k], b[k])
                 for a, b in zip(scan["history"], loop["history"])
                 for k in ("train", "val", "test") if a[k] != b[k]]
        ties = name_ties("complementor", bench, dataclasses.replace(
            cfg, scan_epochs=0), loop, diffs) if diffs else []
        traced = trace_phase("complementor_trace", bench, dataclasses.replace(
            cfg, scan_epochs=0, num_epoch=TRACE_EPOCHS))
    comp = complementor_device_ms(bench, cfg, prepared)
    del prepared
    comp_ms = comp["train_fwd_bwd"] + comp["eval_fwd"]
    out["train"] = dict(
        phase="complementor_train", epochs=COMPLEMENT_EPOCHS,
        chunk=COMPLEMENT_CHUNK, **scan["scan"], max_rel_loss_err=loss_err,
        scores_equal=not diffs, score_ties=ties,
        loop_epoch_s_median=loop["throughput"]["p50_s"],
        scan_epoch_s_median=scan["throughput"]["p50_s"],
        scan_max_memory_allocated=peak,
        losses_loop=[h["loss"] for h in loop["history"]],
        complementor_ms=comp, traced_epoch_device_ms=traced["device_ms"],
        complementor_share_of_device_ms=comp_ms / traced["device_ms"],
        trace=traced)
    log(json.dumps(dict(card=card, **out["train"])))
    return out


def path_data(name: str) -> dict:
    """Phase 20's graphs: ``make_sync_dataset`` at its defaults (3,500
    nodes, the synthetic stage-1 graphs' size) and the benchmark graph at
    8,192 nodes (the JAX package's dense limit), split 60/20/20 as the
    bench graph."""
    from bridged_gnn_tpu_torch.data.synthetic import (
        make_benchmark_graph,
        make_sync_dataset,
    )

    if name == "bench8k":
        return make_benchmark_graph(**dict(BENCH, n=8192))
    data = make_sync_dataset(seed=BENCH["seed"])
    r = np.random.default_rng(BENCH["seed"]).random(data["x"].shape[0])
    return dict(data, train_mask=r < 0.6, val_mask=(r >= 0.6) & (r < 0.8),
                test_mask=r >= 0.8)


def path_run(data, model_name: str, method: str) -> dict:
    """One model on one adjacency method on the card: PATH_LOOP_EPOCHS
    loop epochs and PATH_SCAN_EPOCHS in scan mode (epoch medians, peak
    device memory, each run's kernel launches), and predict ×PREDICT_REPS
    (median, peak) on the trained weights."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.serve import KTGNNPredictor
    from bridged_gnn_tpu_torch.train import stage2

    extra = (dict(model_name="GraphSAGE", use_scheduler=False)
             if model_name == "GraphSAGE" else {})
    cfg = stage2.Stage2Config(num_epoch=PATH_LOOP_EPOCHS,
                              to_undirected=True, adjacency_method=method,
                              **extra)
    out = dict(graph_nodes=int(data["x"].shape[0]), model=model_name,
               method=method)
    for mode, run_cfg in (("loop", cfg), ("scan", dataclasses.replace(
            cfg, num_epoch=PATH_SCAN_EPOCHS, scan_epochs=PATH_SCAN_CHUNK))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launch_counts()
        res = stage2.train_ktgnn(data, run_cfg, device="cuda")
        out[f"{mode}_epoch_ms_median"] = res["throughput"]["p50_s"] * 1e3
        out[f"{mode}_max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out[f"{mode}_launches"] = {n: c for n, c in
                                   fk.launch_counts().items() if c}
        out[f"{mode}_losses"] = [h["loss"] for h in res["history"]]
        if not np.all(np.isfinite(out[f"{mode}_losses"])):
            raise RuntimeError(f"{model_name} on {method}: losses "
                               f"{out[f'{mode}_losses']}")
        if mode == "loop":
            state = res["state_dict"]
    g = stage2.prepare_stage2_graph(data, cfg, "cpu")[0]
    model = stage2.build_model(cfg, g.num_classes, g.num_features, "cpu")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pred = KTGNNPredictor(model, state, data, adjacency_method=method,
                          device="cuda")
    pred.predict()
    times = []
    for _ in range(PREDICT_REPS):
        t0 = time.perf_counter()
        pred.predict()
        times.append(time.perf_counter() - t0)
    out.update(predict_ms_median=statistics.median(times) * 1e3,
               predict_max_memory_allocated=torch.cuda.max_memory_allocated())
    if method == "dense" and pred.adj.dense is None:
        raise RuntimeError("phase 20: the dense method built no matrix")
    del pred
    return out


def dense_rule(recs) -> int:
    """The padded-node threshold the measurements support: the largest
    measured padded size at which dense is no slower than blocked on
    KT-GNN's loop and scan epochs and its predict, provided it is also no
    slower on every smaller measured size; 0 when it is slower on the
    smallest."""
    by_size = {}
    for r in recs:
        if r["model"] == "KTGNN":
            by_size.setdefault(r["n_pad"], {})[r["method"]] = r
    chosen = 0
    for n_pad in sorted(by_size):
        d, b = by_size[n_pad]["dense"], by_size[n_pad]["blocked"]
        if all(d[k] <= b[k] for k in ("loop_epoch_ms_median",
                                      "scan_epoch_ms_median",
                                      "predict_ms_median")):
            chosen = n_pad
        else:
            break
    return chosen


def paths_phase(card: str) -> dict:
    """Phase 20: KT-GNN and GraphSAGE under "dense", "gather" and
    "blocked" on each of phase 20's graphs (``path_run``); the three
    methods' loop losses agree within LOSS_RTOL (the same seeded init and
    dropout masks, another summation order); the dense and gather runs
    launch no kernel but KT-GNN's conv prologue, the blocked ones theirs
    besides. Prints the rule the
    measurements support beside ``ops/spmm.py::DENSE_MAX_NODES``."""
    from bridged_gnn_tpu_torch.graph import round_up, NODE_BLOCK
    from bridged_gnn_tpu_torch.ops import spmm

    recs = []
    for gname in ("sync", "bench8k"):
        data = path_data(gname)
        n_pad = round_up(data["x"].shape[0], NODE_BLOCK)
        for model_name in ("KTGNN", "GraphSAGE"):
            runs = {m: path_run(data, model_name, m) for m in PATH_METHODS}
            base = runs["blocked"]["loop_losses"]
            # every AdaptedConv runs its prologue, whatever the adjacency
            prologue = prologue_want(
                data["x"].shape[1], HIDDEN, forwards=2 * PATH_LOOP_EPOCHS,
                backwards=PATH_LOOP_EPOCHS) if model_name == "KTGNN" else {}
            for m, r in runs.items():
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(r["loop_losses"], base))
                if not err <= LOSS_RTOL:
                    raise RuntimeError(f"phase 20 {gname} {model_name}: "
                                       f"{m} against blocked losses differ "
                                       f"by {err:.3g}")
                got = r["loop_launches"]
                other = {k: v for k, v in got.items() if k not in PROLOGUE}
                if (m == "blocked") != bool(other) or {
                        k: got[k] for k in PROLOGUE if k in got} != prologue:
                    raise RuntimeError(f"phase 20 {gname} {model_name} {m}:"
                                       f" launched {got}")
                r.update(graph=gname, n_pad=n_pad,
                         max_rel_loss_err_vs_blocked=err)
                log(json.dumps(dict(phase="adjacency_paths", card=card,
                                    **{k: v for k, v in r.items()
                                       if not k.endswith("_losses")})))
                recs.append(r)
    chosen = dense_rule(recs)
    rule = dict(phase="dense_max_nodes", card=card, measured_rule=chosen,
                dense_max_nodes=spmm.DENSE_MAX_NODES,
                agrees=chosen == spmm.DENSE_MAX_NODES,
                times={f"{r['graph']}:{r['model']}:{r['method']}": {
                    k: r[k] for k in ("loop_epoch_ms_median",
                                      "scan_epoch_ms_median",
                                      "predict_ms_median")} for r in recs})
    log(json.dumps(rule))
    return dict(runs=recs, rule=rule)


# --------------------------------------------------------------------- main


# --------------------------------------------- phases 21-23: stage 1

# phase 21: the JAX package's production-scale stage-1 graph
# (tools/bench_pipeline_scale.py:49-52) and the stage-1 CLI's default
# model, --version v1 (SAGE encoder, cosine head), at hidden 128
STAGE1_DATA = dict(n_src=20000, n_tar=15000, dim=128, num_classes=8,
                   avg_degree=10, seed=0)
STAGE1_MODEL = dict(hidden_dim=128, num_layer=2, backbone="gnn",
                    sim_mode="cosine", max_class_num=8, sample_size=40000)
STAGE1_EPOCHS = 30       # phase 21: loop epochs, evaluating from epoch 20
STAGE1_EVAL_FROM = 20    # every 5 (epochs 20, 25, 30)
STAGE1_EVAL_EVERY = 5
STAGE1_PARITY_EPOCHS = 2
# a training step's SpMM launches by width: two convs per domain forward,
# and the x-gradient of every conv input but the source's raw features
STAGE1_PER_STEP = {128: 7}
STAGE1_EVAL_FORWARDS = 8   # per evaluation: both domains encoded per split
# card vs CPU: an element whose gradient (plus the L2 term) lies within
# this of 0 takes Adam steps set by its last bits (eps 1e-8), of any sign
ADAM_NOISE = 1e-6
STAGE1_GROUPS = {"source_learner": (1e-2, 5e-3),   # (lr, weight decay)
                 "target_learner": (1e-3, 0.0), "discriminator": (1e-3, 0.0)}
# phase 22: the bridge build from phase 21's model
BRIDGE = dict(k_cross=20, k_within=3, check_cross=True, check_within=True,
              row_block=1000)
NEAR_TIE = 1e-5          # a score this close to its row's k-th, or to a
                         # filter's quantile cut, is a near-tie
V2_EPOCHS = 4            # phase 22: the v2 model (mlp backbone, mlp head)
MLP_RERANK = 200
# phase 23: run.sh recipe 0, stage 1 (its stage 2 takes the CLI defaults
# and these)
RECIPE0 = ["--dataset_name", "sync_unrelational", "--k_within", "3",
           "--k_cross", "10", "--num_epoch", "100", "--start_eval_epoch",
           "80", "--eval_per_epoch", "5", "--seed", "0", "--save"]
RECIPE0_STAGE2 = ["--num_layer", "2", "--hidden_dim", "64",
                  "--to_undirected"]
# recipe 0 with --version v1 (64 features, hidden 64, the target's
# 128-wide translation): a step launches {64: 5, 128: 2} (forwards 64, 64,
# 64 and 128; transposed 64, 64 and 128), each of the 5 evaluations and
# the bridge's encodes {64: 6, 128: 2}
RECIPE0_V1_LAUNCHES = {"gather_reduce": {64: 5 * 100 + 6 * 5 + 6,
                                         128: 2 * 100 + 2 * 5 + 2}}


def stage1_data():
    from bridged_gnn_tpu_torch.data.datasets import dataset_conversion
    from bridged_gnn_tpu_torch.data.synthetic import make_sync_dataset

    data = make_sync_dataset("relational-intra", **STAGE1_DATA)
    return dataset_conversion(data, seed=0)


def stage1_cfg(**kw):
    from bridged_gnn_tpu_torch.train.stage1 import Stage1Config

    return Stage1Config(**{**STAGE1_MODEL, **kw})


def stage1_pairs(src, tar, cfg):
    """One epoch's pairs and their labels, on the card, as the trainer's
    host sampler draws them for seed 0."""
    import torch

    from bridged_gnn_tpu_torch.train import samplers

    rng = np.random.default_rng(0)
    enus = (samplers.PairEnumerator(src, "train", rng),
            samplers.PairEnumerator(tar, "train", rng),
            samplers.PairEnumeratorCross(src, tar, "train", rng))
    (s1, s2), (t1, t2), (c1, c2) = (
        e.sampling(cfg.max_class_num, cfg.sample_size) for e in enus)
    ys, yt = src["y"], tar["y"]

    def dev(a):
        return torch.from_numpy(np.asarray(a)).cuda()

    idxs = {k: dev(v.astype(np.int64)) for k, v in dict(
        src1=s1, src2=s2, tar1=t1, tar2=t2, cross1=c1, cross2=c2).items()}
    y_pairs = {k: dev(v.astype(np.float32)) for k, v in dict(
        src=ys[s1] == ys[s2], tar=yt[t1] == yt[t2],
        cross=ys[c1] == yt[c2]).items()}
    return idxs, y_pairs


def stage1_replay(src, tar) -> list:
    """Phase 21's kernel replay: the gather_reduce calls of one v1
    training step (similarity step and discriminator step), held to
    STAGE1_PER_STEP (4 forwards, 3 transposed), each replayed as phase
    16's (check_gather_calls)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    cfg = stage1_cfg()
    G = ts1.prepare_stage1_graphs(src, tar, "gnn", "cuda")
    model = ts1.build_model(cfg, src, tar, "cuda")
    opts = ts1.make_optimizers(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idxs, y_pairs = stage1_pairs(src, tar, cfg)

    def step():
        _, aux = ts1.sim_step(model, opts, G, idxs, y_pairs, True, gen)
        ts1.d_step(model, opts, G, aux["h_src"], aux["h_tar"])

    fk.reset_launch_counts()
    recs = record_run(step, ("gather_reduce",))
    counted = {n: c for n, c in fk.launch_counts().items() if c}
    transposed = sorted(bool(r["inputs"][4]) for r in recs)
    if counted != {"gather_reduce": STAGE1_PER_STEP} \
            or transposed != [False] * 4 + [True] * 3:
        raise RuntimeError(f"stage-1 step: launched {counted}, transposed "
                           f"{transposed}; expected {STAGE1_PER_STEP}, 4 "
                           "forward and 3 transposed")
    out = check_gather_calls(
        recs, layouts_of(G.adj_src) + layouts_of(G.adj_tar))
    del recs, model, opts, G
    torch.cuda.empty_cache()
    return out


def stage1_train(src, tar) -> dict:
    """Phase 21's main path: ``train_adversarial`` of the v1 model for
    STAGE1_EPOCHS epochs, counts at 0 just before, CUDA events around
    every launch: STAGE1_PER_STEP a step and STAGE1_EVAL_FORWARDS forwards
    an evaluation, no other kernel; epoch and evaluation medians on the
    host clock; the kernel's time per epoch in the steps and per
    evaluation."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    cfg = stage1_cfg(num_epoch=STAGE1_EPOCHS,
                     start_eval_epoch=STAGE1_EVAL_FROM,
                     eval_per_epoch=STAGE1_EVAL_EVERY)
    spans, real_eval = [], ts1.Stage1Evaluator.__call__

    def marked(self, split, epoch=0):
        first = len(recs)
        out = real_eval(self, split, epoch)
        spans.append((first, len(recs)))
        return out

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    with fk.record_launches() as recs, \
            mock.patch.object(ts1.Stage1Evaluator, "__call__", marked):
        res = ts1.train_adversarial(src, tar, cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    evals = len(res["eval_s"])
    counted = {n: c for n, c in fk.launch_counts().items() if c}
    want = {"gather_reduce": {128: STAGE1_PER_STEP[128] * STAGE1_EPOCHS
                              + STAGE1_EVAL_FORWARDS * evals}}
    losses = [h["loss"] for h in res["history"]]
    if counted != want or evals != 3 or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"stage-1 training: launched {counted} (want "
                           f"{want}) in {evals} evaluations; losses "
                           f"{losses}")
    in_eval = {i for a, b in spans for i in range(a, b)}
    ms = [r["start"].elapsed_time(r["stop"]) for r in recs]
    return dict(
        phase="stage1_train", epochs=STAGE1_EPOCHS, evaluations=evals,
        src_nodes=int(src["x"].shape[0]), tar_nodes=int(tar["x"].shape[0]),
        src_edges=int(src["edge_index"].shape[1]),
        tar_edges=int(tar["edge_index"].shape[1]),
        launches=counted,
        launches_per_epoch_by_d={"gather_reduce": STAGE1_PER_STEP},
        epoch_s_median=res["throughput"]["p50_s"],
        epoch_s_mean=res["throughput"]["mean_s"],
        eval_s_median=statistics.median(res["eval_s"]),
        eval_s=res["eval_s"], run_s=run_s,
        kernel_ms_per_epoch=sum(m for i, m in enumerate(ms)
                                if i not in in_eval) / STAGE1_EPOCHS,
        kernel_ms_per_eval=sum(ms[i] for i in in_eval) / evals,
        best=res["best"], loss_first=losses[0], loss_last=losses[-1],
        d_loss_last=res["history"][-1]["loss_d"],
    ), res


def stage1_adam_explain(noise, state, epochs):
    """Card vs CPU after stage-1 training: which elements may part. A
    parameter element may when its gradient plus the L2 term lay within
    ADAM_NOISE of 0 at some step of the CPU run (``noise``: the least
    |gradient| per element), and by at most 2·lr a step: Adam's step
    there is set by the gradient's last bits, of any sign. Among them are
    the similarity head's biases that lin_self_2's batch mean removes in
    train mode (lin_self_0's, and lin_self_1's in the mlp head). So
    lin_self_2's running mean may part by what they move it: per column,
    momentum × steps × (Σ|W1| × their largest step, + the largest
    step)."""
    sim = "source_learner.sim_net."
    step_bound = 2 * STAGE1_GROUPS["source_learner"][0] * epochs
    w1 = state[sim + "lin_self_1.weight"].abs().sum(1)

    def explain(apart):
        named = {}
        for key, (got, want, far) in apart.items():
            d = (got - want).abs()[far]
            if key == sim + "lin_self_2.running_mean":
                bound = (0.1 * epochs * (w1 + 1.0) * step_bound)[far]
                ok = bool((d <= bound).all())
            elif key in noise:
                lr = STAGE1_GROUPS[key.split(".")[0]][0]
                ok = bool((noise[key][far] < ADAM_NOISE).all()
                          and (d <= 2 * lr * epochs).all())
            else:
                ok = False
            if not ok:
                raise RuntimeError(
                    f"stage-1 card vs CPU: {key} differs by "
                    f"{float(d.max()):.3g} at {int(far.sum())} elements "
                    "that no Adam-noise element explains")
            named[key] = dict(elements=int(far.sum()),
                              max_abs_diff=float(d.max()))
        return named

    return explain


def stage1_parity(src, tar) -> dict:
    """Phase 21, card against CPU: STAGE1_PARITY_EPOCHS epochs at dropout
    0 from the same seeded init and host pair stream, no evaluation; the
    sim, d and AE losses within LOSS_RTOL; weights and statistics within
    phase 11's tolerances or explained by stage1_adam_explain."""
    import torch

    from bridged_gnn_tpu_torch.nn import common, stage1
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    cfg = stage1_cfg(num_epoch=STAGE1_PARITY_EPOCHS,
                     start_eval_epoch=STAGE1_PARITY_EPOCHS + 1)
    noise = {}
    real_sim, real_d = ts1.sim_step, ts1.d_step

    def least_grad(model, group):
        for k, p in model.named_parameters():
            if k.split(".")[0] in group:
                lr, wd = STAGE1_GROUPS[k.split(".")[0]]
                g = (p.grad + wd * before[k]).abs()
                noise[k] = torch.minimum(noise[k], g) if k in noise else g

    def sim_step(model, *args):
        before.update({k: p.detach().clone()
                       for k, p in model.named_parameters()})
        out = real_sim(model, *args)
        least_grad(model, ("source_learner", "target_learner"))
        return out

    def d_step(model, *args):
        out = real_d(model, *args)
        least_grad(model, ("discriminator",))
        return out

    before = {}
    with contextlib.ExitStack() as stack:
        for obj, attr in ((stage1.GraphEncoder, "dropout_p"),
                          (common.MLPBackbone, "dropout_p"),
                          (stage1.SourceLearnerV2, "clf_dropout_p")):
            stack.enter_context(mock.patch.object(obj, attr, 0.0))
        card = ts1.train_adversarial(src, tar, cfg, device="cuda")
        t0 = time.perf_counter()
        with mock.patch.object(ts1, "sim_step", sim_step), \
                mock.patch.object(ts1, "d_step", d_step):
            cpu = ts1.train_adversarial(src, tar, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
    loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(card["history"], cpu["history"])
                   for k in ("loss", "loss_d", "loss_ae"))
    if not loss_err <= LOSS_RTOL:
        raise RuntimeError(f"stage-1 card vs CPU losses differ by "
                           f"{loss_err:.3g} (relative) > {LOSS_RTOL}")
    apart, w_err = {}, 0.0
    for k, want in cpu["state_dict"].items():
        got = card["state_dict"][k]
        w_err = max(w_err, float((got - want).abs().max()))
        far = ~torch.isclose(got, want, rtol=WEIGHT_RTOL, atol=WEIGHT_ATOL)
        if far.any():
            apart[k] = (got, want, far)
    named = stage1_adam_explain(noise, cpu["state_dict"],
                                STAGE1_PARITY_EPOCHS)(apart)
    return dict(phase="stage1_parity", epochs=STAGE1_PARITY_EPOCHS,
                max_rel_loss_err=loss_err, max_abs_weight_err=w_err,
                adam_noise_apart=named, cpu_run_s=cpu_s,
                losses_card=[h["loss"] for h in card["history"]],
                losses_cpu=[h["loss"] for h in cpu["history"]])


def stage1_phase(card: str):
    """Phase 21: stage-1 training of the v1 model on the production-scale
    graph: one step's kernel calls replayed, STAGE1_EPOCHS loop epochs
    with evaluations, one traced epoch, card against CPU."""
    import torch

    from bridged_gnn_tpu_torch.train import stage1 as ts1

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    src, tar, m_src, m_tar = stage1_data()
    log(json.dumps(dict(phase="stage1_data", card=card,
                        s=time.perf_counter() - t0)))
    replay = stage1_replay(src, tar)
    for r in replay:
        log(json.dumps(dict(kernel="gather_reduce", graph="stage1",
                            card=card, **r)))
    train, res = stage1_train(src, tar)
    log(json.dumps(dict(card=card, **train)))
    cfg = stage1_cfg(num_epoch=2, start_eval_epoch=3)
    traced = trace_phase("stage1_trace", None, cfg, trainer=(
        ts1, lambda: ts1.train_adversarial(src, tar, cfg, device="cuda")))
    log(json.dumps(dict(card=card, **traced)))
    torch.cuda.empty_cache()
    parity = stage1_parity(src, tar)
    log(json.dumps(dict(card=card, **parity)))
    s = time.perf_counter() - t_phase
    log(f"phase 21 (stage-1 training): {s:.1f} s [{card}]")
    return dict(replay=replay, train=train, trace=traced, parity=parity,
                model=res["model"], data=(src, tar, m_src, m_tar), s=s,
                loop_history=res["history"], loop_best=res["best"])


def _inverse(mapper: dict, n: int) -> np.ndarray:
    inv = np.empty(n, dtype=np.int64)
    for orig, new in mapper.items():
        inv[new] = orig
    return inv


def recorded_bridge(model, G, data, device, timings=None, sim_mode="cosine",
                    rerank=None, mesh=None):
    """``gen_bridged_graph`` of BRIDGE on ``device`` (``sim_mode``, the
    rerank's candidates and the mesh as given), with its proposals:
    ``{kind: (edges in original ids [2, R·k], sims [R, k], top-k columns
    [R, k])}`` for kind cross, within_source, within_target, and the
    classifier's probabilities."""
    from bridged_gnn_tpu_torch.bridge import build

    src, tar, m_src, m_tar = data
    inv = {"source": _inverse(m_src, len(m_src)),
           "target": _inverse(m_tar, len(m_tar))}
    props, probs = {}, {}
    real_cross, real_within = build.propose_cross_edges, \
        build.propose_within_edges

    def cross(*args, **kw):
        out = real_cross(*args, **kw)
        ei, sims = out[0], out[1]
        props["cross"] = (np.stack([inv["source"][ei[0]],
                                    inv["target"][ei[1]]]), sims,
                          ei[0].reshape(sims.shape))
        probs.update(source=out[2], target=out[3])
        return out

    def within(model, g, adj, domain, *args, **kw):
        ei, sims = real_within(model, g, adj, domain, *args, **kw)
        props[f"within_{domain}"] = (inv[domain][ei], sims,
                                     ei[0].reshape(sims.shape))
        return ei, sims

    with mock.patch.object(build, "propose_cross_edges", cross), \
            mock.patch.object(build, "propose_within_edges", within):
        merged = build.gen_bridged_graph(
            model, G.g_src, G.adj_src, G.g_tar, G.adj_tar, m_src, m_tar,
            sim_mode=sim_mode, timings=timings, rerank_candidates=rerank,
            mesh=mesh, **BRIDGE)
    return merged, props, probs


def bridge_near_ties(card, cpu) -> dict:
    """Card against CPU bridge builds (recorded_bridge): every top-k column
    one device keeps and the other does not lies within NEAR_TIE of its
    row's k-th score on the device that keeps it; the classifier's argmax
    is the same or within NEAR_TIE of a tie; and every edge in one final
    graph and not the other is such a top-k pair or a proposal within
    NEAR_TIE of its filter's quantile cut. Returns the named pairs."""
    (m_card, p_card, c_card), (m_cpu, p_cpu, c_cpu) = card, cpu
    named, topk_pairs = {}, set()
    for kind in p_cpu:
        rows = []
        for side, (pairs, sims, cols), (_, _, other) in (
                ("card", p_card[kind], p_cpu[kind]),
                ("cpu", p_cpu[kind], p_card[kind])):
            k = cols.shape[1]
            for r in np.flatnonzero((np.sort(cols, 1)
                                     != np.sort(other, 1)).any(1)):
                for j in np.flatnonzero(~np.isin(cols[r], other[r])):
                    gap = float(sims[r, j] - sims[r, k - 1])
                    if abs(gap) > NEAR_TIE:
                        raise RuntimeError(
                            f"bridge {kind}: row {r} column {cols[r, j]} "
                            f"kept on the {side} only, {gap:.3g} above the"
                            f" row's k-th")
                    pair = tuple(int(a) for a in pairs[:, r * k + j])
                    topk_pairs.add(pair)
                    rows.append(dict(side=side, row=int(r), pair=pair,
                                     gap=gap))
        named[kind] = rows
    for dom in ("source", "target"):
        a, b = c_card[dom], c_cpu[dom]
        moved = np.flatnonzero(a.argmax(1) != b.argmax(1))
        top2 = np.sort(b[moved], 1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] > NEAR_TIE).any():
            raise RuntimeError(f"bridge: the classifier's argmax moved on "
                               f"{dom} nodes {moved[:10]}")
        named[f"argmax_{dom}"] = moved.tolist()

    def edges(m):
        return set(map(tuple, m["edge_index"].T.tolist()))

    near_cut = set()
    for props in (p_card, p_cpu):
        for kind, (pairs, sims, _) in props.items():
            flat = sims.reshape(-1)
            cut = np.quantile(flat, 0.1)
            for i in np.flatnonzero(np.abs(flat - cut) <= NEAR_TIE):
                near_cut.add(tuple(int(a) for a in pairs[:, i]))
    moved = edges(m_card) ^ edges(m_cpu)
    unexplained = moved - topk_pairs - near_cut
    if unexplained:
        raise RuntimeError(f"bridge: {len(unexplained)} edges differ card "
                           f"vs CPU without a near-tie: "
                           f"{sorted(unexplained)[:10]}")
    named["edges_apart"] = len(moved)
    return named


def bridge_phase(s1, card: str) -> dict:
    """Phase 22: the bridge from phase 21's model (BRIDGE: k_cross 20,
    k_within 3, both filters, row block 1000): each part's seconds
    beside the scoring matmul's bound (2·R·C·H f32 operations), edges,
    homophily and peak device memory; the same build on the CPU, equal up
    to named near-ties; then a v2 model (mlp backbone and head, V2_EPOCHS
    epochs) through the mlp head's bridge with and without the rerank
    (MLP_RERANK candidates), each with its peak memory."""
    import torch

    from bridged_gnn_tpu_torch.bridge.build import gen_bridged_graph
    from bridged_gnn_tpu_torch.train import stage1 as ts1
    from bridged_gnn_tpu_torch.utils.diagnostics import eval_homophily

    t_phase = time.perf_counter()
    src, tar, m_src, m_tar = s1["data"]
    n_s, n_t, h = src["x"].shape[0], tar["x"].shape[0], 128
    model = s1["model"]
    G = ts1.prepare_stage1_graphs(src, tar, "gnn", "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    on_card = recorded_bridge(model, G, s1["data"], "cuda", timings)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    merged = on_card[0]
    h1, h2 = eval_homophily(merged)

    def mm_bound(r, c):
        return 2.0 * r * c * h / F32_FLOPS_PER_S

    out = dict(
        phase="bridge", s=build_s, timings_s=timings,
        matmul_bound_s=dict(cross_topk=mm_bound(n_t, n_s),
                            within_source=mm_bound(n_s, n_s),
                            within_target=mm_bound(n_t, n_t)),
        edges=int(merged["edge_index"].shape[1]), homophily=h1,
        homophily_2nd=h2, peak_bytes=peak)
    t0 = time.perf_counter()
    model_cpu = copy.deepcopy(model).cpu()
    Gc = ts1.prepare_stage1_graphs(src, tar, "gnn", "cpu")
    on_cpu = recorded_bridge(model_cpu, Gc, s1["data"], "cpu")
    out["cpu_s"] = time.perf_counter() - t0
    out["near_ties"] = bridge_near_ties(on_card, on_cpu)
    out["cpu_edges"] = int(on_cpu[0]["edge_index"].shape[1])
    del on_card, on_cpu, model_cpu, Gc
    log(json.dumps(dict(card=card, **out)))

    # v2: MLP backbone and mlp head, the mlp head's bridge
    cfg = stage1_cfg(backbone="mlp", sim_mode="mlp", num_epoch=V2_EPOCHS,
                     start_eval_epoch=V2_EPOCHS + 1)
    t0 = time.perf_counter()
    v2 = ts1.train_adversarial(src, tar, cfg, device="cuda")
    v2_train_s = time.perf_counter() - t0
    G2 = ts1.prepare_stage1_graphs(src, tar, "mlp", "cuda")
    runs = {}
    for rerank in (None, MLP_RERANK):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tm = {}
        t0 = time.perf_counter()
        g = gen_bridged_graph(v2["model"], G2.g_src, None, G2.g_tar, None,
                              m_src, m_tar, sim_mode="mlp", timings=tm,
                              rerank_candidates=rerank, **BRIDGE)
        runs[rerank] = dict(
            rerank=rerank, s=time.perf_counter() - t0, timings_s=tm,
            edges=int(g["edge_index"].shape[1]),
            homophily=eval_homophily(g)[0],
            peak_bytes=torch.cuda.max_memory_allocated(),
            peak_over_base_bytes=torch.cuda.max_memory_allocated() - base,
            edge_set=set(map(tuple, g["edge_index"].T.tolist())))
    shared = len(runs[None]["edge_set"] & runs[MLP_RERANK]["edge_set"])
    for r in runs.values():
        r.pop("edge_set")
        log(json.dumps(dict(phase="bridge_v2", card=card,
                            v2_train_s=v2_train_s,
                            losses=[x["loss"] for x in v2["history"]],
                            edges_shared_exact_rerank=shared, **r)))
    out["v2"] = list(runs.values())
    out["v2_model"] = v2["model"]     # phase 26 serves it
    del v2, G2, G
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 22 (bridge construction): {out['phase_s']:.1f} s [{card}]")
    return out


def recipe0_phase(card: str) -> dict:
    """Phase 23: run.sh recipe 0 through the port's two CLIs on the card,
    in this process: the stage-1 CLI with recipe 0's flags (--version v2:
    no kernel), the same with the default --version v1, whose every
    aggregation is the SpMM kernel (counts at 0 just before: 7 a step, 8
    an evaluation, 8 in the bridge's encodes), and the stage-2 CLI on the
    v2 run's npz, which must print [stage-2 best]."""
    import contextlib as cl
    import io

    from bridged_gnn_tpu_torch.cli import main_bridged_graph as s1cli
    from bridged_gnn_tpu_torch.cli import main_graph_knowledge_transfer as \
        s2cli
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for version in ("v2", "v1"):
            d = os.path.join(tmp, version)
            argv = RECIPE0 + ["--version", version, "--out_dir", d,
                              "--ckpt_dir", d]
            text = io.StringIO()
            fk.reset_launch_counts()
            t0 = time.perf_counter()
            with cl.redirect_stdout(text):
                merged = s1cli.main(s1cli.build_argparser().parse_args(argv))
            run_s = time.perf_counter() - t0
            counted = {n: c for n, c in fk.launch_counts().items() if c}
            npz = os.path.join(d, "sync_unrelational_bridged_graph.npz")
            want = {} if version == "v2" else RECIPE0_V1_LAUNCHES
            best = [ln for ln in text.getvalue().splitlines()
                    if ln.startswith("[stage-1 best]")]
            if counted != want or not best or not os.path.isfile(npz) \
                    or not os.path.isfile(os.path.join(
                        d, "model_AdvLearner_sync_unrelational_best.pkl")):
                raise RuntimeError(
                    f"recipe 0 stage 1 ({version}): launched {counted} "
                    f"(want {want}), output tail "
                    f"{text.getvalue()[-400:]!r}")
            out[version] = dict(run_s=run_s, launches=counted,
                                best=best[0],
                                edges=int(merged["edge_index"].shape[1]))
            log(json.dumps(dict(phase=f"recipe0_stage1_{version}",
                                card=card, **out[version])))
        text = io.StringIO()
        t0 = time.perf_counter()
        with cl.redirect_stdout(text):
            res = s2cli.main(s2cli.build_argparser().parse_args(
                RECIPE0_STAGE2 + ["--path_data", os.path.join(
                    tmp, "v2", "sync_unrelational_bridged_graph.npz")]))
        run_s = time.perf_counter() - t0
    best = [ln for ln in text.getvalue().splitlines()
            if ln.startswith("[stage-2 best]")]
    if not best:
        raise RuntimeError(f"recipe 0 stage 2: no [stage-2 best]: "
                           f"{text.getvalue()[-400:]!r}")
    out["stage2"] = dict(run_s=run_s, best=best[0],
                         epochs=len(res["history"]),
                         mean_epoch_s=res["mean_epoch_time"])
    log(json.dumps(dict(phase="recipe0_stage2", card=card, **out["stage2"])))
    out["s"] = time.perf_counter() - t_phase
    log(f"phase 23 (run.sh recipe 0 on the port): {out['s']:.1f} s [{card}]")
    return out


# ------------------------------ phases 24-26: stage-1 scan, pipeline, serving

# phase 24: phase 21's run in scan mode (segments of 10, ending on the
# evaluations at 20, 25 and 30), host- and device-sampled
STAGE1_SCAN = 10
# (b): the device-sampled run traced, its evaluations off: the second
# segment, 10 replays after the capture
STAGE1_TRACE_EPOCHS = 20
EVAL_REPS = 5            # (c): evaluator calls timed per kind
RESUME_EPOCHS = 12       # (d): a device-sampled run of 3 segments of 4,
RESUME_AT = 4            # resumed after the first
# phase 25: RECIPES["office_amazon2dslr_tpu"] on sync_unrelational, depth
# cut (the recipe: 400 stage-1 epochs evaluating from 300, 300 stage-2)
PIPE_STAGE1 = dict(num_epoch=40, start_eval_epoch=30)
PIPE_STAGE2 = dict(num_epoch=60)
# phase 26: the scorer of phase 22's v2 model
SERVE_K = 20             # BRIDGE's k_cross
SERVE_ROW_BLOCK = 256    # the serving CLI's default
SERVE_CPU_ROWS = 256     # target rows scored on the CPU too
SERVE_REPS = 10          # /v1/topk requests timed per batch size
SERVE_BATCHES = (1, 256)


def stage1_scan_run(src, tar, **kw):
    """``train_adversarial`` of the v1 model in scan mode on the card,
    counts at 0 just before; returns the result, the run's seconds and
    the wrappers' counts."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    cfg = stage1_cfg(**{**dict(num_epoch=STAGE1_EPOCHS,
                               start_eval_epoch=STAGE1_EVAL_FROM,
                               eval_per_epoch=STAGE1_EVAL_EVERY,
                               scan_epochs=STAGE1_SCAN), **kw})
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = ts1.train_adversarial(src, tar, cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counted = {n: c for n, c in fk.launch_counts().items() if c}
    info = res["scan"]
    evals = len(res["eval_s"])
    per_replay = {"gather_reduce": STAGE1_PER_STEP}
    # the device evaluator encodes each domain once for both splits
    per_eval = 4 if cfg.device_sampling else STAGE1_EVAL_FORWARDS
    want = {"gather_reduce": {128: STAGE1_PER_STEP[128] * (
        info["eager_epochs"] + info["captures"]) + per_eval * evals}}
    if (info["launches_per_replay"] != per_replay
            or counted != want or info["captures"] != 1
            or info["eager_epochs"] + info["replays"] != cfg.num_epoch):
        raise RuntimeError(f"stage-1 scan: {info}, counted {counted}, want "
                           f"{want} and {per_replay} a replay")
    return res, run_s, counted


def check_device_pairs(src, tar, cfg) -> dict:
    """Phase 24 (b): one epoch's pairs drawn by the device samplers the
    run uses, on the card: every id a train row of its domain, each side
    ``per_class`` ids of each of ``m`` classes (both sides the same
    classes in the same order), in pair_enumeration order, and the count
    JAX's sampler gives, ``(per_class · m)²``; targets from the labels."""
    import torch

    from bridged_gnn_tpu_torch.train.device_sampler import (
        build_device_samplers,
        sample_epoch_on_device,
    )

    samplers, labels = build_device_samplers(
        src, tar, cfg.max_class_num, cfg.sample_size, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    idxs, y_pairs = sample_epoch_on_device(samplers, labels, gen)
    idxs = {k: v.cpu().numpy() for k, v in idxs.items()}
    out = {}
    for rel, d1, d2 in (("src", src, src), ("tar", tar, tar),
                        ("cross", src, tar)):
        s = samplers[rel]
        a, b = idxs[f"{rel}1"], idxs[f"{rel}2"]
        n = s.per_class * s.m
        y1, y2 = np.asarray(d1["y"]), np.asarray(d2["y"])
        side1, side2 = a[:n], b.reshape(n, n)[:, 0]
        ok = (len(a) == len(b) == n * n == s.num_pairs
              and np.asarray(d1["train_mask"])[a].all()
              and np.asarray(d2["train_mask"])[b].all()
              and (a.reshape(n, n) == side1).all()
              and (b.reshape(n, n) == side2[:, None]).all())
        for side, y in ((side1, y1), (side2, y2)):
            blocks = y[side].reshape(s.m, s.per_class)
            ok = ok and (blocks == blocks[:, :1]).all() \
                and len(set(blocks[:, 0])) == s.m
        ok = ok and (y1[side1].reshape(s.m, -1)[:, 0]
                     == y2[side2].reshape(s.m, -1)[:, 0]).all()
        ok = ok and np.array_equal(y_pairs[rel].cpu().numpy(),
                                   (y1[a] == y2[b]).astype(np.float32))
        if not ok:
            raise RuntimeError(f"device pairs ({rel}) are not the sampler's")
        out[rel] = dict(pairs=int(len(a)), classes=int(s.m),
                        per_class=int(s.per_class))
    return out


def device_eval_phase(src, tar, model) -> dict:
    """Phase 24 (c): ``DeviceStage1Evaluator.both`` against the host
    evaluator on one model: medians of EVAL_REPS calls each; ``both(e)``
    equal to the two per-split calls; each score ``eval_metric``'s over
    the pairs it drew, scored on the host from the same embeddings; 4
    SpMM launches a call (one encode per domain)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage1 as ts1
    from bridged_gnn_tpu_torch.train.metrics import eval_metric

    cfg = stage1_cfg(scan_epochs=STAGE1_SCAN, device_sampling=True)
    G = ts1.prepare_stage1_graphs(src, tar, "gnn", "cuda")
    dev_ev = ts1.DeviceStage1Evaluator(model, G, src, tar, cfg)
    host_ev = ts1.Stage1Evaluator(model, G, src, tar, cfg,
                                  np.random.default_rng(0))

    def timed(fn):
        times = []
        for e in range(EVAL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(e)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    dev_s = timed(dev_ev.both)
    host_s = timed(lambda e: (host_ev("val", e), host_ev("test", e)))
    fk.reset_launch_counts()
    both = dev_ev.both(7)
    launches = {n: c for n, c in fk.launch_counts().items() if c}
    if launches != {"gather_reduce": {128: 4}}:
        raise RuntimeError(f"device evaluation launched {launches}")
    if both != (dev_ev("val", 7), dev_ev("test", 7)):
        raise RuntimeError("both() differs from the per-split calls")
    z_src, z_tar = dev_ev.encode()
    sim = model.source_learner.sim_net
    ys, yt = np.asarray(src["y"]), np.asarray(tar["y"])
    for split, scores in zip(("val", "test"), both):
        pairs = dev_ev.draw(split, 7)
        with torch.no_grad():
            for score, rel, z1, z2, y1, y2 in (
                    (scores[0], "src", z_src, None, ys, ys),
                    (scores[2], "tar", z_tar, None, yt, yt),
                    (scores[4], "cross", z_src, z_tar, ys, yt)):
                i1, i2 = pairs[rel]
                p = (sim.similarity(z1, i1, i2) if z2 is None
                     else sim.similarity_cross_domain(z1, z2, i1, i2))
                i1, i2 = i1.cpu().numpy(), i2.cpu().numpy()
                want = eval_metric((y1[i1] == y2[i2]).astype(int),
                                   (p > 0.5).cpu().numpy().astype(int),
                                   "f1", "binary")
                if score != want:
                    raise RuntimeError(f"device evaluation {split} {rel}: "
                                       f"{score} from counts, {want} "
                                       "by eval_metric")
    return dict(device_both_s_median=dev_s, host_val_test_s_median=host_s,
                launches_per_call=launches, val=both[0], test=both[1],
                pairs_per_relation=[s.num_pairs
                                    for s in dev_ev.samplers["val"]])


def stage1_resume_phase(src, tar) -> dict:
    """Phase 24 (d): a device-sampled scan run checkpointed at its first
    segment's end and resumed (its own warm-up epochs and capture) against
    the straight run: the same losses, bit for bit."""
    import dataclasses

    from bridged_gnn_tpu_torch.train import stage1 as ts1

    cfg = stage1_cfg(num_epoch=RESUME_EPOCHS,
                     start_eval_epoch=RESUME_EPOCHS + 1,
                     scan_epochs=RESUME_AT, device_sampling=True)
    straight = ts1.train_adversarial(src, tar, cfg, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ts1.train_adversarial(src, tar, dataclasses.replace(
            cfg, num_epoch=RESUME_AT, ckpt_dir=tmp), device="cuda")
        resumed = ts1.train_adversarial(src, tar, dataclasses.replace(
            cfg, ckpt_dir=tmp, resume=True), device="cuda")
    if resumed["history"] != straight["history"][RESUME_AT:]:
        raise RuntimeError("stage-1 scan resume: the resumed epochs differ "
                           "from the straight run's")
    return dict(epochs=RESUME_EPOCHS, resumed_at=RESUME_AT,
                resumed_epochs=len(resumed["history"]), bit_identical=True)


def stage1_scan_phase(s1, card: str) -> dict:
    """Phase 24: phase 21's model and graph in scan mode. (a) host
    sampling against phase 21's loop on the same pairs: losses within
    LOSS_RTOL (capturable against foreach Adam, phase 14's rule), the
    same best epoch, 7 SpMM launches a replay and no other kernel; (b)
    device sampling: its epoch median, one traced segment's busy share,
    and the device samplers' pairs checked; (c) the device evaluator
    against the host one; (d) resume."""
    import torch

    from bridged_gnn_tpu_torch.train import stage1 as ts1

    t_phase = time.perf_counter()
    src, tar, _, _ = s1["data"]
    out = {}
    # (a) host sampling against the loop
    host, host_s, host_counts = stage1_scan_run(src, tar)
    loop = s1["loop_history"]
    loss_err = max(abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(host["history"], loop, strict=True)
                   for k in ("loss", "loss_d", "loss_ae"))
    if not loss_err <= LOSS_RTOL:
        raise RuntimeError(f"stage-1 scan vs loop losses differ by "
                           f"{loss_err:.3g} (relative) > {LOSS_RTOL}")
    if host["best"]["epoch"] != s1["loop_best"]["epoch"]:
        raise RuntimeError(f"stage-1 scan best epoch {host['best']['epoch']}"
                           f" against the loop's {s1['loop_best']['epoch']}")
    out["host"] = dict(
        phase="stage1_scan_host", epochs=STAGE1_EPOCHS, scan=STAGE1_SCAN,
        segments=host["scan"]["segments"], max_rel_loss_err=loss_err,
        best_epoch=host["best"]["epoch"],
        best_equal_loop=host["best"] == s1["loop_best"],
        launches=host_counts, eager=host["scan"]["eager_epochs"],
        replays=host["scan"]["replays"],
        launches_per_replay=host["scan"]["launches_per_replay"],
        epoch_s_median=host["throughput"]["p50_s"],
        steady_epochs=host["throughput"]["steady_steps"],
        eval_s_median=statistics.median(host["eval_s"]), run_s=host_s,
        loop_epoch_s_median=s1["train"]["epoch_s_median"])
    log(json.dumps(dict(card=card, **out["host"])))
    # (b) device sampling: epoch median, a traced segment, the pairs
    dev, dev_s, dev_counts = stage1_scan_run(src, tar, device_sampling=True)
    cfg = stage1_cfg(num_epoch=STAGE1_TRACE_EPOCHS,
                     start_eval_epoch=STAGE1_TRACE_EPOCHS + 1,
                     scan_epochs=STAGE1_SCAN, device_sampling=True)
    traced = trace_phase("stage1_scan_trace", None, cfg, window=1,
                         epochs=STAGE1_SCAN, trainer=(
                             ts1, lambda: ts1.train_adversarial(
                                 src, tar, cfg, device="cuda")))
    if traced["hand_kernel_launches"] != STAGE1_PER_STEP[128]:
        raise RuntimeError(f"stage-1 traced segment: "
                           f"{traced['hand_kernel_launches']} hand-written "
                           "launches an epoch")
    out["device"] = dict(
        phase="stage1_scan_device", epochs=STAGE1_EPOCHS, scan=STAGE1_SCAN,
        launches=dev_counts, eager=dev["scan"]["eager_epochs"],
        replays=dev["scan"]["replays"],
        launches_per_replay=dev["scan"]["launches_per_replay"],
        epoch_s_median=dev["throughput"]["p50_s"],
        epoch_s_mean=dev["throughput"]["mean_s"],
        steady_epochs=dev["throughput"]["steady_steps"],
        eval_s_median=statistics.median(dev["eval_s"]), run_s=dev_s,
        best=dev["best"], losses_first_last=[dev["history"][0]["loss"],
                                             dev["history"][-1]["loss"]],
        pairs=check_device_pairs(src, tar, cfg))
    log(json.dumps(dict(card=card, **out["device"])))
    log(json.dumps(dict(card=card, **traced)))
    out["trace"] = traced
    torch.cuda.empty_cache()
    # (c) the device evaluator; (d) resume
    out["eval"] = device_eval_phase(src, tar, s1["model"])
    log(json.dumps(dict(phase="stage1_device_eval", card=card,
                        **out["eval"])))
    out["resume"] = stage1_resume_phase(src, tar)
    log(json.dumps(dict(phase="stage1_scan_resume", card=card,
                        **out["resume"])))
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    log(f"phase 24 (stage-1 scan mode): {out['s']:.1f} s [{card}]")
    return out


def pipeline_phase(card: str) -> dict:
    """Phase 25: ``run_pipeline`` on ``RECIPES["office_amazon2dslr_tpu"]``'s
    settings with ``dataset_name="sync_unrelational"``, depth cut
    (PIPE_STAGE1, PIPE_STAGE2), counts at 0 just before: it must write
    the npz, give finite scores and launch the bf16 attention and reduce
    kernels in stage 2; each stage's seconds and the launches. Then
    ``python -m bridged_gnn_tpu_torch.pipeline --config`` on that
    configuration's JSON, a process of its own, which must print the
    three result lines."""
    import dataclasses

    from bridged_gnn_tpu_torch import pipeline
    from bridged_gnn_tpu_torch.config import RECIPES
    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    recipe = RECIPES["office_amazon2dslr_tpu"]
    cfg = dataclasses.replace(
        recipe, dataset_name="sync_unrelational",
        stage1=dataclasses.replace(recipe.stage1, **PIPE_STAGE1),
        stage2=dataclasses.replace(recipe.stage2, **PIPE_STAGE2))
    npz = "sync_unrelational_bridged_graph.npz"
    with tempfile.TemporaryDirectory() as tmp:
        fk.reset_launch_counts()
        t0 = time.perf_counter()
        res = pipeline.run_pipeline(cfg, out_dir=tmp)
        run_s = time.perf_counter() - t0
        counted = {n: c for n, c in fk.launch_counts().items() if c}
        wrote = os.path.isfile(os.path.join(tmp, npz))
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            f.write(cfg.to_json())
        cli_dir = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "bridged_gnn_tpu_torch.pipeline",
             "--config", path, "--out_dir", cli_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        cli_wrote = os.path.isfile(os.path.join(cli_dir, npz))
    lines = {tag: [ln for ln in cli.stdout.splitlines()
                   if ln.startswith(tag)]
             for tag in ("[stage-1 best]", "[stage-2 best]", "[diagnostics]")}
    bf16 = {n for n, by_d in counted.items()
            if any(str(k).endswith(":bf16") for k in by_d)}
    fwd = {"attention_sel_fwd", "attention_fwd"} & bf16
    bwd = {"attention_sel_bwd", "attention_bwd"} & bf16
    if (not wrote or not fwd or not bwd or "slot_reduce" not in bf16
            or not np.isfinite(res["stage2"]["loss"])):
        raise RuntimeError(f"pipeline: launched {counted}, npz {wrote}, "
                           f"stage 2 {res['stage2']}")
    if cli.returncode != 0 or not all(lines.values()) or not cli_wrote:
        raise RuntimeError(f"pipeline CLI: rc {cli.returncode}, npz "
                           f"{cli_wrote}, output tail {cli.stdout[-400:]!r}"
                           f" {cli.stderr[-400:]!r}")
    graph = res["bridged_graph"]
    out = dict(phase="pipeline", recipe="office_amazon2dslr_tpu",
               dataset="sync_unrelational", cuts=dict(
                   stage1=PIPE_STAGE1, stage2=PIPE_STAGE2),
               seconds=res["seconds"], run_s=run_s, launches=counted,
               stage1_best=res["stage1"],
               stage2_best={k: v for k, v in res["stage2"].items()
                            if k != "per_head"},
               diagnostics=res["diagnostics"],
               nodes=int(graph["x"].shape[0]),
               edges=int(graph["edge_index"].shape[1]),
               cli_s=cli_s, cli_stage2_line=lines["[stage-2 best]"][0])
    log(json.dumps(dict(card=card, **out)))
    log(f"phase 25 (the pipeline): {run_s:.1f} s, its CLI {cli_s:.1f} s "
        f"[{card}]")
    return out


def serve_similarity_phase(s1, bridge, card: str) -> dict:
    """Phase 26: a ``SimilarityScorer`` of phase 22's v2 model (mlp
    backbone and head), exact: its top-k of every target row against
    the bridge's cross proposals (with the mlp backbone an isolated
    node's encode is the graph's), SERVE_CPU_ROWS rows against the same
    scorer on the CPU, both equal but for named near-ties (NEAR_TIE);
    then /healthz, /meta and /v1/topk over HTTP, the medians of
    SERVE_REPS requests of 1 and 256 rows."""
    import copy as cp

    import torch

    from bridged_gnn_tpu_torch.bridge import build
    from bridged_gnn_tpu_torch.cli.serve import ServingApp, make_server
    from bridged_gnn_tpu_torch.graph import graph_from_dict
    from bridged_gnn_tpu_torch.serve import SimilarityScorer
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    t_phase = time.perf_counter()
    src, tar, _, _ = s1["data"]
    model = bridge["v2_model"]
    t0 = time.perf_counter()
    scorer = SimilarityScorer(model, None, graph_from_dict(src),
                              sim_mode="mlp", row_block=SERVE_ROW_BLOCK,
                              device="cuda")
    setup_s = time.perf_counter() - t0
    G = ts1.prepare_stage1_graphs(src, tar, "mlp", "cuda")
    ei, sims, *_ = build.propose_cross_edges(
        model, G.g_src, None, G.g_tar, None, SERVE_K,
        row_block=BRIDGE["row_block"], sim_mode="mlp")
    n_tar = tar["x"].shape[0]
    x_tar = np.asarray(tar["x"], np.float32)
    got = scorer.topk_sources(x_tar, SERVE_K)
    ties_bridge = topk_near_ties("bridge", got,
                                 (sims, ei[0].reshape(n_tar, SERVE_K)))
    cpu = SimilarityScorer(cp.deepcopy(model).cpu(), None,
                           graph_from_dict(src), sim_mode="mlp",
                           row_block=SERVE_ROW_BLOCK, device="cpu")
    rows = x_tar[:SERVE_CPU_ROWS]
    ties_cpu = topk_near_ties("cpu", scorer.topk_sources(rows, SERVE_K),
                              cpu.topk_sources(rows, SERVE_K))
    del cpu, G
    app = ServingApp(scorer=scorer, meta=dict(mode="similarity"))
    srv = make_server(app)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=None if body is None else json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    latency, ties_http = {}, {}
    try:
        codes = [call("/healthz")[0], call("/meta")[0]]
        for n in SERVE_BATCHES:
            body = {"x": x_tar[:n].tolist(), "k": SERVE_K}
            code, answer = call("/v1/topk", body)     # warm-up
            codes.append(code)
            ties_http[n] = topk_near_ties(
                f"/v1/topk ({n} rows)",
                (answer["values"], answer["indices"]),
                (got[0][:n], got[1][:n]))
            times = []
            for _ in range(SERVE_REPS):
                t0 = time.perf_counter()
                codes.append(call("/v1/topk", body)[0])
                times.append(time.perf_counter() - t0)
            latency[n] = statistics.median(times)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    if th.is_alive() or set(codes) != {200}:
        raise RuntimeError(f"similarity HTTP answers: {codes}")
    torch.cuda.synchronize()
    out = dict(phase="serve_similarity", setup_s=setup_s,
               sources=int(scorer.num_src), targets=int(n_tar), k=SERVE_K,
               near_ties_bridge=ties_bridge, near_ties_cpu=ties_cpu,
               near_ties_http={str(n): t for n, t in ties_http.items()},
               cpu_rows=SERVE_CPU_ROWS, requests=len(codes),
               topk_ms_median={str(n): 1e3 * s for n, s in latency.items()},
               s=time.perf_counter() - t_phase)
    log(json.dumps(dict(card=card, **out)))
    log(f"phase 26 (similarity serving): {out['s']:.1f} s [{card}]")
    return out


def topk_near_ties(what, got, want) -> list:
    """``(values, indices)`` of two top-ks: values within NEAR_TIE, and
    each index equal unless its position's score lies within NEAR_TIE of
    another in its row; those are returned, named (row, position, the
    two indices)."""
    (gv, gi), (wv, wi) = ((np.asarray(v), np.asarray(i)) for v, i in
                          (got, want))
    if gv.shape != wv.shape or not np.allclose(gv, wv, rtol=0,
                                               atol=NEAR_TIE):
        raise RuntimeError(f"similarity vs {what}: the values differ by "
                           f"{float(np.abs(gv - wv).max()):.3g}")
    named = []
    for r, j in zip(*np.nonzero(gi != wi)):
        gap = float(np.abs(np.delete(wv[r], j) - wv[r, j]).min())
        if gap > NEAR_TIE:
            raise RuntimeError(f"similarity vs {what}: row {r} position {j}"
                               f" holds {gi[r, j]} against {wi[r, j]}, "
                               f"{gap:.3g} from a tie")
        named.append((int(r), int(j), int(gi[r, j]), int(wi[r, j]), gap))
    return named




# ------------------------------------- phase 27: multi-device stage 2

NATIVE_EDGES = 5_000_000   # (a): the seeded graph's edges
NATIVE_NODES = 1_000_000
NATIVE_ROUNDS = 3
SHARDED_RANKS = 2          # (b): ranks, all on cuda:0 (gloo)
SHARDED_EPOCHS = 5         # (b): loop epochs per case
NCCL_EPOCHS = 2            # (c): epochs of the 1-rank NCCL group
SHARDED_TRACE = ("sharded_halo", "sharded_overlap")   # (b): a traced run
SHARDED_TRACE_EPOCHS = 2   # each, rank 0 under torch.profiler
SHARDED_CASES = (
    ("sharded_halo", dict()),
    ("sharded_overlap", dict(halo_overlap=True)),
    ("sharded_edgeshard", dict(shard_layout="edgeshard")),
    ("sharded_nodtc", dict(model_name="KTGNN_noDTC")),
)


def sharded_cfg(n_shards=SHARDED_RANKS, epochs=SHARDED_EPOCHS, **kw):
    from bridged_gnn_tpu_torch.train.stage2 import Stage2Config

    return Stage2Config(num_epoch=epochs, dropout=0.0, to_undirected=True,
                        adjacency_method=KERNEL_METHOD, n_shards=n_shards,
                        **kw)


def native_phase(card: str) -> dict:
    """Phase 27 (a): coalesce and dst-sort of a seeded NATIVE_EDGES-edge
    graph through the native library against numpy: equal arrays, and
    the median seconds of NATIVE_ROUNDS rounds of each, native and numpy
    in turns (the library's build apart)."""
    from bridged_gnn_tpu_torch import graph
    from bridged_gnn_tpu_torch.io import native

    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(BENCH["seed"])
    ei = rng.integers(0, NATIVE_NODES, size=(2, NATIVE_EDGES))
    out = dict(phase="native", edges=NATIVE_EDGES, nodes=NATIVE_NODES,
               rounds=NATIVE_ROUNDS, build_s=build_s)
    for name, fast, slow in (
            ("coalesce", lambda: native.coalesce(ei),
             lambda: graph.coalesce_numpy(ei, NATIVE_NODES)),
            ("sort_by_dst", lambda: native.sort_by_dst(ei),
             lambda: graph.sort_edges_numpy(ei, NATIVE_NODES))):
        times = dict(native=[], numpy=[])
        for _ in range(NATIVE_ROUNDS):
            for kind, fn in (("native", fast), ("numpy", slow)):
                t0 = time.perf_counter()
                res = fn()
                times[kind].append(time.perf_counter() - t0)
                if kind == "native":
                    got = res
                elif not np.array_equal(got, res):
                    raise RuntimeError(f"native {name} differs from numpy")
        for kind, ts in times.items():
            out[f"{name}_{kind}_s"] = float(np.median(ts))
        out[f"{name}_edges_out"] = int(got.shape[1])
    log(json.dumps(dict(card=card, **out)))
    return out


def sharded_want(cfg, c: int, f: int) -> dict:
    """Kernel launches per rank per epoch (train step and eval forward)
    of a sharded case over ``f`` features, by wrapper and width: KT-GNN's
    conv at HIDDEN and three heads at the classes; halo: the concatenated
    pair, or the selective pair for KTGNN_noDTC (one conv, at the
    classes); overlap: two destination-keyed SpMMs per conv forward
    (local and halo sets, 2·D wide) and their transposes in the
    backward; edge shard: none. Every form runs each conv's prologue
    (:func:`prologue_want`), the overlap form twice a conv call (its own
    rows, the halo rows)."""
    no_dtc = cfg.model_name == "KTGNN_noDTC"
    prologue = prologue_want(
        f, None if no_dtc else HIDDEN, forwards=2, backwards=1,
        calls=2 if cfg.halo_overlap and not no_dtc else 1)
    if cfg.shard_layout == "edgeshard":
        return prologue
    if no_dtc:
        return {"attention_sel_fwd": {c: 2}, "attention_sel_bwd": {c: 1},
                "slot_reduce": {c: 1}, **prologue}
    if cfg.halo_overlap:
        return {"gather_reduce": {2 * HIDDEN: 6, 2 * c: 18}, **prologue}
    return {"attention_fwd": {HIDDEN: 2, c: 6},
            "attention_bwd": {HIDDEN: 1, c: 3},
            "slot_reduce": {HIDDEN: 1, c: 3}, **prologue}


def sharded_replay(recs, halo) -> dict:
    """Every kernel call of one recorded sharded step replayed against
    its plain version, as phases 3, 3b, 7 and 16 replay theirs (forwards
    rtol and atol 1e-4; backwards, reduce, SpMM and the conv prologue
    scaled)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk

    layouts = [lay for lay in (halo.lay, halo.lay_local, halo.lay_halo)
               if lay is not None]
    by = {}
    for r in recs:
        by.setdefault(r["name"], []).append(r)
    out = {}
    with torch.no_grad():
        for r in check_prologue_calls(of(recs, *PROLOGUE), plain_reps=2):
            out.setdefault(r["name"], []).append(r)
        for name, calls in by.items():
            if name in PROLOGUE:
                continue
            if name == "gather_reduce":
                out[name] = check_gather_calls(calls, layouts)
                continue
            wrapper = getattr(fk, name)
            plain = getattr(fk, f"{name}_plain")
            if name.endswith("_fwd"):
                out[name] = check_kernel(name, wrapper, plain, calls,
                                         layouts)
            elif name.endswith("_bwd"):
                out[name] = check_kernel(
                    name, wrapper, plain, calls, layouts,
                    bound=lambda i, c=name == "attention_bwd":
                    bwd_bound(i, concat=c), scaled=True, plain_reps=2)
            else:
                out[name] = check_kernel(name, wrapper, plain, calls,
                                         layouts, bound=reduce_bound,
                                         scaled=True, plain_reps=2,
                                         library=reduce_library)
    return out


def sharded_rank(data, cases, c: int) -> dict:
    """Phase 27 (b) on one rank of the gloo group: per case, one recorded
    train step on a backend of its own, its calls replayed rank after
    rank, then ``train_ktgnn`` for SHARDED_EPOCHS epochs with the counts
    set to 0 just before and read just after, CUDA events around every
    launch; for SHARDED_TRACE, a SHARDED_TRACE_EPOCHS run more, rank 0's
    under the profiler (phase 10's reading of its last epoch)."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.parallel.multihost import describe
    from bridged_gnn_tpu_torch.parallel.stage2_runtime import (
        make_stage2_backend,
    )
    from bridged_gnn_tpu_torch.train.optim import make_optimizer
    from bridged_gnn_tpu_torch.train.stage2 import (
        build_model,
        prepare_stage2_graph,
        train_ktgnn,
    )

    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    out = dict(rank=rank, rule=describe(dist.group.WORLD, dev))
    for name, kw in cases:
        cfg = sharded_cfg(**kw)
        t0 = time.perf_counter()
        g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
        model = build_model(cfg, c, g.num_features, dev)
        backend = make_stage2_backend(dist.group.WORLD, dev, model, g, cfg,
                                      c)
        setup_s = time.perf_counter() - t0
        opt, _ = make_optimizer(model.parameters(), cfg.lr,
                                cfg.weight_decay, False, cfg.step_size,
                                cfg.gamma)
        with fk.record_launches(keep_inputs=True) as recs:
            backend.train_step(opt, None)
        replay = {}
        for turn in range(dist.get_world_size()):
            dist.barrier()
            if turn == rank and backend.halo is not None:
                replay = sharded_replay(recs, backend.halo)
        del recs, backend, model, opt
        torch.cuda.empty_cache()
        dist.barrier()
        fk.reset_launch_counts()
        with fk.record_launches() as ev:
            res = train_ktgnn(data, cfg, device="cuda")
        torch.cuda.synchronize()
        counts = fk.launch_counts()
        e = cfg.num_epoch
        want = {k: {d: n * e for d, n in v.items()}
                for k, v in sharded_want(cfg, c, data["x"].shape[1]).items()}
        got = {k: v for k, v in counts.items() if v}
        if got != want:
            raise RuntimeError(f"{name} rank {rank}: launched {got} in {e} "
                               f"epochs, expected {want}")
        info = res["parallel"]
        ex = info.get("exchange", {})
        out[name] = dict(
            losses=[h["loss"] for h in res["history"]],
            losses_t2=[h["loss_t2"] for h in res["history"]],
            best={k: v for k, v in res["best"].items() if k != "per_head"},
            epoch_ms_median=1e3 * res["throughput"]["p50_s"],
            epoch_ms_mean=1e3 * res["mean_epoch_time"],
            launches_by_d=got,
            launches_per_epoch_by_d={k: {d: n // e for d, n in v.items()}
                                     for k, v in got.items()},
            kernel_ms_per_epoch={k: sum(r["start"].elapsed_time(r["stop"])
                                        for r in ev if r["name"] == k) / e
                                 for k in got},
            exchange_ms_per_epoch=1e3 * ex.get("s", 0.0) / e,
            exchange_stage_ms_per_epoch=1e3 * ex.get("stage_s", 0.0) / e,
            exchange_calls_per_epoch=ex.get("calls", 0) / e,
            exchange_mb_per_epoch=ex.get("bytes", 0) / e / 1e6,
            setup_s=setup_s, parallel=info,
            replay={k: [{f: r[f] for f in (
                "d", "layout", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "max_abs_err") if f in r}
                for r in v] for k, v in replay.items()})
        del res, ev
        if name in SHARDED_TRACE:
            tcfg = dataclasses.replace(cfg, num_epoch=SHARDED_TRACE_EPOCHS)
            if rank == 0:
                out[name]["trace"] = trace_phase(f"{name}_trace", data,
                                                 tcfg)
            else:
                train_ktgnn(data, tcfg, device="cuda")
        torch.cuda.empty_cache()
    return out


def single_losses(data, c: int) -> dict:
    """The port's single-device runs the sharded cases are held to:
    KT-GNN and KTGNN_noDTC, SHARDED_EPOCHS loop epochs at dropout 0."""
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    out = {}
    for model in ("KTGNN", "KTGNN_noDTC"):
        res = train_ktgnn(data, sharded_cfg(n_shards=1, model_name=model),
                          device="cuda")
        out[model] = dict(losses=[h["loss"] for h in res["history"]],
                          losses_t2=[h["loss_t2"] for h in res["history"]],
                          epoch_ms_median=1e3 * res["throughput"]["p50_s"])
    return out


def nccl_phase(data, single, c: int, card: str) -> dict:
    """Phase 27 (c): a 1-rank NCCL group in this process, a 1-shard halo
    partition and ``HaloStage2Backend`` driven directly for NCCL_EPOCHS
    epochs, so that the exchange's and the all-reduces' NCCL branches run
    on the card; losses against the single-device run's first epochs
    (rtol 1e-4), scores finite."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.parallel.multihost import init_distributed
    from bridged_gnn_tpu_torch.parallel.stage2_runtime import (
        HaloStage2Backend,
    )
    from bridged_gnn_tpu_torch.train.optim import make_optimizer
    from bridged_gnn_tpu_torch.train.stage2 import (
        build_model,
        prepare_stage2_graph,
    )

    cfg = sharded_cfg(n_shards=1, epochs=NCCL_EPOCHS)
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("cuda", f"file://{tmp}/store", 1, 0)
        try:
            backend_name = dist.get_backend()
            if backend_name != "nccl":
                raise RuntimeError(f"1-rank group on {backend_name}")
            g, _ = prepare_stage2_graph(data, cfg, "cpu", build_adj=False)
            model = build_model(cfg, c, g.num_features, "cuda")
            backend = HaloStage2Backend(dist.group.WORLD, "cuda", model, g,
                                        cfg, c)
            opt, _ = make_optimizer(model.parameters(), cfg.lr,
                                    cfg.weight_decay, False, cfg.step_size,
                                    cfg.gamma)
            fk.reset_launch_counts()
            losses, scores = [], []
            for _ in range(NCCL_EPOCHS):
                loss, _aux = backend.train_step(opt, None)
                losses.append(float(loss))
                scores.append(backend.evaluate()[0])
            torch.cuda.synchronize()
            launched = {k: v for k, v in fk.launch_counts().items() if v}
            info = backend.info()
        finally:
            dist.destroy_process_group()
    want = single["KTGNN"]["losses"][:NCCL_EPOCHS]
    if not np.allclose(losses, want, rtol=LOSS_RTOL, atol=0):
        raise RuntimeError(f"nccl 1-rank: losses {losses}, single device "
                           f"{want}")
    if not all(np.isfinite(list(s.values())).all() for s in scores):
        raise RuntimeError(f"nccl 1-rank: scores {scores}")
    if info["exchange"]["calls"] == 0 or info["exchange"]["staged"]:
        raise RuntimeError(f"nccl 1-rank exchange {info['exchange']}")
    out = dict(phase="sharded_nccl", backend=backend_name, losses=losses,
               single_device_losses=want, scores=scores, launches=launched,
               parallel=info)
    log(json.dumps(dict(card=card, **out)))
    return out


def sharded_phase(bench, c: int, card: str) -> dict:
    """Phase 27: (a) the native library; (b) SHARDED_CASES on
    SHARDED_RANKS gloo ranks sharing cuda:0, each against the port's
    single-device run at dropout 0 (losses rtol 1e-4), every kernel call
    of one sharded step replayed, launches per rank per epoch asserted;
    (c) the 1-rank NCCL group."""
    import torch

    from bridged_gnn_tpu_torch.parallel.multihost import spawn

    t_phase = time.perf_counter()
    native = native_phase(card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = single_losses(bench, c)
    single_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, SHARDED_RANKS, (bench, SHARDED_CASES, c),
                  device_type="cuda", timeout_s=900)
    spawn_s = time.perf_counter() - t0
    cases = {}
    for name, kw in SHARDED_CASES:
        model = kw.get("model_name", "KTGNN")
        want = single[model]
        per_rank = [r[name] for r in ranks]
        for r, got in zip(ranks, per_rank):
            for key in ("losses", "losses_t2"):
                if not np.allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   atol=0):
                    raise RuntimeError(
                        f"{name} rank {r['rank']}: {key} {got[key]} against"
                        f" single device {want[key]}")
        if any(got["losses"] != per_rank[0]["losses"] for got in per_rank):
            raise RuntimeError(f"{name}: the ranks' losses differ")
        if name in SHARDED_TRACE:
            log(json.dumps(dict(card=card, rank=0,
                                **per_rank[0].pop("trace"))))
        row = dict(phase=name, ranks=SHARDED_RANKS, epochs=SHARDED_EPOCHS,
                   rule=ranks[0]["rule"],
                   single_device_losses=want["losses"],
                   single_device_epoch_ms_median=want["epoch_ms_median"],
                   **{f"rank{r['rank']}": got
                      for r, got in zip(ranks, per_rank)})
        log(json.dumps(dict(card=card, **row)))
        cases[name] = row
    nccl = nccl_phase(bench, single, c, card)
    total = time.perf_counter() - t_phase
    log(f"phase 27 (multi-device stage 2): {total:.1f} s, the ranks' "
        f"spawn {spawn_s:.1f} s, single-device runs {single_s:.1f} s "
        f"[{card}]")
    return dict(native=native, cases=cases, nccl=nccl, s=total)


def sharded_rows(kernels, sharded) -> None:
    """Phase 27's launches join the kernel rows' counts (both ranks of
    every case, and the NCCL rank), with the replayed sharded calls."""
    for row in kernels:
        if row.get("dtype") == "bfloat16":
            continue
        name = row["name"]
        by_d, replay = {}, []
        for case, r in sharded["cases"].items():
            for rank in (f"rank{i}" for i in range(SHARDED_RANKS)):
                for d, n in r[rank]["launches_by_d"].get(name, {}).items():
                    by_d[d] = by_d.get(d, 0) + n
                replay += [dict(case=case, rank=rank, **x)
                           for x in r[rank]["replay"].get(name, [])]
        for d, n in sharded["nccl"]["launches"].get(name, {}).items():
            by_d[d] = by_d.get(d, 0) + n
        if by_d:
            row["launches_sharded_by_d"] = by_d
            row["launches"] += sum(by_d.values())
            row["sharded_replay"] = replay


# ----------------------------------- phase 28: the rest of multi-device

SCAN28_EPOCHS = 10         # (a): sharded scan on two gloo ranks, chunks of 5
SCAN28_CHUNK = 5
SCAN28_CASES = (("scan_halo", dict()),
                ("scan_edgeshard", dict(shard_layout="edgeshard")),
                ("scan_overlap", dict(halo_overlap=True)))
NCCL28_EPOCHS = 12         # (b): the 1-rank NCCL group, chunks of 5
NCCL28_CASES = (("sharded_nccl_scan", dict()),
                ("sharded_nccl_scan_overlap", dict(halo_overlap=True)))
# (c): phase 21's v1 model on two gloo ranks, evaluating at 4 and 6; the
# 1-rank NCCL stage-1 scan in segments 1-3, 4, 5-6
STAGE1_SHARDED = dict(num_epoch=6, start_eval_epoch=4, eval_per_epoch=2)
STAGE1_NCCL_CHUNK = 3
GATHER_REPS = 10           # (c): all-gathers timed per domain
# (e): phase 25's settings, cut further
ELASTIC_STAGE1 = dict(num_epoch=10, start_eval_epoch=10)
ELASTIC_STAGE2 = dict(num_epoch=10)


def _digest(*arrays) -> str:
    import hashlib

    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def scan28_rank(data, c: int) -> dict:
    """Phase 28 (a) on one rank: SCAN28_CASES in scan mode over the gloo
    group, counts at 0 just before each run; every epoch runs eagerly, so
    the wrappers count SCAN28_EPOCHS epochs of phase 27's launches."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    out = {}
    for name, kw in SCAN28_CASES:
        cfg = sharded_cfg(epochs=SCAN28_EPOCHS, scan_epochs=SCAN28_CHUNK,
                          **kw)
        dist.barrier()
        fk.reset_launch_counts()
        res = train_ktgnn(data, cfg, device="cuda")
        torch.cuda.synchronize()
        got = {k: v for k, v in fk.launch_counts().items() if v}
        want = {k: {d: n * cfg.num_epoch for d, n in v.items()}
                for k, v in sharded_want(cfg, c, data["x"].shape[1]).items()}
        if got != want:
            raise RuntimeError(f"{name} rank {dist.get_rank()}: launched "
                               f"{got}, expected {want}")
        out[name] = dict(
            losses=[h["loss"] for h in res["history"]],
            losses_t2=[h["loss_t2"] for h in res["history"]],
            best_epoch=res["best"]["epoch"], scan=res["scan"],
            epoch_ms_median=1e3 * res["throughput"]["p50_s"],
            epoch_ms_mean=1e3 * res["mean_epoch_time"],
            launches_by_d=got,
            launches_per_epoch_by_d={k: {d: n // cfg.num_epoch
                                         for d, n in v.items()}
                                     for k, v in got.items()})
        del res
        torch.cuda.empty_cache()
    return out


def stage1_sharded_rank(s1_data) -> dict:
    """Phase 28 (c) on one rank: one row-sharded v1 step's gather_reduce
    calls (STAGE1_PER_STEP, on the rank's slot layouts) replayed rank
    after rank; the all-gather of one 128-wide layer input per domain,
    timed; then ``train_adversarial`` over the group, counts at 0 just
    before: STAGE1_PER_STEP a step and STAGE1_EVAL_FORWARDS an
    evaluation."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.parallel.collectives import GradAllReduce
    from bridged_gnn_tpu_torch.train import stage1 as ts1

    src, tar, _, _ = s1_data
    group, rank, n = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    cfg = stage1_cfg(n_shards=n, **STAGE1_SHARDED)
    G = ts1.prepare_sharded_stage1_graphs(src, tar, "gnn", group, "cuda")
    model = ts1.build_model(cfg, src, tar, "cuda")
    G = dataclasses.replace(G, grad_sync=GradAllReduce(
        list(model.source_learner.parameters())
        + list(model.target_learner.parameters()), group))
    opts = ts1.make_optimizers(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    idxs, y_pairs = stage1_pairs(src, tar, cfg)

    def step():
        _, aux = ts1.sim_step(model, opts, G, idxs, y_pairs, True, gen)
        ts1.d_step(model, opts, G, aux["h_src"], aux["h_tar"])

    fk.reset_launch_counts()
    recs = record_run(step, ("gather_reduce",))
    counted = {k: v for k, v in fk.launch_counts().items() if v}
    if counted != {"gather_reduce": STAGE1_PER_STEP}:
        raise RuntimeError(f"sharded stage-1 step rank {rank}: launched "
                           f"{counted}, expected {STAGE1_PER_STEP}")
    layouts = layouts_of(G.shard_src.adj) + layouts_of(G.shard_tar.adj)
    replay = []
    for turn in range(n):
        dist.barrier()
        if turn == rank:
            replay = check_gather_calls(recs, layouts)
    gathers = {}
    for name, shard in (("source", G.shard_src), ("target", G.shard_tar)):
        t = torch.randn(shard.rows, STAGE1_MODEL["hidden_dim"],
                        device="cuda")
        ms = []
        for _ in range(GATHER_REPS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shard.gather_all(t)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        gathers[name] = dict(rows=shard.rows, ms_median=statistics.median(ms),
                             gathered_bytes=n * t.numel() * 4,
                             received_bytes=(n - 1) * t.numel() * 4)
    del recs, model, opts, G
    torch.cuda.empty_cache()
    dist.barrier()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = ts1.train_adversarial(src, tar, cfg, device="cuda")
    run_s = time.perf_counter() - t0
    launched = {k: v for k, v in fk.launch_counts().items() if v}
    evals = len(res["eval_s"])
    want = {d: k * cfg.num_epoch for d, k in STAGE1_PER_STEP.items()}
    want = {"gather_reduce": {d: v + STAGE1_EVAL_FORWARDS * evals
                              for d, v in want.items()}}
    if launched != want or evals != 2:
        raise RuntimeError(f"sharded stage-1 run rank {rank}: launched "
                           f"{launched} with {evals} evaluations, expected "
                           f"{want}")
    return dict(
        losses=[h["loss"] for h in res["history"]],
        losses_d=[h["loss_d"] for h in res["history"]],
        best={k: v for k, v in res["best"].items()},
        epoch_ms_median=1e3 * res["throughput"]["p50_s"],
        eval_s=res["eval_s"], run_s=run_s, launches=launched,
        gathers=gathers,
        replay=[{k: r[k] for k in ("d", "transpose", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "library_ms",
                                   "max_abs_err")} for r in replay])


BRIDGE28 = (("bridge_v1", "v1", "gnn", "cosine", None),
            ("bridge_v2", "v2", "mlp", "mlp", None),
            ("bridge_v2_rerank", "v2", "mlp", "mlp", MLP_RERANK))


def bridge_sharded_rank(s1_data, states) -> dict:
    """Phase 28 (d) on one rank: BRIDGE28's builds with ``mesh=`` the
    group (recorded_bridge), each part's seconds; rank 0 returns the
    proposals, rank 1 their digest."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.train import stage1 as ts1

    src, tar, _, _ = s1_data
    out = {}
    for name, model_name, backbone, sim_mode, rerank in BRIDGE28:
        cfg = stage1_cfg(backbone=backbone, sim_mode=sim_mode)
        model = ts1.build_model(cfg, src, tar, "cuda")
        model.load_state_dict(states[model_name])
        G = ts1.prepare_stage1_graphs(src, tar, backbone, "cuda")
        timings = {}
        dist.barrier()
        t0 = time.perf_counter()
        merged, props, probs = recorded_bridge(
            model, G, s1_data, "cuda", timings, sim_mode, rerank,
            mesh=dist.group.WORLD)
        s = time.perf_counter() - t0
        digest = _digest(merged["edge_index"],
                         *[a for kind in sorted(props)
                           for a in props[kind][1:]])
        out[name] = dict(s=s, timings_s=timings, digest=digest)
        if dist.get_rank() == 0:
            out[name].update(edge_index=merged["edge_index"], props=props,
                             probs=probs)
        del model, G
        torch.cuda.empty_cache()
    return out


def rest_rank(data, c: int, s1_data, states) -> dict:
    """Phase 28 (a), (c) and (d) on one rank of the gloo group."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.parallel.multihost import describe

    return dict(rank=dist.get_rank(),
                rule=describe(dist.group.WORLD, torch.device("cuda", 0)),
                scan=scan28_rank(data, c),
                stage1=stage1_sharded_rank(s1_data),
                bridge=bridge_sharded_rank(s1_data, states))


def _same_losses(where, got, want):
    if not np.allclose(got, want, rtol=LOSS_RTOL, atol=0):
        raise RuntimeError(f"{where}: losses {got} against {want}")


def rerank_superset(single, sharded) -> dict:
    """The sharded rerank screens each shard's columns, a superset of the
    single device's candidates: every column it keeps and the single
    device does not scores at least the single device's row k-th (less
    NEAR_TIE), and every column it drops scores at most its own k-th
    (plus NEAR_TIE). Returns the rows that differ, by kind."""
    out = {}
    for kind, (_, sims_1, cols_1) in single.items():
        _, sims_n, cols_n = sharded[kind]
        k, rows = cols_1.shape[1], 0
        for r in np.flatnonzero((np.sort(cols_1, 1)
                                 != np.sort(cols_n, 1)).any(1)):
            rows += 1
            gained = ~np.isin(cols_n[r], cols_1[r])
            lost = ~np.isin(cols_1[r], cols_n[r])
            if (sims_n[r][gained] < sims_1[r, k - 1] - NEAR_TIE).any() or (
                    sims_1[r][lost] > sims_n[r, k - 1] + NEAR_TIE).any():
                raise RuntimeError(f"sharded rerank {kind}: row {r} keeps "
                                   f"{cols_n[r]} against {cols_1[r]}")
        out[kind] = rows
    return out


def nccl_scan_run(bench, cfg, c: int, group, single, name: str) -> dict:
    """Phase 28 (b), one case on the 1-rank NCCL group: ``cfg`` in scan
    mode through ``train_ktgnn(group=...)``, counts at 0 just before; the
    epoch captured once after the warm-up epochs and replayed, a replay's
    launches ``sharded_want``'s, losses within LOSS_RTOL of ``single``
    (the single-device scan run) and the same best epoch; one chunk of
    replays traced (busy share, launches an epoch) and what the
    collectives' ranges launched on the device in the traced run's eager
    epochs (``collective_work``)."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.train import stage2
    from bridged_gnn_tpu_torch.train.scan import WARMUP_EPOCHS

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = stage2.train_ktgnn(bench, cfg, device="cuda", group=group)
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counted = {k: v for k, v in fk.launch_counts().items() if v}
    traced = trace_phase(
        f"{name}_trace", bench, cfg, window=1, epochs=SCAN_CHUNK,
        trainer=(stage2, lambda: stage2.train_ktgnn(bench, cfg, "cuda",
                                                    group=group)))
    torch.cuda.empty_cache()
    info, want = res["scan"], sharded_want(cfg, c, bench["x"].shape[1])
    if (info["capture"], info["captures"], info["eager_epochs"],
            info["replays"]) != ("nccl", 1, WARMUP_EPOCHS,
                                 NCCL28_EPOCHS - WARMUP_EPOCHS):
        raise RuntimeError(f"{name}: {info}")
    if info["launches_per_replay"] != want:
        raise RuntimeError(f"{name}: a replay launches "
                           f"{info['launches_per_replay']}, not {want}")
    counted_want = {k: {d: (info["eager_epochs"] + 1) * n
                        for d, n in v.items()} for k, v in want.items()}
    if counted != counted_want:
        raise RuntimeError(f"{name}: the wrappers counted {counted}, "
                           f"not {counted_want}")
    for key in ("loss", "loss_t2"):
        _same_losses(f"{name} {key}", [h[key] for h in res["history"]],
                     [h[key] for h in single["history"]])
    if res["best"]["epoch"] != single["best"]["epoch"]:
        raise RuntimeError(f"{name}: best epoch {res['best']['epoch']} "
                           f"against {single['best']['epoch']}")
    if traced["hand_kernel_launches"] != sum(
            sum(v.values()) for v in want.values()):
        raise RuntimeError(f"{name}: the traced chunk shows "
                           f"{traced['hand_kernel_launches']} launches an "
                           "epoch")
    if not traced["collective_work"]:
        raise RuntimeError(f"{name}: the trace holds no collective range")
    return dict(
        phase=name, backend="nccl", epochs=NCCL28_EPOCHS,
        chunk=SCAN_CHUNK, halo_overlap=res["parallel"]["overlap"], **info,
        run_s=run_s, epoch_ms_median=1e3 * res["throughput"]["p50_s"],
        single_epoch_ms_median=1e3 * single["throughput"]["p50_s"],
        losses=[h["loss"] for h in res["history"]],
        single_device_losses=[h["loss"] for h in single["history"]],
        best_epoch=res["best"]["epoch"], launches=counted, trace=traced)


def nccl_step_replay(bench, cfg, c: int, group) -> dict:
    """One recorded train step of ``cfg`` on a halo backend over the
    1-rank NCCL group, every kernel call replayed against its plain
    version (``sharded_replay``): for the overlap form, the local and
    halo partials' SpMMs and their transposes; the halo set of one rank
    has no real edge, so its calls must give zeros."""
    import torch

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.parallel.stage2_runtime import (
        HaloStage2Backend,
    )
    from bridged_gnn_tpu_torch.train.optim import make_optimizer
    from bridged_gnn_tpu_torch.train.stage2 import (
        build_model,
        prepare_stage2_graph,
    )

    g, _ = prepare_stage2_graph(bench, cfg, "cpu", build_adj=False)
    model = build_model(cfg, c, g.num_features, "cuda")
    backend = HaloStage2Backend(group, "cuda", model, g, cfg, c)
    opt, _ = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                            False, cfg.step_size, cfg.gamma)
    with fk.record_launches(keep_inputs=True) as recs:
        backend.train_step(opt, None)
    halo = backend.halo
    replay = sharded_replay(recs, halo)
    halo_calls = [r for r in replay.get("gather_reduce", [])
                  if halo.lay_halo is not None and r["layout"] == 2]
    if halo.lay_halo is not None and (not halo_calls or any(
            r["real_slots"] for r in halo_calls)):
        raise RuntimeError(f"overlap step: the halo set's calls "
                           f"{halo_calls}")
    del recs, backend, model, opt
    torch.cuda.empty_cache()
    return {k: [{f: r[f] for f in (
        "d", "layout", "transpose", "real_slots", "ms", "device_ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
        if f in r} for r in v] for k, v in replay.items()}


def nccl28_phase(bench, c: int, s1_data, card: str) -> dict:
    """Phase 28 (b) and the end of (c): a 1-rank NCCL group in this
    process. KT-GNN in scan mode (NCCL28_EPOCHS epochs in chunks of
    SCAN_CHUNK) for each of NCCL28_CASES, the halo layout and its
    overlap form (``nccl_scan_run``), held against one single-device
    scan run; the overlap form's step replayed (``nccl_step_replay``).
    Then the v1 stage-1 run of (c) in scan mode over the same group
    (segments of STAGE1_NCCL_CHUNK), captured, against the single-device
    scan run."""
    import torch
    import torch.distributed as dist

    from bridged_gnn_tpu_torch.ops import fused_kernels as fk
    from bridged_gnn_tpu_torch.parallel.multihost import init_distributed
    from bridged_gnn_tpu_torch.train import stage1 as ts1
    from bridged_gnn_tpu_torch.train import stage2

    cfgs = {name: sharded_cfg(n_shards=1, epochs=NCCL28_EPOCHS,
                              scan_epochs=SCAN_CHUNK, **kw)
            for name, kw in NCCL28_CASES}
    src, tar, _, _ = s1_data
    s1cfg = stage1_cfg(n_shards=1, scan_epochs=STAGE1_NCCL_CHUNK,
                       **STAGE1_SHARDED)
    single = stage2.train_ktgnn(bench, cfgs["sharded_nccl_scan"],
                                device="cuda")
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("cuda", f"file://{tmp}/store", 1, 0)
        try:
            group = dist.group.WORLD
            if dist.get_backend(group) != "nccl":
                raise RuntimeError(f"1-rank group on "
                                   f"{dist.get_backend(group)}")
            for name, cfg in cfgs.items():
                runs[name] = nccl_scan_run(bench, cfg, c, group, single,
                                           name)
            overlap = "sharded_nccl_scan_overlap"
            runs[overlap]["replay"] = nccl_step_replay(
                bench, cfgs[overlap], c, group)
            torch.cuda.empty_cache()
            fk.reset_launch_counts()
            s1res = ts1.train_adversarial(src, tar, s1cfg, device="cuda",
                                          group=group)
            s1_counted = {k: v for k, v in fk.launch_counts().items() if v}
            s1_single = ts1.train_adversarial(src, tar, s1cfg,
                                              device="cuda")
        finally:
            dist.destroy_process_group()
    if [r["halo_overlap"] for r in runs.values()] != [False, True]:
        raise RuntimeError("nccl scan: the cases ran "
                           f"{[r['halo_overlap'] for r in runs.values()]}")
    s1info = s1res["scan"]
    if (s1info["capture"], s1info["captures"]) != ("nccl", 1):
        raise RuntimeError(f"nccl stage-1 scan: {s1info}")
    for key in ("loss", "loss_d", "loss_ae"):
        _same_losses(f"nccl stage-1 scan {key}",
                     [h[key] for h in s1res["history"]],
                     [h[key] for h in s1_single["history"]])
    out = dict(
        runs["sharded_nccl_scan"],
        stage1=dict(scan={k: v for k, v in s1info.items()},
                    launches=s1_counted,
                    losses=[h["loss"] for h in s1res["history"]],
                    single_device_losses=[h["loss"]
                                          for h in s1_single["history"]],
                    epoch_ms_median=1e3 * s1res["throughput"]["p50_s"],
                    single_epoch_ms_median=1e3
                    * s1_single["throughput"]["p50_s"]))
    log(json.dumps(dict(card=card, **out)))
    out["overlap"] = runs[overlap]
    log(json.dumps(dict(card=card, **runs[overlap])))
    return out


def elastic_phase(card: str) -> dict:
    """Phase 28 (e): ``run_pipeline(elastic=True)`` on phase 25's
    settings cut to ELASTIC_STAGE1 and ELASTIC_STAGE2, beside the
    straight run. A wrapper here makes stage 2's first attempt hold the
    prepared graph on the card and then ask for twice the card's memory,
    a real CUDA out-of-memory error: one retry, the straight run's best,
    and the memory allocated at the retry's start the same as at the
    first attempt's."""
    import torch

    from bridged_gnn_tpu_torch import pipeline
    from bridged_gnn_tpu_torch.config import RECIPES
    from bridged_gnn_tpu_torch.train import elastic
    from bridged_gnn_tpu_torch.train import stage2

    recipe = RECIPES["office_amazon2dslr_tpu"]
    cfg = dataclasses.replace(
        recipe, dataset_name="sync_unrelational",
        stage1=dataclasses.replace(recipe.stage1, **ELASTIC_STAGE1),
        stage2=dataclasses.replace(recipe.stage2, **ELASTIC_STAGE2))
    t0 = time.perf_counter()
    straight = pipeline.run_pipeline(cfg)
    straight_s = time.perf_counter() - t0
    real = pipeline.train_ktgnn
    seen = dict(calls=0, allocated=[], error=None)
    total = torch.cuda.get_device_properties(0).total_memory

    def first_attempt_fails(data, cfg2, device="cuda"):
        seen["calls"] += 1
        torch.cuda.synchronize()
        seen["allocated"].append(torch.cuda.memory_allocated())
        if seen["calls"] == 1:
            held = stage2.prepare_stage2_graph(data, cfg2, device)
            try:
                torch.empty(2 * total, dtype=torch.uint8, device=device)
            except torch.OutOfMemoryError as exc:
                seen["error"] = f"{type(exc).__name__}: {str(exc)[:120]}"
                raise
            del held
        return real(data, cfg2, device=device)

    t0 = time.perf_counter()
    with mock.patch.object(pipeline, "train_ktgnn", first_attempt_fails), \
            mock.patch.dict(elastic.run_elastic.__kwdefaults__,
                            retry_delay_s=0.0):
        res = pipeline.run_pipeline(cfg, elastic=True)
    elastic_s = time.perf_counter() - t0
    a, b = straight["stage2"], res["stage2"]
    same = (a["epoch"] == b["epoch"] and all(
        np.isclose(a[k], b[k], rtol=1e-6, atol=0)
        for k in ("train", "val", "test", "loss")))
    if seen["calls"] != 2 or not same or res["stage1"] != straight["stage1"]:
        raise RuntimeError(f"elastic pipeline: {seen['calls']} attempts, "
                           f"stage 2 {b} against {a}")
    if seen["allocated"][1] != seen["allocated"][0]:
        raise RuntimeError(f"elastic pipeline: {seen['allocated'][0]} bytes "
                           f"allocated at the first attempt, "
                           f"{seen['allocated'][1]} at the retry")
    out = dict(phase="elastic_pipeline", attempts=seen["calls"],
               error=seen["error"], allocated_at_attempts=seen["allocated"],
               straight_s=straight_s, elastic_s=elastic_s,
               stage2_best={k: v for k, v in b.items() if k != "per_head"},
               cuts=dict(stage1=ELASTIC_STAGE1, stage2=ELASTIC_STAGE2))
    log(json.dumps(dict(card=card, **out)))
    return out


def rest_phase(bench, c: int, s1, bridge, card: str) -> dict:
    """Phase 28: (a) sharded scan mode, (c) row-sharded stage 1 and (d)
    the sharded bridge top-k on SHARDED_RANKS gloo ranks sharing cuda:0,
    spawned once, each against this process's single-device run; (b)
    the 1-rank NCCL group's captured scans (halo and overlap) and
    stage-1 scan; (e) the pipeline's elastic retry."""
    import torch

    from bridged_gnn_tpu_torch.parallel.multihost import spawn
    from bridged_gnn_tpu_torch.train import stage1 as ts1
    from bridged_gnn_tpu_torch.train.stage2 import train_ktgnn

    t_phase = time.perf_counter()
    loop = train_ktgnn(bench, sharded_cfg(n_shards=1, epochs=SCAN28_EPOCHS),
                       device="cuda")
    src, tar, _, _ = s1["data"]
    s1_single = ts1.train_adversarial(src, tar, stage1_cfg(**STAGE1_SHARDED),
                                      device="cuda")
    states = {name: {k: v.detach().cpu() for k, v in m.state_dict().items()}
              for name, m in (("v1", s1["model"]),
                              ("v2", bridge["v2_model"]))}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(rest_rank, SHARDED_RANKS, (bench, c, s1["data"], states),
                  device_type="cuda", timeout_s=900)
    spawn_s = time.perf_counter() - t0
    # (a)
    out = dict(scan={}, bridge={})
    for name, _ in SCAN28_CASES:
        per_rank = [r["scan"][name] for r in ranks]
        for r, got in zip(ranks, per_rank):
            for key in ("loss", "loss_t2"):
                _same_losses(f"{name} rank {r['rank']} {key}",
                             got[f"losses{key[4:]}"],
                             [h[key] for h in loop["history"]])
            if got["best_epoch"] != loop["best"]["epoch"] or (
                    got["scan"]["capture"], got["scan"]["captures"]) != (
                    "none (gloo)", 0):
                raise RuntimeError(f"{name} rank {r['rank']}: best "
                                   f"{got['best_epoch']}, scan {got['scan']}")
        if any(g["losses"] != per_rank[0]["losses"] for g in per_rank):
            raise RuntimeError(f"{name}: the ranks' losses differ")
        row = dict(phase=name, ranks=SHARDED_RANKS, epochs=SCAN28_EPOCHS,
                   chunk=SCAN28_CHUNK, rule=ranks[0]["rule"],
                   single_device_loop_losses=[h["loss"]
                                              for h in loop["history"]],
                   **{f"rank{r['rank']}": g
                      for r, g in zip(ranks, per_rank)})
        log(json.dumps(dict(card=card, **row)))
        out["scan"][name] = row
    # (c)
    for r in ranks:
        got = r["stage1"]
        _same_losses(f"sharded stage 1 rank {r['rank']}", got["losses"],
                     [h["loss"] for h in s1_single["history"]])
        _same_losses(f"sharded stage 1 rank {r['rank']} loss_d",
                     got["losses_d"],
                     [h["loss_d"] for h in s1_single["history"]])
    if ranks[0]["stage1"]["losses"] != ranks[1]["stage1"]["losses"]:
        raise RuntimeError("sharded stage 1: the ranks' losses differ")
    out["stage1"] = dict(
        phase="stage1_sharded", ranks=SHARDED_RANKS, **STAGE1_SHARDED,
        single_device_losses=[h["loss"] for h in s1_single["history"]],
        single_device_epoch_ms_median=1e3 * s1_single["throughput"]["p50_s"],
        single_device_best=s1_single["best"],
        **{f"rank{r['rank']}": r["stage1"] for r in ranks})
    log(json.dumps(dict(card=card, **out["stage1"])))
    # (d): the single device's builds, the sharded ones against them
    for name, model_name, backbone, sim_mode, rerank in BRIDGE28:
        model = s1["model"] if model_name == "v1" else bridge["v2_model"]
        G = ts1.prepare_stage1_graphs(src, tar, backbone, "cuda")
        timings = {}
        t0 = time.perf_counter()
        m1, p1, c1 = recorded_bridge(model, G, s1["data"], "cuda", timings,
                                     sim_mode, rerank)
        single_s = time.perf_counter() - t0
        got = ranks[0]["bridge"][name]
        if ranks[1]["bridge"][name]["digest"] != got["digest"]:
            raise RuntimeError(f"{name}: the ranks' graphs differ")
        sharded = (dict(edge_index=got["edge_index"]), got["props"],
                   got["probs"])
        row = dict(phase=name, ranks=SHARDED_RANKS, rerank=rerank,
                   s=[r["bridge"][name]["s"] for r in ranks],
                   timings_s=[r["bridge"][name]["timings_s"] for r in ranks],
                   single_device_s=single_s,
                   single_device_timings_s=timings,
                   edges=int(got["edge_index"].shape[1]),
                   single_device_edges=int(m1["edge_index"].shape[1]))
        if rerank is None:
            row["near_ties"] = bridge_near_ties((m1, p1, c1), sharded)
        else:
            row["rows_apart"] = rerank_superset(p1, got["props"])
        log(json.dumps(dict(card=card, **row)))
        out["bridge"][name] = row
        del G
        torch.cuda.empty_cache()
    # (b) and the end of (c)
    out["nccl"] = nccl28_phase(bench, c, s1["data"], card)
    # (e)
    out["elastic"] = elastic_phase(card)
    out["s"] = time.perf_counter() - t_phase
    log(f"phase 28 (the rest of multi-device): {out['s']:.1f} s, the "
        f"ranks' spawn {spawn_s:.1f} s [{card}]")
    return out


def rest_rows(kernels, rest) -> None:
    """Phase 28's launches join the f32 rows' counts: the sharded scan
    runs' (both ranks of each case and the NCCL rank's eager epochs and
    capture, halo and overlap), ``launches_sharded_scan_by_d``; the
    row-sharded stage-1 runs' (both ranks and the NCCL rank),
    ``launches_stage1_sharded_by_d`` on gather_reduce. The NCCL overlap
    step's replayed calls join gather_reduce's row."""
    scan_runs = [r[f"rank{i}"]["launches_by_d"]
                 for r in rest["scan"].values()
                 for i in range(SHARDED_RANKS)] + [
        rest["nccl"]["launches"], rest["nccl"]["overlap"]["launches"]]
    stage1_runs = [rest["stage1"][f"rank{i}"]["launches"]
                   for i in range(SHARDED_RANKS)] + [
        rest["nccl"]["stage1"]["launches"]]
    for row in kernels:
        if row.get("dtype") == "bfloat16":
            continue
        for key, runs in (("launches_sharded_scan_by_d", scan_runs),
                          ("launches_stage1_sharded_by_d", stage1_runs)):
            by_d = {}
            for run in runs:
                for d, n in run.get(row["name"], {}).items():
                    by_d[d] = by_d.get(d, 0) + n
            if by_d:
                row[key] = by_d
                row["launches"] += sum(by_d.values())
        replay = rest["nccl"]["overlap"]["replay"].get(row["name"])
        if replay:
            row["sharded_nccl_overlap_replay"] = replay


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
    pred = KTGNNPredictor(copy.deepcopy(model), None, bench,
                          adjacency_method=KERNEL_METHOD, device="cuda")
    pred_t = KTGNNPredictor(copy.deepcopy(model), None, hub,
                            adjacency_method=KERNEL_METHOD, device="cuda")
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
            of(record_run(pred.predict, ("attention_sel_fwd",) + PROLOGUE),
               "attention_sel_fwd"),
            [pred.adj.fast_fn.lay_dst])
        cat = check_kernel(
            "attention_fwd", fk.attention_fwd, fk.attention_fwd_plain,
            of(record_run(pred_t.predict, ("attention_fwd",) + PROLOGUE),
               "attention_fwd"),
            [t.lay_dst for t in pred_t.adj.tiered_fn.tiers])
    for name, recs in (("attention_sel_fwd", sel), ("attention_fwd", cat)):
        for r in recs:
            log(json.dumps(dict(kernel=name, card=card, **r)))
    # 3b. the conv prologue's kernels at the benchmark's shapes
    prologue = prologue_phase(card)

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
    cfg = Stage2Config(to_undirected=True, adjacency_method=KERNEL_METHOD)
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
                                            to_undirected=True,
                                            adjacency_method=KERNEL_METHOD),
        tiered=False, n_layouts=1, num_classes=c)
    log(json.dumps(dict(card=card, **train_single)))

    # 9. training, degree tiers
    if n_tiers < 2:
        raise RuntimeError(f"hub graph gave {n_tiers} tier(s)")
    train_tiered = train_phase(
        "train_tiered", hub, Stage2Config(num_epoch=TIERED_EPOCHS,
                                          to_undirected=True,
                                          adjacency_method=KERNEL_METHOD),
        tiered=True, n_layouts=n_tiers, num_classes=c)
    log(json.dumps(dict(card=card, **train_tiered)))
    torch.cuda.empty_cache()

    # 10. one traced run per graph
    for name, data in (("trace_single", bench), ("trace_tiered", hub)):
        log(json.dumps(dict(card=card, **trace_phase(
            name, data, Stage2Config(num_epoch=TRACE_EPOCHS,
                                     to_undirected=True,
                                     adjacency_method=KERNEL_METHOD)))))
        torch.cuda.empty_cache()

    # 11. card vs CPU, dropout 0, same seeded init
    small = (bench if PARITY_NODES == BENCH["n"]
             else make_benchmark_graph(**dict(BENCH, n=PARITY_NODES)))
    pcfg = Stage2Config(num_epoch=PARITY_EPOCHS, dropout=0.0,
                        to_undirected=True, adjacency_method=KERNEL_METHOD)
    # one train step at a time from the card's state (parity_steps)
    for name, data in (("parity_single", small),
                       ("parity_tiered", hub_graph(small, BENCH["seed"]))):
        log(json.dumps(dict(card=card, **parity_steps(name, data, pcfg))))
        torch.cuda.empty_cache()

    # 12. heavy rows below the skew rule: one layout, 1,024 heavy rows
    t0 = time.perf_counter()
    lead = lead_graph(bench, BENCH["seed"])
    pred_l = KTGNNPredictor(copy.deepcopy(model), None, lead,
                            adjacency_method=KERNEL_METHOD, device="cuda")
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
            of(record_run(pred_l.predict, ("attention_sel_fwd",) + PROLOGUE),
               "attention_sel_fwd"), [lay_l])
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

    # 17. serving zoo checkpoints through the serving CLI
    t0 = time.perf_counter()
    served = serve_zoo(bench, card)
    log(f"phase 17 (serving zoo checkpoints): {time.perf_counter() - t0:.1f}"
        " s")
    # 18. ConvNet: weighted SpMMs through the padded SpMM kernel
    t0 = time.perf_counter()
    convnet = convnet_phase(bench, c, card)
    log(f"phase 18 (ConvNet): {time.perf_counter() - t0:.1f} s")
    # 19. KT-GNN with the feature complementor
    t0 = time.perf_counter()
    complement = complementor_phase(bench, c, card)
    log(f"phase 19 (the complementor): {time.perf_counter() - t0:.1f} s")
    # 20. the dense and gather adjacencies against blocked: "auto"'s rule
    t0 = time.perf_counter()
    paths_phase(card)
    log(f"phase 20 (dense and gather paths): {time.perf_counter() - t0:.1f}"
        " s")
    # 21. stage 1: the adversarial similarity learner, v1, through the
    # padded SpMM kernel
    s1 = stage1_phase(card)
    # 22. the bridge build from its model; the v2 model's mlp-head bridge
    bridge = bridge_phase(s1, card)
    # 23. run.sh recipe 0 through the port's two CLIs
    recipe0_phase(card)
    # 24. phase 21's run in scan mode: host and device sampling, the
    # device evaluator, resume
    s1_scan = stage1_scan_phase(s1, card)
    # 25. the one-call pipeline on the production recipe's settings
    pipe = pipeline_phase(card)
    # 26. similarity serving from phase 22's v2 model
    serve_similarity_phase(s1, bridge, card)
    # 27. multi-device stage 2: the native library, two gloo ranks on the
    # card for each sharded layout, a 1-rank NCCL group
    sharded = sharded_phase(bench, c, card)
    # 28. the rest of multi-device: sharded scan mode, row-sharded stage 1
    # and the sharded bridge on two gloo ranks, a 1-rank NCCL group's
    # captured epochs, the pipeline's elastic retry
    rest = rest_phase(bench, c, s1, bridge, card)

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
    # the SpMM kernel on this slice's paths: a served GraphSAGE predict
    # (phase 17) and a ConvNet epoch (phase 18)
    kernels[-1].update(
        launches_per_predict_zoo_by_d=served[0]["launches_per_predict"][
            "gather_reduce"],
        predict_ms_zoo=served[0]["predict_ms_median"],
        launches_per_epoch_convnet_by_d=convnet["train"][
            "launches_per_epoch_by_d"]["gather_reduce"],
        ms_convnet=convnet["train"]["kernel_ms_per_epoch"]["gather_reduce"],
        convnet_replay=[{k: r[k] for k in (
            "d", "transpose", "weighted", "device_ms", "plain_ms", "bound_ms",
            "library_ms", "max_abs_err")} for r in convnet["replay"]])
    # and on stage 1's (phase 21): the v1 training run's launches join the
    # row's count; its in-run ms per epoch and one step's replayed calls
    stage1_launches = s1["train"]["launches"]["gather_reduce"]
    kernels[-1]["launches_zoo"] = kernels[-1]["launches"]
    kernels[-1]["launches"] += sum(stage1_launches.values())
    kernels[-1].update(
        launches_stage1_by_d=stage1_launches,
        ms_stage1=s1["train"]["kernel_ms_per_epoch"],
        ms_stage1_per_eval=s1["train"]["kernel_ms_per_eval"],
        stage1_replay=[{k: r[k] for k in (
            "d", "transpose", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms",
            "index_add_device_ms", "max_abs_err", "panels", "gather_tb_s")}
            for r in s1["replay"]],
        **{f"{name}_stage1": sum(r[k] for r in s1["replay"])
           for name, k in (("ms_replayed_device", "device_ms"),
                           ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                           ("library_ms", "library_ms"))})
    # stage-1 scan mode (phase 24): the host- and device-sampled runs'
    # launches (eager epochs, capture, evaluations) join the count; a
    # replay's launches and the kernel's time per replayed epoch in the
    # traced segment
    scan_launches = {}
    for run in (s1_scan["host"], s1_scan["device"]):
        for d, n in run["launches"]["gather_reduce"].items():
            scan_launches[d] = scan_launches.get(d, 0) + n
    kernels[-1]["launches"] += sum(scan_launches.values())
    kernels[-1].update(
        launches_stage1_scan_by_d=scan_launches,
        launches_per_replay_stage1_scan=s1_scan["device"][
            "launches_per_replay"]["gather_reduce"],
        ms_stage1_scan_per_replayed_epoch=s1_scan["trace"][
            "hand_kernels_ms"],
        launches_stage1_device_eval=s1_scan["eval"]["launches_per_call"][
            "gather_reduce"])
    kernels += prologue_rows(prologue, train_single, card)
    # the pipeline's stage 2 (phase 25) runs the bf16 instantiations
    for name, by_d in pipe["launches"].items():
        n = sum(c for k, c in by_d.items() if str(k).endswith(":bf16"))
        for row in kernels:
            if n and row["name"] == f"{name}_bf16":
                row["launches_pipeline"] = n
                row["launches"] += n
    sharded_rows(kernels, sharded)
    rest_rows(kernels, rest)
    log(json.dumps({"kernels": kernels}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
